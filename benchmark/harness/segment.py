"""Closed-loop promptable segmentation: one client sends a batch of images
with their box prompts, waits until the thresholded masks and the predicted
IoU are on the host, and sends the next. The selected elements and a
discrete canonicalizer's energies stay on the device, unread until the
window has closed.

The program is built as its segmentation serving CLI builds it
(`cli.segmentation_serve.build_serving_pipeline`: fast warps, bf16) from
the configuration's settings, SAM's widths from its `sam` entry, and served
through `ImageSegmentationPipeline.serve`. The masks are read back as
uint8, thresholded as `models.segmentation.segmentation_forward_outputs`
does (logits > 0.5), into a host buffer made at set-up (pinned on a card:
a client that takes 64 MB of masks a batch stages them so).

Traffic parameters (`benchmark/traffic/<mix>.json`): `batch_size`,
`prompts` (box prompts an image), `box_min` / `box_max` (a box's sides,
log-uniform between them, in pixels; its corner uniform where the box fits
the image), `pool` (distinct seeded batches made on the device at set-up
and cycled through), `warmup_batches`, `sample_batches` (served batches
whose IoU and energies are compared with the reference once the window
has closed, drawn from the seed among all that finished),
`capture_batches` / `capture_within` (batches, drawn from the seed among
the first `capture_within`, whose canonical images and input-frame mask
logits are kept on the device for the comparison: a batch's logits are
256 MB, so only these are kept) and `trace_iterations` (the batches of the
window's head that a `--trace 1` run profiles).

End-to-end: `serve_img_per_s`, the images whose masks and IoU reached the
host in the window over the window's seconds; `serve_p95_ms`, the 95th
percentile of the time from a batch being sent to its masks and IoU on the
host. `failed` counts the images whose IoU is not finite.
"""

from __future__ import annotations

import gc
import math
import random
import time
from typing import Dict, List

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import check, data, program, trace, work
from benchmark.reference.common import FP32, Precision, fp32_only

FAULTS = ("no_rel_pos", "windowed_global")


def build_pipeline(settings: dict, device):
    """The program's serving pipeline of `settings`."""
    from equiadapt_tpu_torch.cli.segmentation_serve import build_serving_pipeline
    from equiadapt_tpu_torch.utils.config import Config

    return build_serving_pipeline(Config.from_dict(settings), device, **settings["sam"])


def make_boxes(seed: int, i: int, b: int, n: int, size: int, lo: float, hi: float,
               device) -> torch.Tensor:
    """Batch i's (b, n, 4) xyxy boxes: sides log-uniform in [lo, hi] px,
    the top-left corner uniform where the box fits."""
    gen = data.generator(seed, f"boxes{i}", device)
    u = torch.rand(b, n, 2, generator=gen, device=device)
    side = torch.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    corner = torch.rand(b, n, 2, generator=gen, device=device) * (size - side)
    return torch.cat([corner, corner + side], dim=-1)


def inputs(seed: int, settings: dict, tr: dict, device):
    """The pool: [(images (B, S, S, 3), boxes (B, N, 4))]."""
    B, size = tr["batch_size"], settings["dataset"]["image_size"]
    return [(data.smooth_images(data.generator(seed, f"pool{i}", device), B, size),
             make_boxes(seed, i, B, tr["prompts"], size, tr["box_min"], tr["box_max"], device))
            for i in range(tr["pool"])]


def count_work(ref, settings: dict, B: int, N: int) -> Dict[str, int]:
    """The reference's FLOPs of one batch, on meta tensors with the element
    fixed, and of one global-attention call of the batch (the two score
    products and the two bias einsums)."""
    size = settings["dataset"]["image_size"]
    w = {name: torch.empty(shape, device="meta") for name, shape, _ in ref.param_spec(settings)}
    x = torch.empty(B, size, size, settings["dataset"]["in_channels"], device="meta")
    boxes = torch.empty(B, N, 4, device="meta")
    with FlopCounterMode(display=False) as c:
        ref.serve(w, x, boxes, settings, follow=torch.zeros(B))
    with FlopCounterMode(display=False) as a:
        ref.attend(*ref.global_attention_inputs(settings, B, "meta"))
    return {"flops_per_iter": int(c.get_total_flops()),
            "global_attn_flops": int(a.get_total_flops())}


def run(cell, seed: int, seconds: float, traced: bool, device, t0: float,
        control: bool = False) -> dict:
    settings, tr = cell.settings, cell.traffic
    B, N = tr["batch_size"], tr["prompts"]
    ref = cell.reference()
    fp32_only()
    torch.backends.cudnn.benchmark = True

    pipe = build_pipeline(settings, device)
    data.load_weights(pipe, data.make_weights(ref.param_spec(settings), seed, device))
    pool = inputs(seed, settings, tr, device)
    rng = random.Random(data.sub_seed(seed, "sample"))
    capture_at = set(rng.sample(range(tr["capture_within"]), tr["capture_batches"]))

    state = {"it": -1}
    captured: Dict[int, dict] = {}

    def keep_canonical(_module, args):
        if state["it"] in capture_at:
            captured[state["it"]] = {"canonical": args[0]}

    # the client's host buffer for a batch's masks, pinned on a card: 64 MB
    # a batch at the cell's shape, copied at the link's rate, not the host's
    cuda = torch.device(device).type == "cuda"
    size = settings["dataset"]["image_size"]
    staging = torch.empty((B, N, size, size), dtype=torch.uint8, pin_memory=cuda)
    ious: List[torch.Tensor] = []
    elements: List[torch.Tensor] = []
    acts: List[torch.Tensor] = []
    latencies: List[float] = []

    def serve_until(deadline: float, record: bool, most: int = -1) -> int:
        done = 0
        with torch.no_grad():
            while True:
                if record:
                    state["it"] += 1
                x, boxes = pool[max(state["it"], 0) % len(pool)]
                t_send = time.perf_counter()
                masks, iou, info = pipe.serve(x, boxes)
                staging.copy_((masks > 0.5).to(torch.uint8))
                host_iou = iou.cpu()
                t_done = time.perf_counter()
                done += 1
                if record:
                    ious.append(host_iou)
                    elements.append(program.element(info))
                    acts.append(program.energies(info))
                    latencies.append(t_done - t_send)
                    if state["it"] in captured:
                        captured[state["it"]].update(masks=masks, iou=iou, host=staging.clone())
                if t_done >= deadline or done == most:
                    return done

    for _ in range(tr["warmup_batches"]):
        serve_until(0.0, record=False)
    program.sync(device)
    setup_s = time.perf_counter() - t0

    hook = pipe.prediction_network.register_forward_pre_hook(keep_canonical)
    record = {"mode": "segment", "batch": B, "spans_ms": {}}
    t_start = time.perf_counter()
    if traced:
        with trace.profiled(device) as prof:
            prof["iterations"] = serve_until(t_start + seconds, True, tr["trace_iterations"])
        record["trace"] = prof
    serve_until(t_start + seconds, True)
    window_s = time.perf_counter() - t_start
    hook.remove()
    n = len(latencies)
    e2e = {"serve_img_per_s": n * B / window_s,
           "serve_p95_ms": float(np.percentile(np.asarray(latencies) * 1e3, 95)),
           "setup_s": setup_s}
    failed = sum(int((~torch.isfinite(i.float())).any(dim=-1).sum()) for i in ious)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if traced:
        record["work"] = count_work(ref, settings, B, N)
        record["peaks"] = {"bf16_flops": work.BF16_PEAK_FLOPS, "hbm_bytes": work.HBM_PEAK_BYTES}

    del pipe
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    sample = set(rng.sample(range(n), min(tr["sample_batches"], n)))
    numbers = compare(ref, settings, seed, device, pool, sample, captured, ious, elements,
                      acts)
    out = {"setup_s": setup_s, "e2e": e2e, "attempted": n * B, "failed": failed,
           "numbers": numbers, "record": record, "memory_peak_bytes": peak,
           "window_s": window_s, "iterations": n}
    if control:
        out["control"], out["fault"] = compare_control(ref, settings, seed, device, pool,
                                                       sample, cell.control)
    return out


def _worst(nums: Dict[str, float], key: str, value: float) -> None:
    nums[key] = max(nums.get(key, 0.0), value)


def iou_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """max |program IoU - reference IoU| over the reference's largest
    distance from its mean, over a batch's prompts (inf where the program's
    is not finite). The IoU head's offset common to all prompts moves with
    the seed's weights (means -0.39 to 1.27 on six seeds, PERF.md §2) while
    the spread across prompts stays put, so the spread is the scale."""
    ref = ref.float()
    prog = prog.float().to(ref.device)
    if not bool(torch.isfinite(prog).all()):
        return math.inf
    scale = (ref - ref.mean()).abs().max().clamp(min=1e-30)
    return float((prog - ref).abs().max() / scale)


def compare(ref, settings, seed, device, pool, sample, captured, ious, elements,
            acts) -> Dict[str, float]:
    """The program's numbers on the sampled and captured batches: the
    energies and the IoU of the sampled ones; the canonical image, the
    input-frame mask logits and the IoU of the captured ones (whose
    thresholded masks the client received: inf where they are not the
    logits' threshold)."""
    w = data.make_weights(ref.param_spec(settings), seed, device)
    nums = {"energy_err": 0.0, "canon_err": 0.0, "mask_err": 0.0, "iou_err": 0.0}
    with torch.no_grad():
        for i in sorted(set(sample) | set(captured)):
            x, boxes = pool[i % len(pool)]
            out = ref.serve(w, x, boxes, settings, follow=elements[i])
            if i in sample:
                for k, v in ref.element_gaps(out, elements[i], acts[i]).items():
                    _worst(nums, k, v)
                _worst(nums, "iou_err", iou_gap(ious[i], out["iou"]))
            if i in captured:
                got = captured.pop(i)
                _worst(nums, "canon_err", check.rel_max(got["canonical"], out["canonical"]))
                err = check.rel_max(got["masks"], out["masks"])
                if not torch.equal(got["host"], (got["masks"] > 0.5).to(torch.uint8).cpu()):
                    err = math.inf
                _worst(nums, "mask_err", err)
                _worst(nums, "iou_err", iou_gap(got["iou"], out["iou"]))
            del out
    return nums


def compare_control(ref, settings, seed, device, pool, sample, precision: str):
    """The control's numbers, the reference one precision below the
    program's bf16 (`precision`) in the program's place, on the sampled
    batches; and those of planted faults in the program's place: the fp32
    reference without the relative-position bias ("no_rel_pos"), with its
    global blocks windowed ("windowed_global"), and with its energies
    rolled by one element ("fiber_rolled")."""
    w = data.make_weights(ref.param_spec(settings), seed, device)
    low = Precision(precision)
    nums: Dict[str, float] = {}
    fault: Dict[str, Dict[str, float]] = {f: {} for f in FAULTS + ("fiber_rolled",)}
    with torch.no_grad():
        for i in sorted(sample):
            x, boxes = pool[i % len(pool)]
            c = ref.serve(w, x, boxes, settings, prec=low)
            out = ref.serve(w, x, boxes, settings, follow=c["element"], prec=FP32)
            for k, v in ref.element_gaps(out, c["element"], c["energies"]).items():
                _worst(nums, k, v)
            _worst(nums, "canon_err", check.rel_max(c["canonical"], out["canonical"]))
            _worst(nums, "mask_err", check.rel_max(c["masks"], out["masks"]))
            _worst(nums, "iou_err", iou_gap(c["iou"], out["iou"]))
            for f in FAULTS:
                bad = ref.serve(w, x, boxes, settings, follow=out["element"], faults=(f,))
                _worst(fault[f], "mask_err", check.rel_max(bad["masks"], out["masks"]))
                _worst(fault[f], "iou_err", iou_gap(bad["iou"], out["iou"]))
                del bad
            rolled = torch.roll(out["energies"], 1, dims=-1)
            for k, v in ref.element_gaps(out, out["element"], rolled).items():
                _worst(fault["fiber_rolled"], k, v)
            del c, out
    return nums, fault
