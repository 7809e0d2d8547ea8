"""Closed-loop instance segmentation with a detector: one client sends a
batch of images, waits until every instance's input-frame box, score,
label, validity and uint8 mask is on the host, and sends the next. The
selected elements and the canonicalizer's energies stay on the device,
unread until the window has closed.

The program is built as its segmentation serving CLI builds it
(`cli.segmentation_serve.build_serving_pipeline`: fast warps, bf16) from
the configuration's settings, Mask R-CNN's from its `maskrcnn` entry, and
served through `ImageSegmentationPipeline.detect`. The results are read
into host buffers made at set-up (pinned on a card: a client that takes
839 MB of masks a batch stages them so).

Traffic parameters (`benchmark/traffic/<mix>.json`): `batch_size`, `pool`
(distinct seeded batches made on the device at set-up and cycled through),
`warmup_batches`, `sample_batches` (served batches whose energies are
compared with the reference once the window has closed, drawn from the
seed among all that finished), `capture_batches` / `capture_within`
(batches, drawn from the seed among the first `capture_within`, whose
intermediates and input-frame mask probabilities are kept on the device
for the comparison: 3.4 GB of probabilities a batch, so only these),
`control_batches` (the sampled batches the control and the planted faults
are computed on, in calibration) and `trace_iterations` (the batches of
the window's head that a `--trace 1` run profiles).

`memory_peak_bytes` is the peak of the last warm-up batch, which keeps
nothing for the comparison: what a deployment holds while it serves. The
window's peak, with the captured batches held, goes to stderr.

End-to-end: `serve_img_per_s`, the images whose results reached the host
in the window over the window's seconds; `serve_p95_ms`, the 95th
percentile of the time from a batch being sent to its results on the host.
`failed` counts the images whose boxes or scores are not finite.

The numbers of `correct` (each the worst over the batches compared):
`energy_err` and `canon_err` as the segment cell's; on each image of the
captured batches, the reference teacher-forced on what the program
produced: `feat_err` (P2-P6 against the reference's on the program's
canonical image), `rpn_err` (objectness and deltas), `nms_mismatch` (the
boxes whose keep flag differs from the reference's greedy NMS run on the
program's own fp32 candidates, at the RPN and the final stage, and the
proposals and detections that differ from the first kept ones),
`cls_err` and `box_err` (the reference's box branch on the program's
proposals; the program's input-frame boxes against its canonical ones
turned back), `mask_err` (the reference's mask branch on the program's
detections, pasted and turned back by the program's element, against the
program's input-frame probabilities; inf where the uint8 masks the client
received are not those probabilities above 0.5).
"""

from __future__ import annotations

import gc
import math
import random
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import check, data, detect_work, program, trace, work
from benchmark.reference.common import FP32, Precision, fp32_only

FAULTS = ("roi_align_sr1", "level_off_by_one", "class_agnostic_nms")
NUMBERS = ("energy_err", "canon_err", "feat_err", "rpn_err", "nms_mismatch", "cls_err",
           "box_err", "mask_err")
OUTPUTS = ("boxes", "scores", "labels", "valid", "masks")


def build_pipeline(settings: dict, device):
    """The program's serving pipeline of `settings`."""
    from equiadapt_tpu_torch.cli.segmentation_serve import build_serving_pipeline
    from equiadapt_tpu_torch.utils.config import Config

    return build_serving_pipeline(Config.from_dict(settings), device, **settings["maskrcnn"])


def inputs(seed: int, settings: dict, tr: dict, device) -> List[torch.Tensor]:
    """The pool: (B, S, S, 3) image batches."""
    B, size = tr["batch_size"], settings["dataset"]["image_size"]
    return [data.smooth_images(data.generator(seed, f"pool{i}", device), B, size)
            for i in range(tr["pool"])]


def staging_buffers(B: int, D: int, size: int, pinned: bool) -> Dict[str, torch.Tensor]:
    """The client's host buffers for a batch's results."""
    return {"boxes": torch.empty((B, D, 4), dtype=torch.float32, pin_memory=pinned),
            "scores": torch.empty((B, D), dtype=torch.float32, pin_memory=pinned),
            "labels": torch.empty((B, D), dtype=torch.int64, pin_memory=pinned),
            "valid": torch.empty((B, D), dtype=torch.bool, pin_memory=pinned),
            "masks": torch.empty((B, D, size, size), dtype=torch.uint8, pin_memory=pinned)}


def run(cell, seed: int, seconds: float, traced: bool, device, t0: float,
        control: bool = False) -> dict:
    settings, tr = cell.settings, cell.traffic
    B = tr["batch_size"]
    ref = cell.reference()
    fp32_only()
    torch.backends.cudnn.benchmark = True

    pipe = build_pipeline(settings, device)
    data.load_weights(pipe, data.make_weights(ref.param_spec(settings), seed, device))
    net = pipe.prediction_network
    pool = inputs(seed, settings, tr, device)
    rng = random.Random(data.sub_seed(seed, "sample"))
    capture_at = set(rng.sample(range(tr["capture_within"]), tr["capture_batches"]))

    state = {"it": -1}
    captured: Dict[int, dict] = {}

    def keep_canonical(_module, args):
        if state["it"] in capture_at:
            captured[state["it"]] = {"canonical": args[0]}

    cuda = torch.device(device).type == "cuda"
    size = settings["dataset"]["image_size"]
    staging = staging_buffers(B, settings["maskrcnn"]["box_detections_per_img"], size, cuda)
    elements: List[torch.Tensor] = []
    acts: List[torch.Tensor] = []
    latencies: List[float] = []
    failed = [0]
    regions: List[dict] = []

    def serve_until(deadline: float, record: bool, most: int = -1, track: bool = False) -> int:
        done = 0
        with torch.no_grad():
            while True:
                if record:
                    state["it"] += 1
                x = pool[max(state["it"], 0) % len(pool)]
                cap = record and state["it"] in capture_at
                if cap or track:
                    net.keep = {}
                t_send = time.perf_counter()
                out, info = pipe.detect(x, return_probs=cap)
                for k in OUTPUTS:
                    staging[k].copy_(out[k])
                t_done = time.perf_counter()
                done += 1
                if record:
                    elements.append(program.element(info))
                    acts.append(program.energies(info))
                    latencies.append(t_done - t_send)
                    bad = (~torch.isfinite(staging["boxes"])).any(-1).any(-1) | (
                        ~torch.isfinite(staging["scores"])).any(-1)
                    failed[0] += int(bad.sum())
                if cap:
                    captured[state["it"]].update(keep=net.keep, out=out,
                                                 host=staging["masks"].clone())
                if track:
                    regions.append({"proposals": net.keep["proposals"],
                                    "detections": net.keep["boxes_resized"],
                                    "maps": [tuple(f.shape[-2:]) for f in net.keep["features"]],
                                    "image": tuple(net.keep["transformed"].shape[-2:])})
                if cap or track:
                    net.keep = None
                if t_done >= deadline or done == most:
                    return done

    for i in range(tr["warmup_batches"]):
        if cuda and i == tr["warmup_batches"] - 1:
            # the peak a deployment reaches: a warm batch, nothing kept for the comparison
            program.sync(device)
            torch.cuda.reset_peak_memory_stats(device)
        serve_until(0.0, record=False)
    program.sync(device)
    setup_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    hook = net.register_forward_pre_hook(keep_canonical)
    record = {"mode": "detect", "batch": B, "spans_ms": {}}
    t_start = time.perf_counter()
    if traced:
        from equiadapt_tpu_torch.utils import profiling

        before = profiling.counters()
        with trace.profiled(device) as prof:
            prof["iterations"] = serve_until(t_start + seconds, True, tr["trace_iterations"],
                                             track=True)
        record["trace"] = prof
        after = profiling.counters()
        record["counters"] = {k: v - before.get(k, 0) for k, v in after.items()
                              if v != before.get(k, 0)}
    serve_until(t_start + seconds, True)
    window_s = time.perf_counter() - t_start
    hook.remove()
    n = len(latencies)
    e2e = {"serve_img_per_s": n * B / window_s,
           "serve_p95_ms": float(np.percentile(np.asarray(latencies) * 1e3, 95)),
           "setup_s": setup_s}
    if cuda:
        print(f"memory peak: served {peak} B; with the captured batches held "
              f"{torch.cuda.max_memory_allocated(device)} B", file=sys.stderr)
    if traced:
        record["work"] = count_work(ref, settings, B, regions)
        record["peaks"] = {"bf16_flops": work.BF16_PEAK_FLOPS, "hbm_bytes": work.HBM_PEAK_BYTES,
                           "fp32_flops": detect_work.FP32_PEAK_FLOPS}
        per_image = {k: v / (B * max(prof["iterations"], 1))
                     for k, v in record["counters"].items() if k.startswith("maskrcnn/")}
        print(f"detect counters per image: {per_image}", file=sys.stderr)
    regions.clear()

    del pipe, net
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    sample = set(rng.sample(range(n), min(tr["sample_batches"], n)))
    numbers = compare(ref, settings, seed, device, pool, sample, captured, elements, acts)
    out = {"setup_s": setup_s, "e2e": e2e, "attempted": n * B, "failed": failed[0],
           "numbers": numbers, "record": record, "memory_peak_bytes": peak,
           "window_s": window_s, "iterations": n}
    if control:
        chosen = sorted(sample)[:tr["control_batches"]]
        out["control"], out["fault"] = compare_control(ref, settings, seed, device, pool,
                                                       chosen, cell.control)
    return out


def count_work(ref, settings: dict, B: int, regions: List[dict]) -> dict:
    """FLOPs of a batch and RoIAlign's byte floor a launch (the mean of the
    traced batches' box and mask launches)."""
    out = detect_work.count_flops(ref, settings, B)
    dtype = settings["prediction"]["dtype"]
    total = 0
    for r in regions:
        maps = r["maps"][:4]
        total += detect_work.roi_align_bytes(r["proposals"], maps, r["image"], 7, 2, 256, dtype)
        total += detect_work.roi_align_bytes(r["detections"], maps, r["image"], 14, 2, 256,
                                             dtype)
    if regions:
        out["roi_align_bytes"] = total / (2 * len(regions))
    out["nms_pair_flops"] = detect_work.NMS_PAIR_FLOPS
    return out


def _worst(nums: Dict[str, float], key: str, value: float) -> None:
    nums[key] = max(nums.get(key, 0.0), value)


def program_images(got: dict, B: int) -> List[dict]:
    """A captured batch's intermediates and outputs, one record an image, in
    the reference's layouts."""
    k, o = got["keep"], got["out"]
    L, K = k["rpn_boxes"].shape[1:3]
    N, C1 = k["det_scores"].shape[1:3]
    recs = []
    for b in range(B):
        recs.append({
            "canonical": got["canonical"][b:b + 1],
            "features": [f[b:b + 1] for f in k["features"]],
            "rpn_objectness": [t[b:b + 1] for t in k["rpn_objectness"]],
            "rpn_deltas": [t[b:b + 1] for t in k["rpn_deltas"]],
            "rpn_boxes": k["rpn_boxes"][b], "rpn_scores": k["rpn_scores"][b],
            "rpn_valid": k["rpn_valid"][b], "rpn_keep": k["rpn_keep"][b].reshape(L, K),
            "proposals": k["proposals"][b], "proposals_valid": k["proposals_valid"][b],
            "class_logits": k["class_logits"].reshape(B, N, -1)[b],
            "box_regression": k["box_regression"].reshape(B, N, -1)[b],
            "det_boxes": k["det_boxes"][b], "det_scores": k["det_scores"][b],
            "det_valid": k["det_valid"][b], "det_keep": k["det_keep"][b].reshape(N, C1),
            "boxes_resized": k["boxes_resized"][b], "boxes": k["boxes"][b],
            "labels": o["labels"][b], "valid": o["valid"][b],
            "boxes_input": o["boxes"][b], "probs_input": o["probs"][b]})
    return recs


def image_numbers(ref, w, settings: dict, rec: dict, turns: int) -> Dict[str, float]:
    """The teacher-forced numbers of one image's record (module docstring)."""
    m = settings["maskrcnn"]
    S = tuple(rec["canonical"].shape[1:3])
    hw = ref.resized(*S, settings)
    t = ref.teacher(w, rec["canonical"], settings)
    nums = {"feat_err": max(check.rel_max(p, r) for p, r in zip(rec["features"], t["features"])),
            "rpn_err": max(max(check.rel_max(p, r) for p, r in
                               zip(rec["rpn_objectness"], t["rpn_objectness"])),
                           max(check.rel_max(p, r) for p, r in
                               zip(rec["rpn_deltas"], t["rpn_deltas"])))}
    miss = 0
    for lv in range(rec["rpn_boxes"].shape[0]):
        keep = ref.segment_keep(rec["rpn_boxes"][lv].float(), rec["rpn_scores"][lv].float(),
                                rec["rpn_valid"][lv], ref.RPN_NMS_THRESH)
        miss += int((keep != rec["rpn_keep"][lv]).sum())
    order, kept = ref.first_kept(rec["rpn_keep"].reshape(-1), rec["rpn_scores"].reshape(-1),
                                 m["rpn_post_nms_top_n"])
    props = torch.where(kept[:, None], rec["rpn_boxes"].reshape(-1, 4)[order], 0.0)
    miss += int((~(props == rec["proposals"]).all(-1) | (kept != rec["proposals_valid"])).sum())
    for c in range(rec["det_scores"].shape[1]):
        keep = ref.segment_keep(rec["det_boxes"][:, c].float(), rec["det_scores"][:, c].float(),
                                rec["det_valid"][:, c], ref.BOX_NMS_THRESH)
        miss += int((keep != rec["det_keep"][:, c]).sum())
    C1 = rec["det_scores"].shape[1]
    order, kept = ref.first_kept(rec["det_keep"].reshape(-1), rec["det_scores"].reshape(-1),
                                 m["box_detections_per_img"])
    dets = torch.where(kept[:, None], rec["det_boxes"].reshape(-1, 4)[order], 0.0)
    miss += int((~(dets == rec["boxes_resized"]).all(-1) | (kept != rec["valid"])
                 | ((order % C1 + 1 != rec["labels"]) & kept)).sum())
    nums["nms_mismatch"] = float(miss)
    rows = rec["proposals_valid"]
    logits, deltas = ref.box_branch(w, t["features"], rec["proposals"], hw)
    nums["cls_err"] = check.rel_max(rec["class_logits"][rows], logits[rows])
    nums["box_err"] = max(check.rel_max(rec["box_regression"][rows], deltas[rows]),
                          check.rel_max(rec["boxes"], ref.scale_boxes(rec["boxes_resized"], S, hw)),
                          check.rel_max(rec["boxes_input"], ref.turn_back(rec["boxes"], turns,
                                                                          S[0])))
    probs = ref.mask_probs(w, t["features"], rec["boxes_resized"], rec["labels"], rec["valid"],
                           hw)
    pasted = torch.rot90(ref.paste(probs, rec["boxes"].float(), S), turns, dims=(1, 2))
    nums["mask_err"] = check.rel_max(rec["probs_input"], pasted)
    return nums


def compare(ref, settings, seed, device, pool, sample, captured, elements, acts
            ) -> Dict[str, float]:
    """The program's numbers: the energies of the sampled batches, every
    other number on the captured batches (module docstring)."""
    w = data.make_weights(ref.param_spec(settings), seed, device)
    nums = {k: 0.0 for k in NUMBERS}
    with torch.no_grad():
        for i in sorted(set(sample) | set(captured)):
            x = pool[i % len(pool)]
            c = ref.canonicalize(w, x, settings, follow=elements[i])
            if i in sample:
                for k, v in ref.element_gaps(c, elements[i], acts[i]).items():
                    _worst(nums, k, v)
            if i in captured:
                got = captured.pop(i)
                _worst(nums, "canon_err", check.rel_max(got["canonical"], c["canonical"]))
                for b, rec in enumerate(program_images(got, x.shape[0])):
                    for k, v in image_numbers(ref, w, settings, rec, int(c["turns"][b])).items():
                        _worst(nums, k, v)
                if not torch.equal(got["host"], (got["out"]["probs"] > 0.5).to(torch.uint8)
                                   .cpu()):
                    nums["mask_err"] = math.inf
                del got
            del c
    return nums


def reference_images(out: dict) -> List[dict]:
    """The reference's per-image records of `serve`, with their canonical
    images."""
    return [dict(rec, canonical=out["canonical"][b:b + 1])
            for b, rec in enumerate(out["images"])]


def compare_control(ref, settings, seed, device, pool, chosen, precision: str):
    """The control's numbers, the reference one precision below the
    program's bf16 (`precision`) in the program's place, on the `chosen`
    sampled batches; and those of planted faults in the program's place:
    the fp32 reference with RoIAlign sampled once a bin ("roi_align_sr1"),
    its regions pooled one level up ("level_off_by_one"), its final NMS
    across classes ("class_agnostic_nms"), and its energies rolled by one
    element ("fiber_rolled")."""
    w = data.make_weights(ref.param_spec(settings), seed, device)
    low = Precision(precision)
    nums: Dict[str, float] = {}
    fault: Dict[str, Dict[str, float]] = {f: {} for f in FAULTS + ("fiber_rolled",)}
    with torch.no_grad():
        for i in chosen:
            x = pool[i % len(pool)]
            c = ref.serve(w, x, settings, prec=low)
            f32 = ref.canonicalize(w, x, settings, follow=c["element"], prec=FP32)
            for k, v in ref.element_gaps(f32, c["element"], c["energies"]).items():
                _worst(nums, k, v)
            _worst(nums, "canon_err", check.rel_max(c["canonical"], f32["canonical"]))
            for b, rec in enumerate(reference_images(c)):
                for k, v in image_numbers(ref, w, settings, rec, int(f32["turns"][b])).items():
                    _worst(nums, k, v)
            del c
            for f in FAULTS:
                bad = ref.serve(w, x, settings, follow=f32["element"], faults=(f,))
                for b, rec in enumerate(reference_images(bad)):
                    for k, v in image_numbers(ref, w, settings, rec, int(f32["turns"][b])).items():
                        _worst(fault[f], k, v)
                del bad
            rolled = torch.roll(f32["energies"], 1, dims=-1)
            for k, v in ref.element_gaps(f32, f32["element"], rolled).items():
                _worst(fault["fiber_rolled"], k, v)
    return nums, fault
