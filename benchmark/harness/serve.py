"""Closed-loop serving: one client sends a batch, waits until its logits
and selected elements are on the host, and sends the next. A discrete
canonicalizer's energies stay on the device, unread until the window has
closed.

Traffic parameters (`benchmark/traffic/<mix>.json`): `batch_size`, `pool`
(distinct seeded batches made on the device at set-up and cycled through),
`warmup_batches`, `sample_batches` (served batches compared with the
reference once the window has closed, drawn from the seed among all that
finished), `capture_batches` / `capture_within` (batches, drawn from the
seed among the first `capture_within`, whose canonical images are kept on
the device for the comparison) and `trace_iterations` (the batches of the
window's head that a `--trace 1` run profiles: few enough that the
profiler keeps every device record).

End-to-end: `serve_img_per_s`, the images whose results reached the host
in the window over the window's seconds; `serve_p95_ms`, the 95th
percentile of the time from a batch being sent to its results on the host.
"""

from __future__ import annotations

import gc
import random
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import check, data, program, trace, work
from benchmark.reference.common import FP32, Precision, fp32_only


def run(cell, seed: int, seconds: float, traced: bool, device, t0: float,
        control: bool = False) -> dict:
    settings, tr = cell.settings, cell.traffic
    B, n_pool = tr["batch_size"], tr["pool"]
    size, classes = settings["dataset"]["image_size"], settings["dataset"]["num_classes"]
    ref = cell.reference()
    fp32_only()
    torch.backends.cudnn.benchmark = True

    pipe = program.build_pipeline(settings, "serve", device)
    data.load_weights(pipe, data.make_weights(ref.param_spec(settings), seed, device))
    images = [data.pool_batch(seed, i, B, size, classes, device)[0] for i in range(n_pool)]
    rng = random.Random(data.sub_seed(seed, "sample"))
    capture_at = set(rng.sample(range(tr["capture_within"]), tr["capture_batches"]))

    state = {"it": -1}
    captured: Dict[int, torch.Tensor] = {}

    def keep_canonical(_module, args):
        if state["it"] in capture_at:
            captured[state["it"]] = args[0]

    logits_host: List[torch.Tensor] = []
    elements: List[torch.Tensor] = []
    acts: List[torch.Tensor] = []
    latencies: List[float] = []

    def serve_until(deadline: float, record: bool, most: int = -1) -> int:
        done = 0
        with torch.no_grad():
            while True:
                if record:
                    state["it"] += 1
                x = images[max(state["it"], 0) % n_pool]
                t_send = time.perf_counter()
                logits, info = pipe(x, training=False)
                host_logits, host_el = logits.cpu(), program.element(info).cpu()
                t_done = time.perf_counter()
                done += 1
                if record:
                    logits_host.append(host_logits)
                    elements.append(host_el)
                    acts.append(program.energies(info))
                    latencies.append(t_done - t_send)
                if t_done >= deadline or done == most:
                    return done

    for _ in range(tr["warmup_batches"]):
        serve_until(0.0, record=False)
    program.sync(device)
    setup_s = time.perf_counter() - t0

    hook = pipe.prediction_network.register_forward_pre_hook(keep_canonical)
    spans = program.Spans(device)
    record = {"mode": "serve", "batch": B}
    if traced:
        program.watch_pipeline(spans, pipe, training=False)
    t_start = time.perf_counter()
    if traced:
        with trace.profiled(device) as prof:
            prof["iterations"] = serve_until(t_start + seconds, True, tr["trace_iterations"])
        record["trace"] = prof
    serve_until(t_start + seconds, True)
    window_s = time.perf_counter() - t_start
    hook.remove()
    record["spans_ms"] = spans.durations_ms()
    spans.remove()
    n = len(latencies)
    e2e = {"serve_img_per_s": n * B / window_s,
           "serve_p95_ms": float(np.percentile(np.asarray(latencies) * 1e3, 95)),
           "setup_s": setup_s}
    failed = sum(int(not bool(torch.isfinite(l.float()).all())) for l in logits_host)
    peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
    if traced:
        record["work"] = {"flops_per_iter": work.serve_flops(ref, settings, B),
                          "canon_bytes": work.canon_bytes(settings, B)}
        record["peaks"] = {"bf16_flops": work.BF16_PEAK_FLOPS, "hbm_bytes": work.HBM_PEAK_BYTES}

    del pipe
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    sample = set(rng.sample(range(n), min(tr["sample_batches"], n)))
    numbers = compare(ref, settings, seed, device, images, sample, captured,
                      logits_host, elements, acts)
    out = {"setup_s": setup_s, "e2e": e2e, "attempted": n * B, "failed": failed * B,
           "numbers": numbers, "record": record, "memory_peak_bytes": peak,
           "window_s": window_s, "iterations": n}
    if control:
        out["control"], out["fault"] = compare_control(ref, settings, seed, device, images,
                                                       sample, cell.control)
    return out


def compare(ref, settings, seed, device, images, sample, captured, logits_host,
            elements, acts) -> Dict[str, float]:
    """The program's numbers on the sampled and captured batches."""
    w = data.make_weights(ref.param_spec(settings), seed, device)
    nums = {"canon_err": 0.0, "logit_err": 0.0}
    with torch.no_grad():
        for i in sorted(set(sample) | set(captured)):
            out = ref.serve(w, images[i % len(images)], settings, follow=elements[i])
            if i in sample:
                for k, v in ref.element_gaps(out, elements[i], acts[i]).items():
                    nums[k] = max(nums.get(k, 0.0), v)
                nums["logit_err"] = max(nums["logit_err"],
                                        check.rel_max(logits_host[i], out["logits"].cpu()))
            if i in captured:
                nums["canon_err"] = max(nums["canon_err"],
                                        check.rel_max(captured.pop(i), out["canonical"]))
            del out
    return nums


def compare_control(ref, settings, seed, device, images, sample, precision: str):
    """The control's numbers, the reference one precision below the
    program's bf16 (`precision`) in the program's place, on the same
    batches; and, where the reference selects among energies, those of a
    planted fault: the fp32 reference with its energies rolled by one
    element (a shifted fiber) in the program's place."""
    w = data.make_weights(ref.param_spec(settings), seed, device)
    low = Precision(precision)
    nums = {"canon_err": 0.0, "logit_err": 0.0}
    fault: Dict[str, float] = {}
    with torch.no_grad():
        for i in sorted(sample):
            x = images[i % len(images)]
            c = ref.serve(w, x, settings, prec=low)
            out = ref.serve(w, x, settings, follow=c["element"], prec=FP32)
            for k, v in ref.element_gaps(out, c["element"], c.get("energies")).items():
                nums[k] = max(nums.get(k, 0.0), v)
            nums["logit_err"] = max(nums["logit_err"], check.rel_max(c["logits"], out["logits"]))
            nums["canon_err"] = max(nums["canon_err"],
                                    check.rel_max(c["canonical"], out["canonical"]))
            if "energies" in out:
                rolled = torch.roll(out["energies"], 1, dims=-1)
                el = rolled.argmax(-1).float() * (360.0 / rolled.shape[-1])
                for k, v in ref.element_gaps(out, el, rolled).items():
                    fault[k] = max(fault.get(k, 0.0), v)
            del c, out
    return nums, fault
