"""Closed-loop group evaluation: one client sends a batch, the program
classifies it in every element of the group's orbit in one call, and the
client waits until the orbit's logits and selected elements are on the
host before sending the next. The canonicalizer's energies stay on the
device, unread until the window has closed.

The program is built as the classification serving CLI builds it
(`program.build_pipeline(settings, "serve")`: fast warps, bf16) and called
through `pipelines.classification.orbit_logits`, the serving half of
equiadapt's `GroupInference` (`group_inference`): the batch's orbit made
by `materialize_orbit` (K4 for the quarter turns of square images), then
the canonicalizer and the network on the |G| B orbit images, group-major.

Traffic parameters (`benchmark/traffic/<mix>.json`): `batch_size` (images a
batch before the orbit), `group_elements` (the orbit's elements: quarter
turns), `pool`, `warmup_batches`, `sample_batches`, `capture_batches` /
`capture_within` and `trace_iterations`, as the serve cell reads them; the
canonical images and the orbits of the captured batches are kept.
`memory_peak_bytes` is the peak of the last warm-up batch, which keeps
nothing for the comparison.

End-to-end: `serve_img_per_s` counts the orbit's images (|G| B a batch)
whose logits reached the host in the window, over its seconds;
`serve_p95_ms` as the serve cell's. The numbers of `correct` are the serve
cell's (`serve.compare`) with the reference run on the orbit it makes
itself (`torch.rot90` of the batch by each element), and `orbit_mismatch`:
the captured batches' orbit images that are not bit-equal to the
reference's.
"""

from __future__ import annotations

import gc
import random
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import data, program, serve, trace, work
from benchmark.reference.common import fp32_only


def reference_orbit(x: torch.Tensor, elements: int) -> torch.Tensor:
    """The orbit of NHWC images x under `elements` quarter turns,
    group-major: element g turns each image by +90 g degrees
    (`torch.rot90(x, g)` on the image's rows and columns)."""
    return torch.cat([torch.rot90(x, g, dims=(1, 2)) for g in range(elements)])


def run(cell, seed: int, seconds: float, traced: bool, device, t0: float,
        control: bool = False) -> dict:
    from equiadapt_tpu_torch.pipelines.classification import orbit_logits

    settings, tr = cell.settings, cell.traffic
    B, G, n_pool = tr["batch_size"], tr["group_elements"], tr["pool"]
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
    orbits: Dict[int, torch.Tensor] = {}

    def keep_canonical(_module, args):
        if state["it"] in capture_at:
            captured[state["it"]] = args[0]

    def keep_orbit(_module, args):
        if state["it"] in capture_at:
            orbits[state["it"]] = args[0]

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
                logits, info = orbit_logits(pipe, x, num_rotations=G)
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

    cuda = torch.device(device).type == "cuda"
    for i in range(tr["warmup_batches"]):
        if cuda and i == tr["warmup_batches"] - 1:
            # the peak a deployment reaches: a warm batch, nothing kept for the comparison
            program.sync(device)
            torch.cuda.reset_peak_memory_stats(device)
        serve_until(0.0, record=False)
    program.sync(device)
    setup_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    hooks = [pipe.prediction_network.register_forward_pre_hook(keep_canonical),
             pipe.register_forward_pre_hook(keep_orbit)]
    record = {"mode": "group-eval", "batch": G * B, "spans_ms": {}}
    t_start = time.perf_counter()
    if traced:
        with trace.profiled(device) as prof:
            prof["iterations"] = serve_until(t_start + seconds, True, tr["trace_iterations"])
        record["trace"] = prof
    serve_until(t_start + seconds, True)
    window_s = time.perf_counter() - t_start
    for h in hooks:
        h.remove()
    n = len(latencies)
    e2e = {"serve_img_per_s": n * G * B / window_s,
           "serve_p95_ms": float(np.percentile(np.asarray(latencies) * 1e3, 95)),
           "setup_s": setup_s}
    failed = sum(int(not bool(torch.isfinite(lg.float()).all())) for lg in logits_host)
    if traced:
        record["work"] = {"flops_per_iter": work.serve_flops(ref, settings, G * B)}
        record["peaks"] = {"bf16_flops": work.BF16_PEAK_FLOPS, "hbm_bytes": work.HBM_PEAK_BYTES}

    del pipe
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref_orbits = [reference_orbit(x, G) for x in images]
    sample = set(rng.sample(range(n), min(tr["sample_batches"], n)))
    mismatch = sum(int(not torch.equal(got[j], want[j]))
                   for i, got in orbits.items()
                   for want in [ref_orbits[i % n_pool]] for j in range(G * B))
    numbers = serve.compare(ref, settings, seed, device, ref_orbits, sample, captured,
                            logits_host, elements, acts)
    numbers["orbit_mismatch"] = float(mismatch) if orbits else float("inf")
    out = {"setup_s": setup_s, "e2e": e2e, "attempted": n * G * B, "failed": failed * G * B,
           "numbers": numbers, "record": record, "memory_peak_bytes": peak,
           "window_s": window_s, "iterations": n}
    if control:
        out["control"], out["fault"] = serve.compare_control(ref, settings, seed, device,
                                                             ref_orbits, sample, cell.control)
    return out
