"""Training: train steps enqueued back to back on one card.

Set-up builds the train state (the pipeline, AdamW on each parameter
group) and drives it through its first `first_steps` steps, each on its
own batch of the pool, by the same call the window makes; those steps are
the ones the reference follows, and they warm every shape up. The window
then continues the same state, cycling through the pool, and opens and
closes on a synchronize.

Traffic parameters: `batch_size`, `pool`, `first_steps`, `trace_iterations`
(the steps of the window's head that a `--trace 1` run profiles).
End-to-end: `train_img_per_s`, images of the batch times the steps
completed in the window over the window's seconds.
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, List

import torch

from benchmark.harness import check, data, program, trace, work
from benchmark.reference.common import Precision, fp32_only


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    if not names:
        return {}
    vals = torch.stack([torch.linalg.vector_norm(tensors[k].float()) for k in names])
    return dict(zip(names, vals.tolist()))


def run(cell, seed: int, seconds: float, traced: bool, device, t0: float,
        control: bool = False) -> dict:
    settings, tr = cell.settings, cell.traffic
    B, n_pool, first = tr["batch_size"], tr["pool"], tr["first_steps"]
    size, classes = settings["dataset"]["image_size"], settings["dataset"]["num_classes"]
    ref = cell.reference()
    fp32_only()
    torch.backends.cudnn.benchmark = True

    pipe = program.build_pipeline(settings, "train", device)
    data.load_weights(pipe, data.make_weights(ref.param_spec(settings), seed, device))
    state = program.train_state(pipe, cell.config["optimizer"])
    step = program.train_step(settings)
    batches = [dict(zip(("image", "label"), data.pool_batch(seed, i, B, size, classes, device)))
               for i in range(n_pool)]
    gen = data.generator(seed, "steps", device)
    prog, metrics = first_steps(step, state, batches, gen, first, ref, settings, seed, device)
    program.sync(device)
    setup_s = time.perf_counter() - t0

    spans = program.Spans(device)
    record = {"mode": "train", "batch": B}
    if traced:
        program.watch_pipeline(spans, pipe, training=True)
    counter = {"k": 0, "metrics": metrics}

    def steps_until(deadline: float, most: int = -1) -> int:
        done = 0
        while time.perf_counter() < deadline and done != most:
            if traced:
                spans.begin("train_step")
            _, counter["metrics"] = step(state, batches[(first + counter["k"]) % n_pool], gen)
            if traced:
                spans.end("train_step")
            counter["k"] += 1
            done += 1
        program.sync(device)
        return done

    program.sync(device)
    t_start = time.perf_counter()
    if traced:
        with trace.profiled(device) as prof:
            prof["iterations"] = steps_until(t_start + seconds, tr["trace_iterations"])
        record["trace"] = prof
    steps_until(t_start + seconds)
    window_s = time.perf_counter() - t_start
    record["spans_ms"] = spans.durations_ms()
    spans.remove()
    n = counter["k"]
    e2e = {"train_img_per_s": n * B / window_s, "setup_s": setup_s}
    peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
    if traced:
        record["work"] = {"flops_per_iter": work.train_flops(ref, settings, B)}
        record["peaks"] = {"bf16_flops": work.BF16_PEAK_FLOPS, "hbm_bytes": work.HBM_PEAK_BYTES}
    finite = bool(torch.isfinite(torch.tensor(
        prog["losses"] + [float(counter["metrics"]["loss/total"])])).all())
    del state, pipe, step
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    first_batches = [(b["image"], b["label"]) for b in batches[:first]]
    reference = follow(ref, cell.config, seed, device, first_batches, first,
                       elements=whole(prog["elements"], B))
    out = {"setup_s": setup_s, "e2e": e2e, "attempted": n, "failed": 0 if finite else n,
           "numbers": numbers(prog, reference), "record": record, "detail": detail(prog, reference),
           "memory_peak_bytes": peak, "window_s": window_s, "iterations": n}
    if control:
        out["control"] = faults(ref, cell.config, seed, device, first_batches, first,
                                reference, precision=cell.control)
    return out


def first_steps(step, state, batches, gen, first: int, ref, settings: dict, seed: int,
                device):
    """The state's first `first` steps, each on its own batch of the pool,
    by the window's own call: ({losses, the first gradient's leaf norms as
    AdamW holds them after step 1 (exp_avg / (1 - beta1)), the change's
    leaf norms after the last, the elements the canonicalizer chose at each
    step}, the last step's metrics)."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    losses: List[torch.Tensor] = []
    elements: List[torch.Tensor] = []
    hook = state.model.canonicalizer.register_forward_hook(
        lambda _m, _i, out: elements.append(program.element(out[-1]).detach()))
    for i in range(first):
        state, metrics = step(state, batches[i], gen)
        losses.append(metrics["loss/total"])
        if i == 0:
            grads: Dict[str, torch.Tensor] = {}
            for opt in state.optimizers:
                beta1 = opt.defaults["betas"][0]
                for group in opt.param_groups:
                    for p in group["params"]:
                        if p in opt.state and "exp_avg" in opt.state[p]:
                            grads[names[id(p)]] = opt.state[p]["exp_avg"] / (1.0 - beta1)
            grad_norms = _norms(grads)
            del grads
    hook.remove()
    w0 = data.make_weights(ref.param_spec(settings), seed, device)
    params = dict(state.model.named_parameters())
    update_norms = _norms({k: params[k].detach() - w0[k] for k in params})
    return ({"losses": [float(v) for v in losses], "grad": grad_norms,
             "update": update_norms, "elements": [e.cpu() for e in elements]}, metrics)


def whole(elements, rows: int):
    """The program's elements per step where it chose one for every row of
    the batch; None (the reference chooses its own) where it did not, which
    is a fault the gaps then show."""
    return elements if all(e.shape[0] == rows for e in elements) else None


def follow(ref, config, seed, device, batches, steps, prec=None, rows=None,
           remat=False, elements=None) -> dict:
    """The reference's `steps` steps from the run's weights and draws: the
    losses, the first gradient's leaf norms and the change's, and the
    elements it selected (`elements`, per step, where it is to take those
    of what it judges)."""
    settings = config["settings"]
    w0 = data.make_weights(ref.param_spec(settings), seed, device)
    gen = data.generator(seed, "steps", device)
    kw = {} if prec is None else {"prec": prec}
    out = ref.train(w0, batches, gen, settings, config["optimizer"], steps=steps,
                    rows=rows, remat=remat, follow=elements, **kw)
    res = {"losses": out["losses"], "grad": _norms(out["first_grads"]),
           "update": _norms({k: out["params"][k] - w0[k] for k in out["params"]}),
           "elements": [e.cpu() for e in out["elements"]]}
    del out, w0
    gc.collect()
    return res


def numbers(prog: dict, reference: dict) -> Dict[str, float]:
    """loss_gap: the largest of the steps' relative loss gaps; grad_gap:
    the median leaf's gap of the first gradient (its worst leaves are the
    early BatchNorm scales and shifts, whose gradients cancel to a small
    part of their terms and so read bf16 rounding many times over, a
    different leaf on each seed: PERF.md, PR 18); update_gap: the worst
    leaf's gap of the change over the steps."""
    keep = check.moved_leaves(reference["grad"])
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                   for p, r in zip(prog["losses"], reference["losses"]))
    grads = check.each_leaf_gap(prog["grad"], reference["grad"], keep)
    return {"loss_gap": loss_gap,
            "grad_gap": statistics.median(grads.values()),
            "update_gap": check.leaf_gaps(prog["update"], reference["update"], keep)}


def detail(prog: dict, reference: dict, top: int = 6) -> dict:
    """The worst leaves of each leaf gap and each step's loss gap, for the
    look behind a number."""
    keep = check.moved_leaves(reference["grad"])
    out = {"loss_gaps": [abs(p - r) / max(abs(r), 1e-30)
                         for p, r in zip(prog["losses"], reference["losses"])]}
    for key in ("grad", "update"):
        gaps = check.each_leaf_gap(prog[key], reference[key], keep)
        out[key] = sorted(([g, k, prog[key].get(k), reference[key][k]]
                           for k, g in gaps.items()), reverse=True)[:top]
        out[key + "_median_gap"] = statistics.median(gaps.values())
    return out


def faults(ref, config, seed, device, batches, steps, reference, remat=False,
           precision: str = "fp8") -> Dict[str, dict]:
    """The control (the reference one precision below bf16, `precision`,
    in the program's place, judged by the fp32 reference taking the
    control's elements, as the program's judge takes the program's) and the
    planted faults a train cell can have, judged by the program's judge."""
    low = follow(ref, config, seed, device, batches, steps, prec=Precision(precision),
                 remat=remat)
    judge = follow(ref, config, seed, device, batches, steps, remat=remat,
                   elements=low["elements"])
    out = {"control": numbers(low, judge), "detail_control": detail(low, judge)}
    half = slice(0, batches[0][0].shape[0] // 2)
    half_run = follow(ref, config, seed, device, batches, steps, rows=half, remat=remat)
    out["half_batch"] = numbers(half_run, reference)
    out["detail_half_batch"] = detail(half_run, reference)
    unchanged = dict(reference, update={k: 0.0 for k in reference["update"]})
    out["state_unchanged"] = numbers(unchanged, reference)
    return out
