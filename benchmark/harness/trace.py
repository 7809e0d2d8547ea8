"""The device trace of a run's traced part, reduced in memory.

`torch.profiler` with CUDA activity alone (no host operator records, whose
cost would make the host look slower than it is) runs over the first
`trace_iterations` iterations of the measured window of a `--trace 1` run;
nothing is written to disk. The traced window is timed on the host clock
inside the profiler, between two synchronizes, so the profiler's own start
and stop stay outside it. The reduction keeps the seconds in which any
device operation ran (the union of the kernel, copy and set intervals), the
device time by operation name, and the idle gaps
between device operations, summed by the operation that ended each gap:
what the device was waiting for the host to launch.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List, Tuple

import torch

TOP = 10
NAME = 120  # characters of an operation's name kept in the breakdown


@contextlib.contextmanager
def profiled(device) -> Iterator[dict]:
    """Profile the block's device work; the yielded dict receives the
    reduction and `window_s`."""
    out: dict = {}
    cuda = torch.device(device).type == "cuda"
    activities = [torch.profiler.ProfilerActivity.CUDA if cuda
                  else torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=activities) as prof:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield out
        if cuda:
            torch.cuda.synchronize()
        out["window_s"] = time.perf_counter() - t0
    out.update(reduce_events(prof.profiler.kineto_results.events()))


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def reduce_events(events) -> Dict[str, object]:
    """busy_s, device op seconds by name and idle gaps by the
    operation ending them, from kineto events (objects with name(),
    device_type(), start_ns(), duration_ns(), is_user_annotation())."""
    device = []
    for e in events:
        dur = e.duration_ns()
        if (e.device_type() == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation() and dur > 0):
            device.append((e.start_ns(), e.start_ns() + dur, e.name()))
    device.sort()
    by_name: Dict[str, float] = {}
    for a, b, name in device:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-9
    busy = sum(b - a for a, b in _union([(a, b) for a, b, _ in device])) * 1e-9
    gaps: Dict[str, float] = {}
    reach = None
    for a, b, name in device:
        if reach is not None and a > reach:
            label = "idle before " + name[:NAME]
            gaps[label] = gaps.get(label, 0.0) + (a - reach) * 1e-9
        reach = b if reach is None else max(reach, b)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy, "device_ops": [[n[:NAME], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle],
            "device_events": len(device)}
