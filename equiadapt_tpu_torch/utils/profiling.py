"""Profiling helpers around the canonicalize / predict / invert stages.

Counterpart of `equiadapt_tpu/utils/profiling.py`, on `torch.profiler`:

    from equiadapt_tpu_torch.utils.profiling import profile_trace

    with profile_trace("/tmp/eqt_trace"):
        state, metrics = train_step(state, batch, generator)
        torch.cuda.synchronize()
    for name, ms in device_op_attribution("/tmp/eqt_trace")[:10]:
        print(f"{ms:8.3f} ms  {name}")

`profile_trace` writes a Chrome trace (`trace_<n>.json`, viewable in
Perfetto or chrome://tracing) of the enclosed block; `annotate` names a
span in it (`torch.profiler.record_function`).
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
from typing import Iterator, Optional

import torch

__all__ = ["profile_trace", "annotate", "device_memory_stats",
           "device_op_attribution"]


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True) -> Iterator[None]:
    """Trace the enclosed block (CPU ops, and the CUDA kernels when a card
    is present) into a new `log_dir/trace_<n>.json`. A no-op when `enabled`
    is False, so a call site can key it off a config flag."""
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    n = len(glob.glob(os.path.join(log_dir, "trace_*.json")))
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{n}.json"))


@contextlib.contextmanager
def annotate(name: str, enabled: bool = True) -> Iterator[None]:
    """A named span in the profile (`torch.profiler.record_function`)."""
    if not enabled:
        yield
        return
    with torch.profiler.record_function(name):
        yield


def device_memory_stats(device: Optional[torch.device] = None) -> dict:
    """Live / peak device memory counters of a CUDA device
    (`torch.cuda.memory_stats`); an empty dict without a card."""
    if not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats(device))


def device_op_attribution(trace_dir: str, top: int = 40) -> list:
    """Summed durations by name from the newest `profile_trace` capture:
    its device-kernel events ("kernel" category) or, in a trace without
    any (no card), its CPU op events and annotations. Returns
    [(name, total_ms)], most expensive first."""
    traces = sorted(glob.glob(os.path.join(trace_dir, "trace_*.json")),
                    key=lambda p: int(p.rsplit("_", 1)[1][:-len(".json")]))
    if not traces:
        raise FileNotFoundError(f"no trace_*.json under {trace_dir}")
    with open(traces[-1]) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        kernels = [e for e in events
                   if e.get("cat") in ("cpu_op", "user_annotation")]
    agg: dict = {}
    for e in kernels:
        agg[e["name"]] = agg.get(e["name"], 0.0) + float(e["dur"])
    rows = sorted(agg.items(), key=lambda kv: -kv[1])[:top]
    return [(name, us / 1e3) for name, us in rows]
