"""Profiling: the program's spans and counters, and the captures they read.

Counterpart of `equiadapt_tpu/utils/profiling.py`, on `torch.profiler`:

    from equiadapt_tpu_torch.utils.profiling import profile_trace

    with profile_trace("/tmp/eqt_trace"):
        state, metrics = train_step(state, batch, generator)
        torch.cuda.synchronize()
    for name, ms in device_op_attribution("/tmp/eqt_trace")[:10]:
        print(f"{ms:8.3f} ms  {name}")
    for name, ms in idle_by_span("/tmp/eqt_trace")[:10]:
        print(f"{ms:8.3f} ms idle  {name}")

`profile_trace` writes a Chrome trace (`trace_<n>.json`, viewable in
Perfetto or chrome://tracing) of the enclosed block.

**Spans.** `annotate(name)` marks a stage of the program: `pipeline`,
`canon` with `canon/get_group_activations` (`canon/get_groupelement` in the
continuous canonicalizers; `canon/prep`, the crop and resize, inside it),
`canon/select_element` and `canon/warp` under it, `canon/invert`,
`predict`, `train/step` with `train/forward`, `train/loss`,
`train/backward` and `train/optimizer` under it, `dist/sync_bn` and
`dist/grad_sync`, and SAM's `sam/encoder` (with `sam/attn/window`,
`sam/attn/global` and `sam/neck`), `sam/prompt`, `sam/decoder` and
`sam/upsample` (`models.sam`), Mask R-CNN's `maskrcnn/backbone`,
`maskrcnn/rpn`, `maskrcnn/nms` (each NMS call, inside the RPN and the RoI
heads), `maskrcnn/roi_heads` (with `maskrcnn/roi_align`,
`maskrcnn/box_head` and `maskrcnn/mask_head`) and `maskrcnn/paste`
(`models.maskrcnn`), and `group/orbit` (`pipelines.classification`'s
orbit of a group evaluation). A span records only while a
`torch.profiler` session records or inside `recording()`; otherwise it is
a shared null context (two flag reads, no allocation). Recording, a span enters
`torch.profiler.record_function(name)` (so it shows in captures with CPU
activity), keeps its host begin and end in nanoseconds on the profiler's
clock (`time.time_ns`, the wall clock kineto stamps its events with), a
pair of CUDA events on the current stream when CUDA is in use (device
milliseconds between its edges), its parent, and the host syncs made while
it was the innermost open span on its thread (`torch.cuda`'s sync debug
mode, set to "warn" while a session is open once CUDA is in use; the
warnings are counted, never printed). A sync with no span open counts as
"outside the program".

**Sessions.** Each time recording turns on, a new `Session` starts; only
the newest is kept (`last_session()`). A profiler-driven session closes
when the recorder next sees the profiler off (at a span, a sync or
`last_session()`); `recording()` closes its own on exit.
`last_session().summary()` gives each span's calls, mean host and device
milliseconds and host syncs a call.

**Counters.** `count(name, n)` adds to a process-wide counter (host syncs
by span are counted there too, and `steerable/kernel_cache_hit` /
`steerable/kernel_cache_miss`, each grad-off call of a `SteerableConv`
that reused or assembled its kernel; `paths/steerable_conv/spectral` /
`paths/steerable_conv/direct`, each eager `SteerableConv` call by its path; `sam/prompts`, the box prompts SAM
was given, and `sam/attn_score_elems`, the attention score elements its
written-out calls materialized: none on the fused kernel's path);
Mask R-CNN counts on the card (`count_on_device`, while spans record:
the sums stay on the device until `counters()` reads them)
`maskrcnn/proposals` (valid proposals), `maskrcnn/nms_candidates` and
`maskrcnn/nms_pairs` (valid boxes entering NMS and the pairs of a segment
its bitmask pass compares) and `maskrcnn/detections` (valid detections);
`counters()` returns it with the kernel modules' launch counters
(`launches/<wrapper>/<dtype>` and `paths/<wrapper>/<dtype>/<path>`).

`idle_by_span(trace_dir)` puts each idle gap between device operations in
the newest capture down to the innermost program spans open on the host
during it, by overlap; what no span covers is "outside the program".
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

Tensor = torch.Tensor

__all__ = ["profile_trace", "annotate", "recording", "last_session", "Session",
           "SpanCall", "count", "count_on_device", "counters", "device_memory_stats",
           "device_op_attribution", "idle_by_span", "profile_report",
           "OUTSIDE", "PROGRAM_SPANS"]

OUTSIDE = "outside the program"
# the first path segment of every span the program names
PROGRAM_SPANS = ("pipeline", "canon", "predict", "train", "dist", "sam", "maskrcnn", "group")
SYNC_MESSAGE = "called a synchronizing CUDA operation"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass(eq=False)
class SpanCall:
    """One recorded call of a span: `parent` is the index in its session of
    the span open around it on its thread (-1 at the top); `syncs` the host
    syncs made while it was the innermost open span; `events` the (start,
    end) CUDA events, or None."""

    name: str
    index: int
    parent: int
    begin_ns: int = 0
    end_ns: int = 0
    syncs: int = 0
    events: Optional[Tuple] = None

    def host_ms(self) -> float:
        return (self.end_ns - self.begin_ns) / 1e6

    def device_ms(self) -> Optional[float]:
        if self.events is None or self.events[1] is None:
            return None
        self.events[1].synchronize()
        return float(self.events[0].elapsed_time(self.events[1]))


class Session:
    """The spans and syncs recorded while recording was on once."""

    def __init__(self):
        self.calls: List[SpanCall] = []
        self.outside_syncs = 0
        self.open = True

    def syncs_inside(self) -> List[int]:
        """Each call's host syncs, those of the spans nested in it included."""
        total = [c.syncs for c in self.calls]
        for c in reversed(self.calls):
            if c.parent >= 0:
                total[c.parent] += total[c.index]
        return total

    def summary(self) -> Dict[str, dict]:
        """By span name, over its closed calls: `calls`, `host_ms` and
        `device_ms` (means a call; device None without CUDA events) and
        `syncs` (host syncs a call, nested spans included)."""
        inside = self.syncs_inside()
        rows: Dict[str, dict] = {}
        for c in self.calls:
            if c.end_ns == 0:
                continue
            r = rows.setdefault(c.name, {"calls": 0, "host": 0.0, "device": [], "syncs": 0})
            r["calls"] += 1
            r["host"] += c.host_ms()
            r["device"].append(c.device_ms())
            r["syncs"] += inside[c.index]
        out = {}
        for name, r in rows.items():
            n, dev = r["calls"], r["device"]
            out[name] = {"calls": n, "host_ms": r["host"] / n,
                         "device_ms": None if None in dev else sum(dev) / n,
                         "syncs": r["syncs"] / n}
        return out


_NULL = contextlib.nullcontext()
_live = False        # recording() is on, or a session is open
_recording = 0       # depth of recording() contexts
_session: Optional[Session] = None
_hooked: Optional[tuple] = None  # what a session changed, undone when it closes
_prev_mode: Optional[int] = None  # the sync debug mode before a session set it
_local = threading.local()
_lock = threading.RLock()  # sessions open and close, calls and counters add, one thread at a time
_counts: Dict[str, int] = {}
_device_counts: Dict[str, Tensor] = {}  # `count_on_device`'s sums, on their devices


def _on() -> bool:
    return _autograd_profiler._is_profiler_enabled or _recording > 0


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _current() -> Session:
    """The open session, a new one when none is."""
    global _session, _live
    with _lock:
        if _session is None or not _session.open:
            _session = Session()
            _live = True
            _hook_syncs()
        return _session


def _close() -> None:
    global _live
    with _lock:
        if _session is not None and _session.open:
            _session.open = False
            _unhook_syncs()
        _live = _recording > 0


def _hook_syncs() -> None:
    """Count host syncs while the session is open: the sync debug warning
    always passed to `_showwarning`, which counts it and prints nothing;
    the mode that raises it is set once CUDA is in use (`_watch_cuda`)."""
    global _hooked
    warnings.filterwarnings("always", message=SYNC_MESSAGE, category=UserWarning)
    _hooked = (warnings.showwarning, warnings.filters[0])
    warnings.showwarning = _showwarning
    _watch_cuda()


def _set_sync_mode(mode) -> None:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # torch's note that the mode is a prototype
        torch.cuda.set_sync_debug_mode(mode)


def _watch_cuda() -> None:
    """torch.cuda's sync debug mode at "warn" while a session is open, from
    the first span that finds CUDA in use."""
    global _prev_mode
    with _lock:
        if _hooked is not None and _prev_mode is None and torch.cuda.is_initialized():
            _prev_mode = torch.cuda.get_sync_debug_mode()
            _set_sync_mode("warn")


def _unhook_syncs() -> None:
    global _hooked, _prev_mode
    if _hooked is None:
        return
    show, flt = _hooked
    _hooked = None
    if warnings.showwarning is _showwarning:
        warnings.showwarning = show
    with contextlib.suppress(ValueError):
        warnings.filters.remove(flt)
        warnings._filters_mutated()
    if _prev_mode is not None:
        _set_sync_mode(_prev_mode)
        _prev_mode = None


def _showwarning(message, category, filename, lineno, file=None, line=None):
    if issubclass(category, UserWarning) and str(message).startswith(SYNC_MESSAGE):
        _note_sync()
        return
    show = _hooked[0] if _hooked is not None else warnings._showwarning_orig
    show(message, category, filename, lineno, file, line)


def _note_sync() -> None:
    """One host sync, against the innermost open span of this thread."""
    if not _on():
        _close()
        return
    session = _current()
    stack = _stack()
    if stack and stack[-1][0] is session:
        call = stack[-1][1]
        call.syncs += 1
        count(f"host_syncs/{call.name}")
    else:
        session.outside_syncs += 1
        count(f"host_syncs/{OUTSIDE}")


class _Span:
    __slots__ = ("name", "call", "record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        session = _current()
        stack = _stack()
        parent = stack[-1][1].index if stack and stack[-1][0] is session else -1
        with _lock:  # a call's index is its place in the session's list
            call = SpanCall(self.name, len(session.calls), parent)
            session.calls.append(call)
        stack.append((session, call))
        self.call = call
        call.begin_ns = time.time_ns()
        self.record = torch.profiler.record_function(self.name)
        self.record.__enter__()
        if torch.cuda.is_initialized():
            if _prev_mode is None:
                _watch_cuda()
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            call.events = (start, None)

    def __exit__(self, *exc):
        call = self.call
        if call.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            call.events = (call.events[0], end)
        self.record.__exit__(*exc)
        call.end_ns = time.time_ns()
        stack = _stack()
        if stack and stack[-1][1] is call:
            stack.pop()
        return False


def annotate(name: str, enabled: bool = True):
    """The program's span `name` (module docstring): recorded while a
    `torch.profiler` session records or inside `recording()`, else a shared
    null context. `enabled=False` keeps it off."""
    if not (_autograd_profiler._is_profiler_enabled or _live):
        return _NULL
    if not _on():  # the profiler stopped since the session's last span
        _close()
        return _NULL
    return _Span(name) if enabled else _NULL


@contextlib.contextmanager
def recording() -> Iterator[Session]:
    """Record the program's spans and syncs in the enclosed block without a
    profiler, into a new session (yielded)."""
    global _recording
    _close()
    _recording += 1
    try:
        yield _current()
    finally:
        _recording -= 1
        _close()


def last_session() -> Optional[Session]:
    """The newest recorded session (None before any), closed first if the
    profiler that drove it has stopped."""
    if _session is not None and _session.open and not _on():
        _close()
    return _session


def count(name: str, n: int = 1) -> None:
    """Add `n` to the process-wide counter `name`."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def count_on_device(name: str, n) -> None:
    """Add the integer tensor `n` (any shape: its sum) to the counter `name`
    on its device, while spans record (`annotate`'s condition); otherwise
    nothing. `n` may also be a function that makes that tensor, called only
    while spans record, so that a count that costs launches costs none
    otherwise. The sum is read on the host only by `counters()`, so a served
    call that counts what it computed on the card does not wait for it."""
    if not (_autograd_profiler._is_profiler_enabled or _live):
        return
    if callable(n):
        n = n()
    total = n.detach().sum(dtype=torch.int64)
    with _lock:
        held = _device_counts.get(name)
        _device_counts[name] = total if held is None else held + total.to(held.device)


def counters() -> Dict[str, int]:
    """The counters of `count`, and the hand kernels' launches by wrapper
    and dtype (`launches/...`) and by launch path (`paths/...`)."""
    from equiadapt_tpu_torch.ops.kernels import (
        bilinear_warp, bn_act, knn, nms, orbit, roi_align, sam_attention, select_warp,
        shear_rotate, spectral_conv)

    out = dict(_counts)
    with _lock:
        for name, total in _device_counts.items():
            out[name] = out.get(name, 0) + int(total)
    for m in (select_warp, shear_rotate, orbit, bilinear_warp, knn, sam_attention,
              spectral_conv, roi_align, nms, bn_act):
        out.update({f"launches/{k}": v for k, v in m.launches.items()})
        out.update({f"paths/{k}": v for k, v in getattr(m, "path_launches", {}).items()})
    return out


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True) -> Iterator[None]:
    """Trace the enclosed block (CPU ops and the program's spans, and the
    CUDA kernels when a card is present) into a new
    `log_dir/trace_<n>.json`. A no-op when `enabled` is False, so a call
    site can key it off a config flag."""
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
    last_session()  # the profiler has stopped: close its session
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{n}.json"))


def device_memory_stats(device: Optional[torch.device] = None) -> dict:
    """Live / peak device memory counters of a CUDA device
    (`torch.cuda.memory_stats`); an empty dict without a card."""
    if not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats(device))


def _newest_trace_events(trace_dir: str) -> list:
    traces = sorted(glob.glob(os.path.join(trace_dir, "trace_*.json")),
                    key=lambda p: int(p.rsplit("_", 1)[1][:-len(".json")]))
    if not traces:
        raise FileNotFoundError(f"no trace_*.json under {trace_dir}")
    with open(traces[-1]) as f:
        return [e for e in json.load(f).get("traceEvents", [])
                if e.get("ph") == "X" and "dur" in e]


def device_op_attribution(trace_dir: str, top: int = 40) -> list:
    """Summed durations by name from the newest `profile_trace` capture:
    its device-kernel events ("kernel" category) or, in a trace without
    any (no card), its CPU op events and annotations. Returns
    [(name, total_ms)], most expensive first."""
    events = _newest_trace_events(trace_dir)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        kernels = [e for e in events
                   if e.get("cat") in ("cpu_op", "user_annotation")]
    agg: dict = {}
    for e in kernels:
        agg[e["name"]] = agg.get(e["name"], 0.0) + float(e["dur"])
    rows = sorted(agg.items(), key=lambda kv: -kv[1])[:top]
    return [(name, us / 1e3) for name, us in rows]


def _innermost(spans: List[Tuple[float, float, str]]) -> List[Tuple[float, float, str]]:
    """Disjoint pieces of the spans' union, each named by the innermost
    span open over it (the latest begun)."""
    bounds = sorted({t for a, b, _ in spans for t in (a, b)})
    by_start = sorted(spans)
    pieces: List[Tuple[float, float, str]] = []
    active: List[Tuple[float, float, str]] = []
    i = 0
    for lo, hi in zip(bounds, bounds[1:]):
        while i < len(by_start) and by_start[i][0] <= lo:
            active.append(by_start[i])
            i += 1
        active = [s for s in active if s[1] > lo]
        if active:
            name = max(active, key=lambda s: (s[0], -s[1]))[2]
            if pieces and pieces[-1][1] == lo and pieces[-1][2] == name:
                pieces[-1] = (pieces[-1][0], hi, name)
            else:
                pieces.append((lo, hi, name))
    return pieces


def idle_by_span(trace_dir: str) -> list:
    """The newest `profile_trace` capture's idle time, put down to the
    program's spans: each gap between device operations (kernels, copies,
    sets) is split over the innermost program spans (`PROGRAM_SPANS`) open
    on the host during it, by overlap; what no span covers goes to
    `OUTSIDE`. Returns every row as [(name, idle_ms)], most first; the rows
    sum to the capture's idle time between its first and last device
    operation. A capture without device operations gives []."""
    events = _newest_trace_events(trace_dir)
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                    if e.get("cat") in DEVICE_CATEGORIES)
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
             if e.get("cat") == "user_annotation"
             and e["name"].split("/")[0] in PROGRAM_SPANS]
    gaps = []
    reach = None
    for a, b in device:
        if reach is not None and a > reach:
            gaps.append((reach, a))
        reach = b if reach is None else max(reach, b)
    pieces = _innermost(spans)
    rows: Dict[str, float] = {}
    j = 0
    for a, b in gaps:
        covered = 0.0
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            lap = min(b, pieces[k][1]) - max(a, pieces[k][0])
            if lap > 0:
                rows[pieces[k][2]] = rows.get(pieces[k][2], 0.0) + lap
                covered += lap
            k += 1
        if b - a - covered > 0:
            rows[OUTSIDE] = rows.get(OUTSIDE, 0.0) + (b - a - covered)
    return [(name, us / 1e3) for name, us in sorted(rows.items(), key=lambda kv: -kv[1])]


def profile_report(trace_dir: str, top: int = 8) -> List[str]:
    """Lines for a CLI to print after a capture: the newest session's spans
    (calls, host and device ms a call, host syncs a call), the top rows of
    `idle_by_span` and the non-zero counters."""
    lines = []
    session = last_session()
    if session is not None:
        lines.append("spans: name calls host_ms device_ms syncs")
        for name, r in session.summary().items():
            dev = "-" if r["device_ms"] is None else f"{r['device_ms']:.3f}"
            lines.append(f"  {name} {r['calls']} {r['host_ms']:.3f} {dev} {r['syncs']:g}")
        lines.append(f"  {OUTSIDE}: {session.outside_syncs} host syncs")
    rows = idle_by_span(trace_dir)
    lines.append(f"idle by span: {sum(ms for _, ms in rows):.3f} ms")
    lines += [f"  {ms:.3f} ms  {name}" for name, ms in rows[:top]]
    lines.append("counters: " + json.dumps({k: v for k, v in sorted(counters().items()) if v}))
    return lines
