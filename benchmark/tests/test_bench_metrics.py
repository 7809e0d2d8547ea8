"""Each per-layer reader's arithmetic on a synthetic record, the trace
reduction on synthetic device events, and the comparison's arithmetic."""

import math
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import cell as cells
from benchmark.harness import check, trace

SERVE = {
    "mode": "serve", "batch": 256,
    "spans_ms": {"canonicalizer": [4.0, 6.0], "canonicalization_network": [1.0, 3.0],
                 "prediction_network": [20.0, 22.0]},
    "trace": {"iterations": 40, "window_s": 1.0, "busy_s": 0.95},
    "work": {"flops_per_iter": 2.0e12, "canon_bytes": 3.35e9},
    "peaks": {"bf16_flops": 1.0e15, "hbm_bytes": 3.35e12},
}
TRAIN = {
    "mode": "train", "batch": 128,
    "spans_ms": {"train_step": [60.0, 62.0], "pipeline": [20.0, 22.0]},
    "trace": {"iterations": 16, "window_s": 1.0, "busy_s": 0.99},
    "work": {"flops_per_iter": 3.0e12},
    "peaks": {"bf16_flops": 1.0e15, "hbm_bytes": 3.35e12},
}

EXPECTED = {
    "canonicalize_ms.serve": (SERVE, 5.0),
    "predict_ms.serve": (SERVE, 21.0),
    # 3.35e9 bytes at 3.35e12 B/s = 1 ms, over (5 - 2) ms
    "canon_movement_roofline.serve": (SERVE, 100.0 / 3.0),
    "step_mfu_pct.serve": (SERVE, 100.0 * 2.0e12 * 40 / 1.0e15),
    "device_idle_pct.serve": (SERVE, 5.0),
    "backward_update_ms.train": (TRAIN, 40.0),
    "step_mfu_pct.train": (TRAIN, 100.0 * 3.0e12 * 16 / 1.0e15),
    "device_idle_pct.train": (TRAIN, 1.0),
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader(name):
    record, want = EXPECTED[name]
    reader = cells.metric_reader(name)
    assert reader.read(record) == pytest.approx(want, rel=1e-12)
    other = SERVE if record is not SERVE else TRAIN
    assert reader.read(other) is None
    assert reader.read({"mode": record["mode"]}) is None


def test_every_metric_is_tested():
    import json
    manifest = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
    assert {m["name"] for m in manifest["per_layer"]} <= set(EXPECTED)


def _event(name, start, dur, cuda=True, note=False):
    dev = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=lambda: name, device_type=lambda: dev,
                           start_ns=lambda: start, duration_ns=lambda: dur,
                           is_user_annotation=lambda: note)


def test_trace_reduction():
    events = [
        _event("k1", 0, 100), _event("k2", 50, 100),           # union 0-150
        _event("k4", 400, 100),                                # gap 150-400
        _event("k3", 600, 50),                                 # gap 500-600
        _event("k1", 700, 50),                                 # gap 650-700
        _event("host op", 140, 300, cuda=False),               # not device work
        _event("annotation copy", 0, 10 ** 6, note=True),      # not device work
    ]
    out = trace.reduce_events(events)
    assert out["busy_s"] == pytest.approx(350e-9)
    assert dict(out["idle_gaps"]) == pytest.approx(
        {"idle before k4": 250e-9, "idle before k3": 100e-9,
         "idle before k1": 50e-9})
    assert out["device_ops"][0] == ["k1", pytest.approx(150e-9)]
    assert out["device_events"] == 5


def test_leaf_gaps_and_verdict():
    ref = {"a": 1.0, "b": 2.0, "c": 4.0, "d": 1e-6}
    keep = check.moved_leaves(ref)
    assert keep == ["a", "b", "c"]
    # a leaf below the median is held against the median
    assert check.leaf_gaps({"a": 1.2, "b": 2.0, "c": 4.0}, ref, keep) == pytest.approx(0.1)
    assert check.leaf_gaps({"a": 1.0, "b": 2.0}, ref, keep) == math.inf
    assert check.verdict({"x": 0.1}, {"x": 0.2})
    assert not check.verdict({"x": 0.3}, {"x": 0.2})
    assert not check.verdict({"x": math.nan}, {"x": 0.2})
    assert not check.verdict({"x": 0.1}, {})
    assert check.rel_max(torch.tensor([1.0, float("nan")]), torch.ones(2)) == math.inf
