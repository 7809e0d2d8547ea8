"""The readers of the program's own spans (`benchmark/harness/spans.py`):
each reads one figure of one span from the program's newest recorded
session, and reports nothing for another mode, an untraced run, a session
without its span, or a program without the recorder.

Importing this module adds its metrics to `test_bench_metrics.EXPECTED`, so
that `test_every_metric_is_tested` finds them there; their arithmetic is
tested here, on a session the test builds."""

import pytest

import test_bench_metrics
from benchmark.harness import cell as cells
from equiadapt_tpu_torch.utils import profiling

SERVE = {"mode": "serve", "trace": {"iterations": 2}}
TRAIN = {"mode": "train", "trace": {"iterations": 2}}


class Event:
    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def session():
    """Two served batches and two train steps: (name, parent, host ms,
    device ms, own syncs) per call."""
    s = profiling.Session()
    calls = [
        ("pipeline", -1, 10.0, 9.0, 1), ("canon", 0, 4.0, 3.0, 0),
        ("canon/warp", 1, 1.0, 0.5, 2), ("predict", 0, 5.0, 5.0, 0),
        ("pipeline", -1, 12.0, 9.0, 0), ("canon", 4, 4.0, 3.0, 1),
        ("canon/warp", 5, 1.0, 1.5, 0), ("predict", 4, 5.0, 5.0, 0),
        ("train/step", -1, 40.0, 50.0, 0), ("train/backward", 8, 10.0, 20.0, 1),
        ("train/optimizer", 8, 3.0, 4.0, 0),
        ("train/step", -1, 44.0, 50.0, 2), ("train/backward", 11, 10.0, 22.0, 0),
        ("train/optimizer", 11, 3.0, 6.0, 0),
    ]
    for i, (name, parent, host, dev, syncs) in enumerate(calls):
        s.calls.append(profiling.SpanCall(name, i, parent, begin_ns=0, end_ns=int(host * 1e6),
                                          syncs=syncs, events=(Event(0.0), Event(dev))))
    s.open = False
    return s


SPAN_EXPECTED = {
    "canon_warp_ms.serve": (SERVE, 1.0),
    "pipeline_host_ms.serve": (SERVE, 11.0),
    "host_syncs.serve": (SERVE, 2.0),         # (1 + 2 + 0) and (0 + 1 + 0)
    "backward_ms.train": (TRAIN, 21.0),
    "optimizer_ms.train": (TRAIN, 5.0),
    "step_host_ms.train": (TRAIN, 42.0),
    "host_syncs.train": (TRAIN, 1.5),         # (0 + 1) and 2
}
test_bench_metrics.EXPECTED.update(SPAN_EXPECTED)


@pytest.fixture
def recorded(monkeypatch):
    s = session()
    monkeypatch.setattr(profiling, "last_session", lambda: s)
    return s


@pytest.mark.parametrize("name", sorted(SPAN_EXPECTED))
def test_reader(name, recorded):
    record, want = SPAN_EXPECTED[name]
    reader = cells.metric_reader(name)
    assert reader.read(record) == pytest.approx(want, rel=1e-12)
    other = SERVE if record is TRAIN else TRAIN
    assert reader.read(other) is None
    assert reader.read({"mode": record["mode"]}) is None  # not traced
    assert reader.read(dict(record, trace=None)) is None


@pytest.mark.parametrize("name", sorted(SPAN_EXPECTED))
def test_reader_finds_nothing(name, monkeypatch):
    record, _ = SPAN_EXPECTED[name]
    reader = cells.metric_reader(name)
    monkeypatch.setattr(profiling, "last_session", lambda: None)
    assert reader.read(record) is None
    monkeypatch.setattr(profiling, "last_session", lambda: profiling.Session())
    assert reader.read(record) is None
    # a program without the recorder, as before it had one
    monkeypatch.delattr(profiling, "last_session")
    assert reader.read(record) is None


def test_readers_on_a_recorded_cpu_session():
    """The program's own recorder, on the CPU: host figures and syncs read,
    device figures absent (no CUDA events)."""
    with profiling.recording():
        for _ in range(2):
            with profiling.annotate("pipeline"):
                with profiling.annotate("canon/warp"):
                    pass
    assert cells.metric_reader("pipeline_host_ms.serve").read(SERVE) > 0
    assert cells.metric_reader("host_syncs.serve").read(SERVE) == 0.0
    assert cells.metric_reader("canon_warp_ms.serve").read(SERVE) is None
    assert cells.metric_reader("step_host_ms.train").read(TRAIN) is None


def test_manifest_entries():
    import json

    manifest = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in manifest["per_layer"]}
    for name in SPAN_EXPECTED:
        m = entries[name]
        assert m["source"] == "program_span" and m["better"] == "lower"
        mode = name.rsplit(".", 1)[1]
        assert all(w.endswith("." + mode) for w in m["workloads"])
