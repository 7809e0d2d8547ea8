"""The `group_eval` driver and the readers of the `c8-resnet50.group-eval`
cell.

Importing this module adds the cell's four metrics to
`test_bench_metrics.EXPECTED`, so that `test_every_metric_is_tested` finds
them there; their arithmetic is tested here, on a record and a session the
test builds. A run of the driver on a CPU cut of the cell (32 px, batches
of 2, so 8 orbit images a call) is `correct` on the sound program, its
orbit bit-equal to the reference's quarter turns, and not with its orbit
turned the other way or its logits altered; the fp8 control fails."""

import copy
import time

import pytest
import torch

import test_bench_metrics
from benchmark.harness import cell as cells
from benchmark.harness import check, group_eval, program
from equiadapt_tpu_torch.ops.kernels import orbit
from equiadapt_tpu_torch.pipelines import classification
from equiadapt_tpu_torch.utils import profiling

CELL = "c8-resnet50.group-eval"
SEED = 3_000_000_077

GROUP = {
    "mode": "group-eval", "batch": 256, "spans_ms": {},
    "trace": {"iterations": 10, "window_s": 1.0, "busy_s": 0.9},
    "work": {"flops_per_iter": 2.0e12},
    "peaks": {"bf16_flops": 1.0e15, "hbm_bytes": 3.35e12},
}


class Event:
    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def session():
    s = profiling.Session()
    calls = [("group/orbit", -1, 0.5, 0.25, 0), ("pipeline", -1, 10.0, 40.0, 0),
             ("canon", 1, 4.0, 10.0, 2), ("group/orbit", -1, 0.5, 0.75, 0),
             ("pipeline", -1, 10.0, 40.0, 0), ("canon", 4, 4.0, 10.0, 4),
             ("canon/warp", 2, 0.5, 2.0, 0), ("canon/warp", 5, 0.5, 3.0, 0)]
    for i, (name, parent, host, dev, syncs) in enumerate(calls):
        s.calls.append(profiling.SpanCall(name, i, parent, begin_ns=0, end_ns=int(host * 1e6),
                                          syncs=syncs, events=(Event(0.0), Event(dev))))
    s.open = False
    return s


GROUP_EXPECTED = {
    "orbit_ms.group-eval": (GROUP, 0.5),
    "step_mfu_pct.group-eval": (GROUP, 100.0 * 2.0e12 * 10 / 1.0e15),
    "device_idle_pct.group-eval": (GROUP, 10.0),
    "host_syncs.group-eval": (GROUP, 3.0),
    "pipeline_host_ms.group-eval": (GROUP, 10.0),
    "canon_warp_ms.group-eval": (GROUP, 2.5),
}
test_bench_metrics.EXPECTED.update(GROUP_EXPECTED)


@pytest.fixture
def recorded(monkeypatch):
    s = session()
    monkeypatch.setattr(profiling, "last_session", lambda: s)
    return s


@pytest.mark.parametrize("name", sorted(GROUP_EXPECTED))
def test_reader(name, recorded):
    record, want = GROUP_EXPECTED[name]
    reader = cells.metric_reader(name)
    assert reader.read(record) == pytest.approx(want, rel=1e-12)
    assert reader.read(test_bench_metrics.SERVE) is None
    assert reader.read(test_bench_metrics.TRAIN) is None
    assert reader.read({"mode": "group-eval"}) is None  # not traced


@pytest.mark.parametrize("name", sorted(GROUP_EXPECTED))
def test_reader_finds_nothing_without_the_spans(name, monkeypatch):
    record, _ = GROUP_EXPECTED[name]
    monkeypatch.setattr(profiling, "last_session", lambda: profiling.Session())
    value = cells.metric_reader(name).read(record)
    assert value is None or name in ("step_mfu_pct.group-eval", "device_idle_pct.group-eval")


def test_manifest_entries():
    import json

    manifest = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in manifest["per_layer"]}
    for name in GROUP_EXPECTED:
        assert entries[name]["workloads"] == [CELL]
        assert entries[name]["moves"] == "serve_img_per_s"
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert CELL in e2e["serve_img_per_s"]["workloads"]
    assert CELL in e2e["serve_p95_ms"]["workloads"]


def tiny_cell():
    c = cells.resolve(CELL)
    c.config = copy.deepcopy(c.config)
    c.config["settings"]["dataset"]["image_size"] = 32
    c.traffic = dict(c.traffic, batch_size=2, pool=3, sample_batches=3, capture_batches=1,
                     capture_within=2, trace_iterations=2)
    return c


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(c, control=False):
    res = c.driver().run(c, SEED, 0.5, False, "cpu", time.perf_counter(), control=control)
    res["correct"] = check.verdict(res["numbers"], c.limits) and res["failed"] == 0
    return res


def test_group_eval_sound():
    res = run(tiny_cell())
    assert res["correct"], res["numbers"]
    assert res["numbers"]["orbit_mismatch"] == 0
    assert res["attempted"] == 8 * res["iterations"] and res["e2e"]["serve_img_per_s"] > 0


def test_the_reference_orbit_is_the_programs():
    x = torch.randn(3, 16, 16, 3)
    assert torch.equal(orbit.materialize_orbit(x, 4, sign=1.0),
                       group_eval.reference_orbit(x, 4))


def test_orbit_turned_the_other_way_fails(monkeypatch):
    made = orbit.materialize_orbit

    def backwards(x, n, **kw):
        return made(x, n, **dict(kw, sign=-kw.get("sign", 1.0)))

    monkeypatch.setattr(classification, "materialize_orbit", backwards)
    res = run(tiny_cell())
    assert res["numbers"]["orbit_mismatch"] > 0 and not res["correct"]


def test_altered_logits_fail(monkeypatch):
    build = program.build_pipeline

    def patched(*args, **kwargs):
        pipe = build(*args, **kwargs)

        def hook(_m, _inp, out):
            return out + out.abs().max()
        pipe.prediction_network.register_forward_hook(hook)
        return pipe

    monkeypatch.setattr(program, "build_pipeline", patched)
    res = run(tiny_cell())
    assert not res["correct"], res["numbers"]


def test_group_eval_control_fails():
    c = tiny_cell()
    res = run(c, control=True)
    assert not check.verdict(res["control"], c.limits), res["control"]


@pytest.mark.card
def test_group_eval_on_card(card):
    c = cells.resolve(CELL)
    res = c.driver().run(c, 2 ** 31 + 17, 2.0, False, card, time.perf_counter(), control=True)
    assert check.verdict(res["numbers"], c.limits), res["numbers"]
    assert not check.verdict(res["control"], c.limits), res["control"]
