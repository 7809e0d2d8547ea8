"""The port's spans and counters (`utils/profiling.py`) on the CPU.

Off (no profiler, no `recording()`), a span is the shared null context: no
`record_function`, no CUDA event, no allocation. On, spans nest, keep their
parents and host times on the profiler's clock (bracketing their
`record_function` events), and only the newest session is kept. Host syncs
(torch.cuda's sync-debug warning, emulated on the CPU by issuing the same
warning) count against the innermost open span, or outside the program, and
print nothing. `idle_by_span` splits a synthetic Chrome trace's idle gaps
over the innermost program spans. The serving pipeline and the train step
record their stages; `torch.export` of the serving pipeline gives the graph
it gives with the spans taken out; the serving CLI prints the report.
"""

import contextlib
import json
import tracemalloc
import warnings

import pytest
import torch

from equiadapt_tpu_torch.cli import classification_serve as serve
from equiadapt_tpu_torch.cli import classification_train as train
from equiadapt_tpu_torch.ops.kernels import select_warp, shear_rotate
from equiadapt_tpu_torch.utils import profiling as prof
from torch_port_cpu import one_intra_op_thread  # noqa: F401

TINY = [
    "dataset.dataset_name=synthetic",
    "dataset.image_size=16",
    "dataset.num_classes=4",
    "experiment.batch_size=4",
    "canonicalization.resize_shape=8",
    "canonicalization.network_hyperparams.out_channels=4",
    "canonicalization.network_hyperparams.num_layers=1",
    "prediction.architecture=resnet18",
]
SERVE_SPANS = {"pipeline", "canon", "canon/get_group_activations", "canon/prep",
               "canon/select_element", "canon/warp", "predict"}


def cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def sync():
    """A host sync as torch.cuda's sync debug mode reports it."""
    warnings.warn(prof.SYNC_MESSAGE)


@pytest.fixture(scope="module")
def serving():
    cfg = train.compose(TINY)
    pipe = serve.build_serving_pipeline(cfg, "cpu")
    x = torch.rand(4, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    return pipe, x


def test_off_touches_no_profiler_event_or_allocation(monkeypatch, serving):
    def refuse(*a, **k):
        raise AssertionError("touched while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert prof.annotate("canon") is prof.annotate("predict") is prof._NULL
    pipe, x = serving
    with torch.no_grad():
        pipe(x, training=False)
    with prof.annotate("canon/warp"):
        pass
    tracemalloc.start()
    try:
        for _ in range(200):
            with prof.annotate("canon"):
                pass
        snap = tracemalloc.take_snapshot().filter_traces(
            [tracemalloc.Filter(True, prof.__file__)])
    finally:
        tracemalloc.stop()
    assert snap.statistics("lineno") == []


@pytest.mark.parametrize("driver", ["profiler", "recording"])
def test_spans_turn_on_nest_and_keep_the_newest_session(driver):
    on = cpu_profile if driver == "profiler" else prof.recording
    with on():
        with prof.annotate("pipeline"):
            with prof.annotate("canon"):
                with prof.annotate("canon/warp"):
                    pass
            with prof.annotate("predict"):
                pass
    first = prof.last_session()
    assert not first.open
    assert [(c.name, c.parent) for c in first.calls] == [
        ("pipeline", -1), ("canon", 0), ("canon/warp", 1), ("predict", 0)]
    assert all(c.begin_ns <= c.end_ns for c in first.calls)
    assert first.calls[0].begin_ns <= first.calls[1].begin_ns
    assert first.calls[3].end_ns <= first.calls[0].end_ns
    with prof.annotate("pipeline"):  # off: not recorded
        pass
    with on():
        with prof.annotate("train/step"):
            pass
    newest = prof.last_session()
    assert newest is not first and [c.name for c in newest.calls] == ["train/step"]
    assert set(newest.summary()) == {"train/step"}
    assert prof.annotate("canon") is prof._NULL


def test_a_profiler_session_closes_at_the_next_span_after_it():
    with cpu_profile():
        with prof.annotate("canon"):
            pass
        session = prof._session
        assert session.open
    assert session.open  # nothing has looked since the profiler stopped
    with prof.annotate("canon"):
        pass
    assert not session.open and prof._hooked is None
    assert len(session.calls) == 1


def test_enabled_false_stays_off():
    with prof.recording() as session:
        with prof.annotate("canon", enabled=False):
            pass
    assert session.calls == []


def test_host_times_bracket_the_record_function_events():
    with cpu_profile() as p:
        for _ in range(20):
            with prof.annotate("canon"):
                torch.ones(4).sum()
    calls = prof.last_session().calls
    events = sorted((e for e in p.profiler.kineto_results.events() if e.name() == "canon"),
                    key=lambda e: e.start_ns())
    assert len(events) == len(calls) == 20
    for call, e in list(zip(calls, events))[1:]:  # the first call warms up
        lead = e.start_ns() - call.begin_ns
        lag = call.end_ns - (e.start_ns() + e.duration_ns())
        assert 0 <= lead < 100_000 and 0 <= lag < 100_000, (lead, lag)


def test_syncs_count_against_the_innermost_span_and_print_nothing(capsys):
    before = prof.counters().get("host_syncs/canon/warp", 0)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("default")
        with prof.recording() as session:
            sync()
            with prof.annotate("pipeline"):
                sync()
                with prof.annotate("canon"):
                    with prof.annotate("canon/warp"):
                        sync()
                        sync()
                    warnings.warn("another warning")
            sync()
        sync()  # recording is off: not counted
    names = [c.name for c in session.calls]
    own = {c.name: c.syncs for c in session.calls}
    assert own == {"pipeline": 1, "canon": 0, "canon/warp": 2}
    assert session.outside_syncs == 2
    assert dict(zip(names, session.syncs_inside())) == {"pipeline": 3, "canon": 2,
                                                         "canon/warp": 2}
    assert session.summary()["pipeline"]["syncs"] == 3
    assert prof.counters()["host_syncs/canon/warp"] == before + 2
    # the other warning passes through; the syncs were not shown while
    # recording, and the hook is gone after it
    assert [str(w.message) for w in seen] == ["another warning", prof.SYNC_MESSAGE]
    assert capsys.readouterr().err == ""
    assert warnings.showwarning is not prof._showwarning


def test_summary_means_and_device_milliseconds():
    class Event:
        def __init__(self, t):
            self.t = t

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return end.t - self.t

    s = prof.Session()
    for i, (host, dev) in enumerate([(4.0, 1.0), (6.0, 3.0)]):
        s.calls.append(prof.SpanCall("canon/warp", i, -1, begin_ns=0,
                                     end_ns=int(host * 1e6),
                                     events=(Event(0.0), Event(dev))))
    row = s.summary()["canon/warp"]
    assert row == {"calls": 2, "host_ms": 5.0, "device_ms": 2.0, "syncs": 0.0}
    s.calls.append(prof.SpanCall("canon/warp", 2, -1, begin_ns=0, end_ns=10))
    assert s.summary()["canon/warp"]["device_ms"] is None


def write_trace(path, events):
    path.mkdir(parents=True, exist_ok=True)
    (path / "trace_0.json").write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}
        for cat, name, ts, dur in events]}))


def test_idle_by_span_on_a_synthetic_trace(tmp_path):
    write_trace(tmp_path, [
        ("kernel", "k1", 0, 100), ("gpu_memcpy", "Memcpy HtoD", 50, 100),  # busy 0-150
        ("kernel", "k2", 400, 100),                                       # gap 150-400
        ("gpu_memset", "Memset", 600, 50),                                # gap 500-600
        ("kernel", "k3", 700, 50),                                        # gap 650-700
        ("gpu_user_annotation", "canon", 0, 800),                          # not device work
        ("user_annotation", "pipeline", 100, 500),                         # 100-600
        ("user_annotation", "canon", 120, 180),                            # 120-300
        ("user_annotation", "canon/warp", 200, 50),                        # 200-250
        ("user_annotation", "Optimizer.step#AdamW.step", 300, 400),        # not the program's
        ("cpu_op", "aten::mm", 150, 500),
    ])
    rows = dict(prof.idle_by_span(str(tmp_path)))
    # 150-400: canon 150-200 and 250-300, warp 200-250, pipeline 300-400;
    # 500-600: pipeline; 650-700: nothing open
    assert rows == pytest.approx({"canon": 100.0e-3, "canon/warp": 50.0e-3,
                                  "pipeline": 200.0e-3, prof.OUTSIDE: 50.0e-3})
    assert sum(rows.values()) == pytest.approx((800 - 150 - 100 - 50 - 50) * 1e-3 - 50e-3)
    assert prof.idle_by_span(str(tmp_path)) == sorted(rows.items(), key=lambda kv: -kv[1])
    write_trace(tmp_path / "host", [("cpu_op", "aten::mm", 0, 10)])
    assert prof.idle_by_span(str(tmp_path / "host")) == []
    with pytest.raises(FileNotFoundError):
        prof.idle_by_span(str(tmp_path / "none"))


def test_idle_rows_sum_to_the_gaps_whatever_the_spans(tmp_path):
    g = torch.Generator().manual_seed(3)
    events, t = [], 0
    for i in range(60):
        t += int(torch.randint(0, 40, (1,), generator=g))
        d = int(torch.randint(1, 30, (1,), generator=g))
        events.append(("kernel", f"k{i}", t, d))
        t += d
    names = ["pipeline", "canon", "canon/warp", "predict", "train/step"]
    for i in range(40):
        a = int(torch.randint(0, t, (1,), generator=g))
        events.append(("user_annotation", names[i % 5], a,
                       int(torch.randint(1, 200, (1,), generator=g))))
    write_trace(tmp_path, events)
    busy, reach, idle = sorted((a, a + d) for _, _, a, d in events[:60]), None, 0
    for a, b in busy:
        if reach is not None and a > reach:
            idle += a - reach
        reach = b if reach is None else max(reach, b)
    assert sum(ms for _, ms in prof.idle_by_span(str(tmp_path))) == pytest.approx(idle * 1e-3)


def test_counters_show_the_kernel_launches(monkeypatch):
    monkeypatch.setitem(select_warp.launches, "select_planes_nhwc/bfloat16", 3)
    monkeypatch.setitem(select_warp.path_launches, "select_planes_nhwc/bfloat16/tile", 3)
    monkeypatch.setitem(shear_rotate.launches, "shear_rotate_residual/bfloat16", 2)
    prof.count("test/counter", 5)
    c = prof.counters()
    assert c["launches/select_planes_nhwc/bfloat16"] == 3
    assert c["paths/select_planes_nhwc/bfloat16/tile"] == 3
    assert c["launches/shear_rotate_residual/bfloat16"] == 2
    assert c["test/counter"] >= 5


def test_the_serving_pipeline_records_its_stages(serving):
    pipe, x = serving
    with prof.recording() as session, torch.no_grad():
        _, info = pipe(x, training=False)
        pipe.invert(info, torch.zeros(4, 4, 4, 4 * 4, dtype=torch.bfloat16))
    by = {c.name: c for c in session.calls}
    assert set(by) == SERVE_SPANS | {"canon/invert"}
    name = lambda i: session.calls[i].name  # noqa: E731
    assert name(by["canon"].parent) == "pipeline"
    assert name(by["predict"].parent) == "pipeline"
    for stage in ("canon/get_group_activations", "canon/select_element", "canon/warp"):
        assert name(by[stage].parent) == "canon"
    assert name(by["canon/prep"].parent) == "canon/get_group_activations"
    assert by["canon/invert"].parent == -1


def test_the_continuous_canonicalizer_records_its_stages():
    cfg = train.compose(TINY + ["canonicalization=steerable",
                                "canonicalization.network_hyperparams.kernel_size=3",
                                "canonicalization.network_hyperparams.out_channels=2",
                                "canonicalization.network_hyperparams.num_layers=1"])
    pipe = serve.build_serving_pipeline(cfg, "cpu")
    x = torch.rand(2, 16, 16, 3)
    with prof.recording() as session, torch.no_grad():
        pipe(x, training=False)
    names = {c.name: session.calls[c.parent].name if c.parent >= 0 else None
             for c in session.calls}
    assert names == {"pipeline": None, "canon": "pipeline",
                     "canon/get_groupelement": "canon",
                     "canon/prep": "canon/get_groupelement",
                     "canon/warp": "canon", "predict": "pipeline"}


def test_the_train_step_records_its_phases():
    cfg = train.compose(TINY)
    state = train.build_state(cfg, "cpu")
    step = train.make_train_step(train.loss_kwargs(cfg))
    g = torch.Generator().manual_seed(0)
    batch = {"image": torch.rand(4, 16, 16, 3, generator=g),
             "label": torch.randint(0, 4, (4,), generator=g)}
    with prof.recording() as session:
        step(state, batch, torch.Generator().manual_seed(1))
    top = [c.name for c in session.calls if c.parent == 0]
    assert session.calls[0].name == "train/step"
    assert top == ["train/forward", "train/loss", "train/backward", "train/optimizer"]
    fwd = next(c for c in session.calls if c.name == "pipeline")
    assert session.calls[fwd.parent].name == "train/forward"


def test_the_distributed_spans(tmp_path):
    import torch.distributed as dist

    from equiadapt_tpu_torch.common.layers import _SyncBatchNormFn
    from equiadapt_tpu_torch.parallel.mesh import grad_sync

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        x = torch.rand(4, 3, 5, 5, requires_grad=True)
        w, b = torch.ones(3, requires_grad=True), torch.zeros(3, requires_grad=True)
        lin = torch.nn.Linear(2, 2)
        lin(torch.ones(1, 2)).sum().backward()
        mesh = type("Mesh", (), {"get_group": lambda self, axis: None})()
        with prof.recording() as session:
            y, _, _ = _SyncBatchNormFn.apply(x, w, b, 1e-5, None)
            y.sum().backward()
            grad_sync(mesh)(lin)
    finally:
        dist.destroy_process_group()
    names = [c.name for c in session.calls]
    assert names.count("dist/sync_bn") == 3  # two forward, one backward
    assert names.count("dist/grad_sync") == 1


def test_export_gives_the_graph_it_gives_without_spans(monkeypatch, serving):
    from equiadapt_tpu_torch.images.canonicalization import discrete_group
    from equiadapt_tpu_torch.pipelines import classification

    pipe, x = serving

    class Forward(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.pipe = pipe

        def forward(self, xb):
            return self.pipe(xb, training=False)[0]

    def graph():
        with torch.no_grad():
            return torch.export.export(Forward(), (x,)).graph_module.code

    with_spans = graph()
    for mod in (discrete_group, classification):
        monkeypatch.setattr(mod, "annotate", lambda *a, **k: contextlib.nullcontext())
    assert graph() == with_spans


def test_the_serving_cli_profiles_its_batches(tmp_path, capsys):
    out = serve.main(TINY + ["experiment.profile=true",
                             f"experiment.profile_dir={tmp_path}/prof"], device="cpu")
    text = capsys.readouterr().out
    assert out["images_per_s"] > 0
    assert "profile trace written to" in text and "idle by span:" in text
    assert "spans: name calls host_ms device_ms syncs" in text and "counters:" in text
    summary = prof.last_session().summary()
    assert set(summary) == SERVE_SPANS
    assert summary["pipeline"]["calls"] == serve.NUM_BATCHES
    assert list(tmp_path.glob("prof/trace_*.json"))


def test_threads_record_their_own_nesting_and_every_count():
    import sys
    import threading

    threads, rounds = 8, 200
    before = prof.counters().get("test/threads", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(rounds):
                with prof.annotate("train/step"):
                    with prof.annotate("train/backward"):
                        prof.count("test/threads")

        with prof.recording() as session:
            workers = [threading.Thread(target=work) for _ in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert prof.counters()["test/threads"] - before == threads * rounds
    assert len(session.calls) == 2 * threads * rounds
    for c in session.calls:
        if c.name == "train/backward":
            assert session.calls[c.parent].name == "train/step"
        else:
            assert c.parent == -1


def test_count_on_device_makes_a_deferred_count_only_while_recording():
    made = []

    def n():
        made.append(1)
        return torch.tensor([2, 3])

    before = prof.counters().get("test/on_device", 0)
    prof.count_on_device("test/on_device", n)
    assert made == [] and prof.counters().get("test/on_device", 0) == before
    with prof.recording():
        prof.count_on_device("test/on_device", n)
        prof.count_on_device("test/on_device", torch.tensor([1]))
    assert made == [1]
    assert prof.counters()["test/on_device"] - before == 6
