"""The `segment` driver and the readers of the `sam-vitb-c4.segment` cell.

Importing this module adds the cell's twelve metrics to
`test_bench_metrics.EXPECTED`, so that `test_every_metric_is_tested` finds
them there; their arithmetic is tested here, on a record and a session the
test builds. A run of the driver on a tiny CPU cut of the cell (64 px, patch
8, one windowed and one global block, a 3-layer C4 GCNN, batches of 2 with
3 boxes) is `correct` on the sound program and not with its mask logits
altered, its element altered or its relative-position bias dropped; the
fp8 control fails."""

import copy
import time

import pytest
import torch

import test_bench_metrics
from benchmark.harness import cell as cells
from benchmark.harness import check, data, segment
from equiadapt_tpu_torch.utils import profiling

CELL = "sam-vitb-c4.segment"
SEED = 3_000_000_041  # over 32 signed bits

SEGMENT = {
    "mode": "segment", "batch": 8, "spans_ms": {},
    "trace": {"iterations": 4, "window_s": 1.0, "busy_s": 0.9},
    "work": {"flops_per_iter": 1.0e13, "global_attn_flops": 4.0e11},
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
    """Two served batches: (name, parent, host ms, device ms, own syncs)
    per call."""
    s = profiling.Session()
    calls = []
    for syncs in (3, 1):
        top = len(calls)
        calls += [("pipeline", -1, 60.0, 70.0, 0), ("canon", top, 5.0, 10.0, syncs),
                  ("predict", top, 40.0, 55.0, 0)]
        enc = len(calls)
        calls += [("sam/encoder", top + 2, 30.0, 45.0, 0),
                  ("sam/attn/window", enc, 1.0, 1.5, 0), ("sam/attn/window", enc, 1.0, 2.5, 0),
                  ("sam/attn/global", enc, 2.0, 8.0, 0), ("sam/decoder", top + 2, 3.0, 4.0, 1),
                  ("canon/warp", top + 1, 0.5, 1.25, 0), ("canon/invert", top, 0.25, 0.75, 0)]
    for i, (name, parent, host, dev, syncs) in enumerate(calls):
        s.calls.append(profiling.SpanCall(name, i, parent, begin_ns=0, end_ns=int(host * 1e6),
                                          syncs=syncs, events=(Event(0.0), Event(dev))))
    s.open = False
    return s


SEGMENT_EXPECTED = {
    "step_mfu_pct.segment": (SEGMENT, 100.0 * 1.0e13 * 4 / 1.0e15),
    "device_idle_pct.segment": (SEGMENT, 10.0),
    "canon_ms.segment": (SEGMENT, 10.0),
    "sam_encoder_ms.segment": (SEGMENT, 45.0),
    "global_attn_ms.segment": (SEGMENT, 8.0),
    "window_attn_ms.segment": (SEGMENT, 2.0),
    # 4e11 FLOP in 8 ms at 1e15 FLOP/s
    "global_attn_roofline.segment": (SEGMENT, 100.0 * 4.0e11 / 8e-3 / 1.0e15),
    "sam_decoder_ms.segment": (SEGMENT, 4.0),
    "host_syncs.segment": (SEGMENT, 3.0),  # (3 + 1) and (1 + 1)
    "canon_warp_ms.segment": (SEGMENT, 1.25),
    "canon_invert_ms.segment": (SEGMENT, 0.75),
    "pipeline_host_ms.segment": (SEGMENT, 60.0),
}
test_bench_metrics.EXPECTED.update(SEGMENT_EXPECTED)


@pytest.fixture
def recorded(monkeypatch):
    s = session()
    monkeypatch.setattr(profiling, "last_session", lambda: s)
    return s


@pytest.mark.parametrize("name", sorted(SEGMENT_EXPECTED))
def test_reader(name, recorded):
    record, want = SEGMENT_EXPECTED[name]
    reader = cells.metric_reader(name)
    assert reader.read(record) == pytest.approx(want, rel=1e-12)
    assert reader.read(test_bench_metrics.SERVE) is None
    assert reader.read(test_bench_metrics.TRAIN) is None
    assert reader.read({"mode": "segment"}) is None  # not traced


@pytest.mark.parametrize("name", sorted(SEGMENT_EXPECTED))
def test_reader_finds_nothing_without_the_spans(name, monkeypatch):
    """On the parent's program (no `sam/*` spans, or no recorder) the span
    readers report nothing and raise nothing."""
    record, _ = SEGMENT_EXPECTED[name]
    monkeypatch.setattr(profiling, "last_session", lambda: profiling.Session())
    value = cells.metric_reader(name).read(record)
    assert value is None or name in ("step_mfu_pct.segment", "device_idle_pct.segment")
    monkeypatch.delattr(profiling, "last_session")
    value = cells.metric_reader(name).read(record)
    assert value is None or name in ("step_mfu_pct.segment", "device_idle_pct.segment")


def test_manifest_entries():
    import json

    manifest = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in manifest["per_layer"]}
    for name in SEGMENT_EXPECTED:
        assert entries[name]["workloads"] == [CELL]
        assert entries[name]["moves"] == "serve_img_per_s"
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert CELL in e2e["serve_img_per_s"]["workloads"]
    assert CELL in e2e["serve_p95_ms"]["workloads"]


def tiny_cell():
    c = cells.resolve(CELL)
    c.config = copy.deepcopy(c.config)
    s = c.config["settings"]
    s["dataset"]["image_size"] = 64
    s["canonicalization"]["network_hyperparams"].update(num_layers=3, out_channels=4)
    s["canonicalization"]["resize_shape"] = 32
    s["sam"] = {"encoder": {"patch_size": 8, "embed_dim": 48, "depth": 2, "num_heads": 3,
                            "window_size": 3, "global_attn_indexes": [1], "mlp_ratio": 4.0},
                "prompt_dim": 32, "decoder_depth": 2, "decoder_heads": 2, "decoder_mlp": 64,
                "num_mask_tokens": 4, "iou_hidden": 32}
    c.traffic = dict(c.traffic, batch_size=2, prompts=3, box_min=4, box_max=48, pool=3,
                     sample_batches=3, capture_batches=1, capture_within=2, trace_iterations=2)
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


def broken_build(monkeypatch, fn):
    """segment.build_pipeline with `fn(pipe)` applied to what it returns."""
    build = segment.build_pipeline

    def patched(*args, **kwargs):
        pipe = build(*args, **kwargs)
        fn(pipe)
        return pipe

    monkeypatch.setattr(segment, "build_pipeline", patched)


def alter_masks(pipe):
    def hook(_m, _inp, out):
        masks, iou = out
        masks = masks.clone()
        masks[0, 0] += masks.abs().max()
        return masks, iou
    pipe.prediction_network.register_forward_hook(hook)


def alter_element(pipe):
    def hook(_m, _inp, out):
        x, targets, info = out
        el = info.element
        el.rotation_deg = el.rotation_deg.clone()
        el.rotation_deg[0] = (el.rotation_deg[0] + 90.0) % 360.0
        return x, targets, info
    pipe.canonicalizer.register_forward_hook(hook)


def drop_rel_pos(pipe):
    for block in pipe.prediction_network.image_encoder.blocks:
        block.attn.use_rel_pos = False


def test_segment_sound():
    res = run(tiny_cell())
    assert res["correct"], res["numbers"]
    assert res["attempted"] == 2 * res["iterations"] and res["e2e"]["serve_img_per_s"] > 0


@pytest.mark.parametrize("fault", [alter_masks, alter_element, drop_rel_pos],
                         ids=["masks_altered", "element_altered", "rel_pos_dropped"])
def test_segment_fault(monkeypatch, fault):
    broken_build(monkeypatch, fault)
    res = run(tiny_cell())
    assert not res["correct"], res["numbers"]


def test_segment_control_fails():
    c = tiny_cell()
    res = run(c, control=True)
    assert not check.verdict(res["control"], c.limits), res["control"]
    for name in segment.FAULTS:
        assert res["fault"][name]["mask_err"] > c.limits["mask_err"], res["fault"]


def test_reference_names_are_the_programs():
    c = tiny_cell()
    pipe = segment.build_pipeline(c.settings, "cpu")
    state = {k: tuple(v.shape) for k, v in pipe.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    spec = {name: tuple(shape) for name, shape, _ in c.reference().param_spec(c.settings)}
    assert spec == state
    full = cells.resolve(CELL)
    meta = segment.build_pipeline(full.settings, "meta")
    names = {k for k in meta.state_dict() if not k.endswith("num_batches_tracked")}
    assert {n for n, _, _ in full.reference().param_spec(full.settings)} == names
    data.make_weights(c.reference().param_spec(c.settings), SEED, "cpu")  # every init kind


@pytest.mark.card
def test_segment_on_card(card):
    """The cell at its own size on the card: correct, the control and both
    planted faults over the limits."""
    c = cells.resolve(CELL)
    res = c.driver().run(c, 2 ** 31 + 11, 2.0, False, card, time.perf_counter(), control=True)
    assert check.verdict(res["numbers"], c.limits), res["numbers"]
    assert not check.verdict(res["control"], c.limits), res["control"]
    for name in segment.FAULTS:
        assert not check.verdict(dict(res["numbers"], **res["fault"][name]), c.limits)
