"""The `detect` driver, its work counts and the readers of the
`maskrcnn-r50fpn-c4.detect` cell.

Importing this module adds the cell's twelve metrics to
`test_bench_metrics.EXPECTED`, so that `test_every_metric_is_tested` finds
them there; their arithmetic is tested here, on a record and a session the
test builds. A run of the driver on a CPU cut of the cell (128 px, so that
regions reach three pyramid levels; pre- and post-NMS top-n of 30 and 12,
6 detections, a 3-layer C4 GCNN, batches of 2) is `correct` on the sound
program and not with its masks altered, its element altered, its RoIAlign
sampled once a bin, its levels one up or its final NMS at another
threshold; the fp8 control and the planted faults of the reference fail."""

import copy
import math
import time

import pytest
import torch

import test_bench_metrics
from benchmark.harness import cell as cells
from benchmark.harness import check, data, detect, detect_work
from benchmark.reference import maskrcnn_r50fpn_c4 as mref
from equiadapt_tpu_torch.models import maskrcnn
from equiadapt_tpu_torch.utils import profiling

CELL = "maskrcnn-r50fpn-c4.detect"
SEED = 3_000_000_061  # over 32 signed bits

DETECT = {
    "mode": "detect", "batch": 8, "spans_ms": {},
    "trace": {"iterations": 4, "window_s": 1.0, "busy_s": 0.8},
    "work": {"flops_per_iter": 2.0e12, "roi_align_bytes": 6.7e8, "nms_pair_flops": 13},
    "counters": {"maskrcnn/nms_pairs": 1.0e8},
    "peaks": {"bf16_flops": 1.0e15, "hbm_bytes": 3.35e12, "fp32_flops": 6.7e13},
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
    for syncs in (20, 22):
        top = len(calls)
        calls += [("pipeline", -1, 70.0, 90.0, 0), ("canon", top, 5.0, 12.0, syncs),
                  ("predict", top, 50.0, 70.0, 0)]
        mr = top + 2
        calls += [("maskrcnn/backbone", mr, 10.0, 30.0, 0), ("maskrcnn/rpn", mr, 5.0, 6.0, 0)]
        calls += [("maskrcnn/nms", len(calls) - 1, 1.0, 0.5, 0)]
        heads = len(calls)
        calls += [("maskrcnn/roi_heads", mr, 8.0, 20.0, 0),
                  ("maskrcnn/roi_align", heads, 1.0, 1.5, 0),
                  ("maskrcnn/box_head", heads, 1.0, 3.0, 0),
                  ("maskrcnn/nms", heads, 1.0, 1.5, 0),
                  ("maskrcnn/roi_align", heads, 1.0, 0.5, 0),
                  ("maskrcnn/mask_head", heads, 1.0, 4.0, 0),
                  ("maskrcnn/paste", mr, 1.0, 2.0, 0),
                  ("canon/warp", top + 1, 0.5, 1.0 + syncs / 20, 0),
                  ("canon/invert", top, 1.0, 9.0, 0)]
    for i, (name, parent, host, dev, syncs) in enumerate(calls):
        s.calls.append(profiling.SpanCall(name, i, parent, begin_ns=0, end_ns=int(host * 1e6),
                                          syncs=syncs, events=(Event(0.0), Event(dev))))
    s.open = False
    return s


DETECT_EXPECTED = {
    "step_mfu_pct.detect": (DETECT, 100.0 * 2.0e12 * 4 / 1.0e15),
    "device_idle_pct.detect": (DETECT, 20.0),
    "canon_ms.detect": (DETECT, 12.0),
    "backbone_ms.detect": (DETECT, 30.0),
    "rpn_ms.detect": (DETECT, 6.0),
    "roi_heads_ms.detect": (DETECT, 20.0),
    "nms_ms.detect": (DETECT, 1.0),
    "paste_ms.detect": (DETECT, 2.0),
    # 6.7e8 B at 3.35e12 B/s = 0.2 ms, over a mean of 1 ms a call
    "roi_align_roofline.detect": (DETECT, 20.0),
    # 1e8 pairs x 13 FLOP at 6.7e13 FLOP/s over 4 calls of 1 ms
    "nms_roofline.detect": (DETECT, 100.0 * 1.0e8 * 13 / 4e-3 / 6.7e13),
    "host_syncs.detect": (DETECT, 21.0),
    "pipeline_host_ms.detect": (DETECT, 70.0),
    "canon_warp_ms.detect": (DETECT, 2.05),  # 2.0 and 2.1
    "canon_invert_ms.detect": (DETECT, 9.0),
}
test_bench_metrics.EXPECTED.update(DETECT_EXPECTED)


@pytest.fixture
def recorded(monkeypatch):
    s = session()
    monkeypatch.setattr(profiling, "last_session", lambda: s)
    return s


@pytest.mark.parametrize("name", sorted(DETECT_EXPECTED))
def test_reader(name, recorded):
    record, want = DETECT_EXPECTED[name]
    reader = cells.metric_reader(name)
    assert reader.read(record) == pytest.approx(want, rel=1e-12)
    assert reader.read(test_bench_metrics.SERVE) is None
    assert reader.read(test_bench_metrics.TRAIN) is None
    assert reader.read({"mode": "detect"}) is None  # not traced


@pytest.mark.parametrize("name", sorted(DETECT_EXPECTED))
def test_reader_finds_nothing_without_the_spans(name, monkeypatch):
    """On the parent's program (no `maskrcnn/*` spans, or no recorder) the
    span readers report nothing and raise nothing."""
    record, _ = DETECT_EXPECTED[name]
    monkeypatch.setattr(profiling, "last_session", lambda: profiling.Session())
    value = cells.metric_reader(name).read(record)
    assert value is None or name in ("step_mfu_pct.detect", "device_idle_pct.detect")
    monkeypatch.delattr(profiling, "last_session")
    value = cells.metric_reader(name).read(record)
    assert value is None or name in ("step_mfu_pct.detect", "device_idle_pct.detect")


def test_manifest_entries():
    import json

    manifest = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in manifest["per_layer"]}
    for name in DETECT_EXPECTED:
        assert entries[name]["workloads"] == [CELL]
        assert entries[name]["moves"] == "serve_img_per_s"
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert CELL in e2e["serve_img_per_s"]["workloads"]
    assert CELL in e2e["serve_p95_ms"]["workloads"]
    config = {c["name"]: c for c in manifest["configs"]}["maskrcnn-r50fpn-c4"]
    assert config["reduced"] == []


def tiny_cell(size=128):
    c = cells.resolve(CELL)
    c.config = copy.deepcopy(c.config)
    s = c.config["settings"]
    s["dataset"]["image_size"] = size
    s["canonicalization"]["network_hyperparams"].update(num_layers=3, out_channels=4)
    s["canonicalization"]["resize_shape"] = 32
    s["maskrcnn"].update(min_size=size, rpn_pre_nms_top_n=30, rpn_post_nms_top_n=12,
                         box_detections_per_img=6)
    c.traffic = dict(c.traffic, batch_size=2, pool=3, sample_batches=3, capture_batches=1,
                     capture_within=2, trace_iterations=2)
    return c


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(c, control=False, traced=False):
    res = c.driver().run(c, SEED, 0.5, traced, "cpu", time.perf_counter(), control=control)
    res["correct"] = check.verdict(res["numbers"], c.limits) and res["failed"] == 0
    return res


def broken_build(monkeypatch, fn):
    """detect.build_pipeline with `fn(pipe)` applied to what it returns."""
    build = detect.build_pipeline

    def patched(*args, **kwargs):
        pipe = build(*args, **kwargs)
        fn(pipe)
        return pipe

    monkeypatch.setattr(detect, "build_pipeline", patched)


def alter_masks(pipe):
    def hook(_m, _inp, out):
        out["mask_probs"] = (out["mask_probs"] + 0.2).clamp(max=1.0)
        return out
    pipe.prediction_network.register_forward_hook(hook)


def alter_element(pipe):
    def hook(_m, _inp, out):
        x, info = out
        el = info.element
        el.rotation_deg = el.rotation_deg.clone()
        el.rotation_deg[0] = (el.rotation_deg[0] + 90.0) % 360.0
        return x, info
    pipe.canonicalizer.register_forward_hook(hook)


def sampling_once(monkeypatch):
    align = maskrcnn.roi_ops.roi_align
    monkeypatch.setattr(maskrcnn.roi_ops, "roi_align",
                        lambda *a: align(*a[:-1], 1))


def level_up(monkeypatch):
    level = maskrcnn.level_of
    monkeypatch.setattr(maskrcnn, "level_of",
                        lambda b, k_min=2, k_max=5: torch.clamp(level(b, k_min, k_max) + 1,
                                                                max=k_max - k_min))


def final_nms_at_0_3(monkeypatch):
    nms = maskrcnn._nms
    monkeypatch.setattr(maskrcnn, "_nms",
                        lambda b, s, v, thr: nms(b, s, v, 0.3 if thr == 0.5 else thr))


def test_detect_sound_and_traced():
    c = tiny_cell()
    res = run(c, traced=True)
    assert res["correct"], res["numbers"]
    assert res["numbers"]["nms_mismatch"] == 0
    assert res["attempted"] == 2 * res["iterations"] and res["e2e"]["serve_img_per_s"] > 0
    rec = res["record"]
    assert rec["work"]["roi_align_bytes"] > 0 and rec["work"]["flops_per_iter"] > 0
    assert rec["counters"]["maskrcnn/proposals"] == 2 * 12 * rec["trace"]["iterations"]
    assert rec["counters"]["maskrcnn/detections"] == 2 * 6 * rec["trace"]["iterations"]


@pytest.mark.parametrize("fault", [alter_masks, alter_element],
                         ids=["masks_altered", "element_altered"])
def test_detect_fault(monkeypatch, fault):
    broken_build(monkeypatch, fault)
    res = run(tiny_cell())
    assert not res["correct"], res["numbers"]


@pytest.fixture(scope="module")
def sound():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return run(tiny_cell())["numbers"]
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("fault,number", [(sampling_once, "cls_err"), (level_up, "cls_err"),
                                          (final_nms_at_0_3, "nms_mismatch")],
                         ids=["roi_align_sr1", "level_off_by_one", "final_nms_threshold"])
def test_detect_program_fault(monkeypatch, sound, fault, number):
    """A fault in the program's own RoI heads moves its number well past the
    sound program's at this size (at the cell's size, past its limit:
    PERF.md §2); a wrong NMS past the exact limit."""
    fault(monkeypatch)
    res = run(tiny_cell())
    if number == "nms_mismatch":
        assert res["numbers"][number] > 0 and not res["correct"], res["numbers"]
    else:
        assert res["numbers"][number] > 3 * sound[number], (res["numbers"], sound)


def test_detect_control_and_planted_faults_fail():
    c = tiny_cell()
    res = run(c, control=True)
    assert not check.verdict(res["control"], c.limits), res["control"]
    for name in detect.FAULTS:
        numbers = dict(res["numbers"], **res["fault"][name])
        assert not check.verdict(numbers, c.limits), (name, res["fault"][name])


def test_reference_names_are_the_programs():
    c = tiny_cell(64)
    pipe = detect.build_pipeline(c.settings, "cpu")
    state = {k: tuple(v.shape) for k, v in pipe.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    spec = {name: tuple(shape) for name, shape, _ in c.reference().param_spec(c.settings)}
    assert spec == state
    full = cells.resolve(CELL)
    meta = detect.build_pipeline(full.settings, "meta")
    names = {k for k in meta.state_dict() if not k.endswith("num_batches_tracked")}
    assert {n for n, _, _ in full.reference().param_spec(full.settings)} == names
    data.make_weights(c.reference().param_spec(c.settings), SEED, "cpu")  # every init kind


def test_flop_count_against_closed_forms():
    """The heads' FLOPs against their closed forms, and the whole count at
    the cell's shapes."""
    full = cells.resolve(CELL)
    s = full.settings
    got = detect_work.count_flops(mref, s, 8)
    w = {n: torch.empty(shape, device="meta") for n, shape, _ in mref.param_spec(s)}
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        mref.box_head(w, torch.empty(1000, 256, 7, 7, device="meta"))
    assert fc.get_total_flops() == 2 * 1000 * (12544 * 1024 + 1024 * 1024 + 1024 * 91
                                               + 1024 * 364)
    with FlopCounterMode(display=False) as fc:
        mref.rpn_head(w, [torch.empty(1, 256, 200, 200, device="meta")])
    assert fc.get_total_flops() == 2 * 200 * 200 * 256 * (256 * 9 + 3 + 12)
    assert got["flops_per_iter"] == got["canon_flops"] + 8 * got["image_flops"]
    # ResNet-50 at 800 px alone is about 52 GMAC: the image's detector is more
    assert 2 * 52e9 < got["image_flops"] < 2 * 260e9


def test_roi_align_bytes_counts_each_pixel_once():
    """One region at P2 of an 800 px image: its samples' taps name a
    rectangle of pixels once each, whatever their overlaps."""
    boxes = torch.tensor([[[16.0, 16.0, 72.0, 44.0]]])  # 56 x 28 px: level 2
    maps = [(200, 200), (100, 100), (50, 50), (25, 25)]
    got = detect_work.roi_align_bytes(boxes, maps, (800, 800), 7, 2, 256, "bfloat16")
    # x: 14 samples over [4, 18] at P2 -> taps 4-18 (15 columns); y: [4, 11] -> 4-11
    assert got == (15 * 8 + 7 * 7) * 256 * 2
    twice = detect_work.roi_align_bytes(boxes.repeat(1, 2, 1), maps, (800, 800), 7, 2, 256,
                                        "bfloat16")
    assert twice == (15 * 8 + 2 * 7 * 7) * 256 * 2


@pytest.mark.card
def test_detect_on_card(card):
    """The cell at its own size on the card: correct, the control and every
    planted fault over the limits."""
    c = cells.resolve(CELL)
    res = c.driver().run(c, 2 ** 31 + 13, 2.0, False, card, time.perf_counter(), control=True)
    assert check.verdict(res["numbers"], c.limits), res["numbers"]
    assert not check.verdict(res["control"], c.limits), res["control"]
    for name in detect.FAULTS:
        assert not check.verdict(dict(res["numbers"], **res["fault"][name]), c.limits)
    assert not math.isinf(res["numbers"]["mask_err"])
