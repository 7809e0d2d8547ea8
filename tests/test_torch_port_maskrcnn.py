"""Mask R-CNN ResNet-50-FPN (`models.maskrcnn`), the plain versions of its
kernels (`ops.kernels.roi_align`, `ops.kernels.nms`) and
`ImageSegmentationPipeline.detect` against the benchmark's plain reference
(`benchmark/reference/maskrcnn_r50fpn_c4.py`), on the CPU: the published
widths at 128 px (min_size 128, so no resize), pre- and post-NMS top-n of
50 and 20 and 10 detections an image, a 3-layer C4 GCNN, on weights drawn
from a seed by the benchmark's own `data.make_weights` (the heads at the
configuration's scales, at which both caps bind).

Bars, fp32: the program and the reference compute the same products; the
order of some sums differs (channels-last against NCHW convolutions,
RoIAlign's sums, the paste as two products), which moves float32 by a few
units in the 7th digit of the largest value. So each part is held to 1e-5
of its largest value, and the NMS and every selection exactly, on the
program's own candidates (the reference's greedy loop on the same fp32
boxes and scores). The bf16 serving build is held by the benchmark's own
numbers (`benchmark/tests/test_bench_detect.py`).
"""

import copy
import json
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import check, data  # noqa: E402
from benchmark.reference import maskrcnn_r50fpn_c4 as ref  # noqa: E402
from benchmark.reference.common import fp32_only  # noqa: E402
from equiadapt_tpu_torch.cli import segmentation_serve  # noqa: E402
from equiadapt_tpu_torch.models import maskrcnn  # noqa: E402
from equiadapt_tpu_torch.ops.kernels import nms as tnms  # noqa: E402
from equiadapt_tpu_torch.ops.kernels import roi_align as tra  # noqa: E402
from equiadapt_tpu_torch.pipelines.segmentation import ImageSegmentationPipeline  # noqa: E402
from equiadapt_tpu_torch.utils import profiling  # noqa: E402
from equiadapt_tpu_torch.utils.config import Config  # noqa: E402
from equiadapt_tpu_torch.utils.registry import (  # noqa: E402
    get_image_canonicalization_network,
    get_image_canonicalizer,
    get_segmentation_prediction_network,
)
from torch_port_cpu import one_intra_op_thread  # noqa: E402, F401

SEED = 2 ** 33 + 77
SIZE, B = 128, 2
BAR = 1e-5
SMALL = {"min_size": SIZE, "rpn_pre_nms_top_n": 50, "rpn_post_nms_top_n": 20,
         "box_detections_per_img": 10}


def _settings():
    cfg = json.loads((ROOT / "benchmark" / "configs" / "maskrcnn-r50fpn-c4.json").read_text())
    s = copy.deepcopy(cfg["settings"])
    s["dataset"]["image_size"] = SIZE
    s["canonicalization"]["network_hyperparams"].update(num_layers=3, out_channels=4)
    s["canonicalization"]["resize_shape"] = 32
    s["maskrcnn"].update(SMALL)
    return s


S = _settings()


@pytest.fixture(autouse=True)
def _fp32():
    fp32_only()


@pytest.fixture(scope="module")
def weights():
    return data.make_weights(ref.param_spec(S), SEED, "cpu")


def _pipeline(weights) -> ImageSegmentationPipeline:
    """The fp32 pipeline: the configuration's canonicalizer without its
    bf16 casts, and Mask R-CNN in fp32."""
    cfg = Config.from_dict(S).override("canonicalization.compute_dtype=null",
                                       "canonicalization.output_dtype=null")
    shape = (SIZE, SIZE, 3)
    net = get_image_canonicalization_network(cfg.canonicalization, shape, device="cpu")
    canon = get_image_canonicalizer(cfg.canonicalization, net, shape, device="cpu")
    det = get_segmentation_prediction_network("maskrcnn_resnet50_fpn", SIZE, device="cpu",
                                              dtype=torch.float32, **S["maskrcnn"])
    pipe = ImageSegmentationPipeline(canon, det).eval()
    data.load_weights(pipe, weights)
    return pipe


def _images(i=0, b=B):
    return data.smooth_images(data.generator(SEED, f"pool{i}", "cpu"), b, SIZE)


@pytest.fixture(scope="module")
def served(weights):
    """One served batch with the detector's intermediates kept."""
    pipe = _pipeline(weights)
    pipe.prediction_network.keep = {}
    x = _images()
    with torch.no_grad():
        out, info = pipe.detect(x, return_probs=True)
    return pipe, x, out, info, pipe.prediction_network.keep


def _turns(info):
    return torch.round(info.element.rotation_deg / 90.0).long() % 4


def test_the_model_against_the_reference(weights, served):
    """Each part against the reference teacher-forced on the program's own
    intermediates; the NMS and every selection exact; the caps bind."""
    pipe, x, out, info, keep = served
    m = S["maskrcnn"]
    turns = _turns(info)
    c = ref.canonicalize(weights, x, S, follow=info.element.rotation_deg)
    assert torch.equal(c["turns"], turns.cpu())
    with torch.no_grad():
        canon_x, _ = pipe.canonicalizer(x, None, training=False)
        assert check.rel_max(canon_x, c["canonical"]) < BAR
        for b in range(B):
            t = ref.teacher(weights, canon_x[b:b + 1], S)
            for p, r in zip(keep["features"], t["features"]):
                assert check.rel_max(p[b:b + 1], r) < BAR
            for p, r in zip(keep["rpn_objectness"] + keep["rpn_deltas"],
                            t["rpn_objectness"] + t["rpn_deltas"]):
                assert check.rel_max(p[b:b + 1], r) < BAR
            # the RPN's NMS, level by level, and the first kept
            for lv in range(keep["rpn_boxes"].shape[1]):
                want = ref.segment_keep(keep["rpn_boxes"][b, lv], keep["rpn_scores"][b, lv],
                                        keep["rpn_valid"][b, lv], ref.RPN_NMS_THRESH)
                assert torch.equal(want, keep["rpn_keep"][b].reshape(-1, 50)[lv])
            order, kept = ref.first_kept(keep["rpn_keep"][b], keep["rpn_scores"][b].reshape(-1),
                                         m["rpn_post_nms_top_n"])
            assert bool(kept.all()), "the post-NMS cap binds"
            assert torch.equal(keep["proposals"][b], keep["rpn_boxes"][b].reshape(-1, 4)[order])
            # the box branch on the program's proposals
            logits, deltas = ref.box_branch(weights, t["features"], keep["proposals"][b], (SIZE, SIZE))
            N = m["rpn_post_nms_top_n"]
            assert check.rel_max(keep["class_logits"].reshape(B, N, -1)[b], logits) < BAR
            assert check.rel_max(keep["box_regression"].reshape(B, N, -1)[b], deltas) < BAR
            # the final NMS, class by class, and the first kept
            dk = keep["det_keep"][b].reshape(N, -1)
            for cl in range(dk.shape[1]):
                want = ref.segment_keep(keep["det_boxes"][b, :, cl], keep["det_scores"][b, :, cl],
                                        keep["det_valid"][b, :, cl], ref.BOX_NMS_THRESH)
                assert torch.equal(want, dk[:, cl])
            order, kept = ref.first_kept(keep["det_keep"][b], keep["det_scores"][b].reshape(-1),
                                         m["box_detections_per_img"])
            assert bool(kept.all()), "the detection cap binds"
            assert torch.equal(out["labels"][b], order % 90 + 1)
            # the masks: the reference's branch on the program's detections
            probs = ref.mask_probs(weights, t["features"], keep["boxes_resized"][b],
                                   out["labels"][b], out["valid"][b], (SIZE, SIZE))
            pasted = torch.rot90(ref.paste(probs, keep["boxes"][b], (SIZE, SIZE)),
                                 int(turns[b]), dims=(1, 2))
            assert (out["probs"][b] - pasted).abs().max() < BAR
            assert torch.equal(out["masks"][b], (out["probs"][b] > 0.5).to(torch.uint8))
            turned = ref.turn_back(keep["boxes"][b], int(turns[b]), SIZE)
            assert (out["boxes"][b] - turned).abs().max() < 1e-3


@pytest.mark.parametrize("n", [64, 7])
def test_nms_plain_against_the_greedy_loop(n):
    """Planted ties (equal scores, duplicate boxes) and empty segments:
    the plain version keeps exactly what the reference's loop keeps."""
    g = torch.Generator().manual_seed(n)
    S_, N = 6, n
    xy = torch.rand(S_, N, 2, generator=g) * 40
    wh = torch.rand(S_, N, 2, generator=g) * 20 + 1
    boxes = torch.cat([xy, xy + wh], -1)
    boxes[:, 1] = boxes[:, 0]  # a duplicate box
    scores = torch.rand(S_, N, generator=g)
    scores[:, 2] = scores[:, 3]  # a tie
    scores[:, 4:8] = 0.5  # a run of ties
    valid = torch.rand(S_, N, generator=g) > 0.2
    valid[4] = False  # an empty segment
    valid[5, 1:] = False  # a single box
    keep, counts = tnms.segment_nms(boxes, scores, valid, 0.5)
    assert torch.equal(counts, valid.sum(-1).int())
    for s in range(S_):
        want = ref.segment_keep(boxes[s], scores[s], valid[s], 0.5)
        assert torch.equal(keep[s], want), s
    assert not keep[4].any() and int(keep[5].sum()) == 1


def test_nms_suppresses_by_iou_above_the_threshold():
    boxes = torch.tensor([[[0.0, 0.0, 10.0, 10.0], [0.0, 0.0, 10.0, 5.0],
                           [0.0, 5.0, 10.0, 10.0], [20.0, 20.0, 30.0, 30.0]]])
    scores = torch.tensor([[0.9, 0.8, 0.7, 0.6]])
    valid = torch.ones(1, 4, dtype=torch.bool)
    # IoU of the first with the second and third is exactly 0.5: not above it
    keep, _ = tnms.segment_nms(boxes, scores, valid, 0.5)
    assert keep.tolist() == [[True, True, True, True]]
    keep, _ = tnms.segment_nms(boxes, scores, valid, 0.49)
    assert keep.tolist() == [[True, False, False, True]]


def _maps(g, dtype=torch.float32):
    return [torch.randn(2, 5, 32 // 2 ** i, 32 // 2 ** i, generator=g).to(dtype)
            for i in range(4)]


@pytest.mark.parametrize("sampling", [1, 2])
def test_roi_align_plain_against_the_sampling_formula(sampling):
    """Every level and the borders: regions past the map's edges (samples
    beyond -1 and the size read 0; the last row clamps), degenerate and
    sub-pixel regions."""
    g = torch.Generator().manual_seed(sampling)
    maps = _maps(g)
    image = (128, 128)
    scales = [0.25, 0.125, 0.0625, 0.03125]
    boxes = torch.tensor([[0.0, 0.0, 127.0, 127.0], [-20.0, -9.0, 30.0, 140.0],
                          [120.0, 120.0, 200.0, 131.0], [5.0, 5.0, 5.0, 5.0],
                          [10.3, 60.7, 10.9, 61.2], [-3.0, 100.0, 126.9, 127.9],
                          [60.0, 2.0, 70.0, 90.0], [0.5, 0.5, 3.5, 3.5]])
    R = boxes.shape[0]
    batch = torch.tensor([0, 1, 0, 1, 0, 1, 1, 0], dtype=torch.int32)
    for lv in range(4):
        level = torch.full((R,), lv, dtype=torch.int32)
        for P in (7, 14):
            got = tra.roi_align(maps, boxes, batch, level, scales, P, sampling)
            for r in range(R):
                want = ref.roi_align([maps[lv][batch[r]:batch[r] + 1]] * 4, boxes[r:r + 1],
                                     torch.tensor([lv]), image, P, sampling)
                assert (got[r] - want[0]).abs().max() < 1e-5, (lv, P, r)


def test_roi_align_bf16_rounds_the_fp32_sums_once():
    g = torch.Generator().manual_seed(5)
    maps = _maps(g, torch.bfloat16)
    boxes = torch.tensor([[3.0, 4.0, 90.0, 70.0], [40.0, 10.0, 60.0, 100.0]])
    idx = torch.tensor([0, 1], dtype=torch.int32)
    lv = torch.tensor([1, 2], dtype=torch.int32)
    got = tra.roi_align(maps, boxes, idx, lv, [0.25, 0.125, 0.0625, 0.03125], 7)
    want = tra.roi_align([m.float() for m in maps], boxes, idx, lv,
                         [0.25, 0.125, 0.0625, 0.03125], 7)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


def test_level_mapper_at_its_boundaries():
    """floor(4 + log2(sqrt(area) / 224) + 1e-6), clamped to 2-5: a box of
    side 224 * 2^k is on level 4 + k; a hair under it on the level below,
    within 1e-6 of a level's start on it; tiny and huge boxes clamp."""
    sides = [224.0, 112.0, 448.0, 56.0, 224.0 * (1 - 1e-4), 112.0 * (1 - 1e-4),
             448.0 * (1 - 1e-4), 224.0 * (1 - 1e-7), 1.0, 4000.0, 0.0]
    boxes = torch.tensor([[0.0, 0.0, s, s] for s in sides])
    want = [2, 1, 3, 0, 1, 0, 2, 2, 0, 3, 0]
    assert maskrcnn.level_of(boxes).tolist() == want
    assert ref.level_mapper(boxes).tolist() == want
    assert (ref.level_mapper(boxes, ("level_off_by_one",)) - torch.tensor(want)).max() == 1


def test_paste_against_the_per_box_loop():
    """The batched paste against torchvision's loop: boxes inside, across
    every edge, sub-pixel, degenerate (x2 < x1) and all outside."""
    g = torch.Generator().manual_seed(3)
    masks = torch.rand(1, 9, 28, 28, generator=g)
    boxes = torch.tensor([[[10.0, 20.0, 60.0, 50.0], [-15.0, -8.0, 30.0, 40.0],
                           [100.0, 90.0, 140.0, 160.0], [50.2, 50.7, 50.9, 51.1],
                           [30.0, 30.0, 20.0, 40.0], [200.0, 200.0, 230.0, 260.0],
                           [0.0, 0.0, 127.0, 127.0], [-40.0, -40.0, -20.0, -30.0],
                           [5.5, 70.25, 90.75, 71.0]]])
    got = maskrcnn.paste_masks(masks, boxes, (128, 96))
    want = ref.paste(masks[0], boxes[0], (128, 96))
    assert got.shape == (1, 9, 128, 96)
    assert (got[0] - want).abs().max() < 1e-6


def test_detect_inverts_boxes_and_masks_for_each_element(weights):
    """The batch turned by each quarter turn: the canonicalizer undoes the
    turn (its element moves by it), the detector sees the same canonical
    image, and detect's input-frame boxes and masks turn with the input."""
    pipe = _pipeline(weights)
    x = _images(1, 1)
    outs = []
    with torch.no_grad():
        for k in range(4):
            out, info = pipe.detect(torch.rot90(x, k, dims=(1, 2)), return_probs=True)
            outs.append((out, int(_turns(info)[0])))
    base, t0 = outs[0]
    assert base["valid"].all()
    for k, (out, t) in enumerate(outs):
        assert t == (t0 + k) % 4
        assert torch.equal(out["labels"], base["labels"])
        assert (out["scores"] - base["scores"]).abs().max() < 1e-5
        turned = ref.turn_back(base["boxes"][0], k, SIZE)
        assert (out["boxes"][0] - turned).abs().max() < 1e-2
        assert (out["probs"] - torch.rot90(base["probs"], k, dims=(2, 3))).abs().max() < 1e-4


def _torchvision_state_dict(newer: bool):
    """A state dict under torchvision's names, written out here from its
    module tree (`maskrcnn_resnet50_fpn`): the published checkpoint's names,
    or with `newer` those of torchvision's Conv2dNormActivation wrappers."""
    g = torch.Generator().manual_seed(11)
    sd = {}
    for name, shape, _ in ref.param_spec(S):
        if name.startswith("prediction_network."):
            sd[name[len("prediction_network."):]] = torch.randn(shape, generator=g)
    if newer:
        ren = {}
        for k in sd:
            n = k
            for i in range(4):
                n = n.replace(f"fpn.inner_blocks.{i}.", f"fpn.inner_blocks.{i}.0.")
                n = n.replace(f"fpn.layer_blocks.{i}.", f"fpn.layer_blocks.{i}.0.")
                n = n.replace(f"mask_head.mask_fcn{i + 1}.", f"mask_head.{i}.0.")
            n = n.replace("rpn.head.conv.", "rpn.head.conv.0.0.")
            ren[n] = sd[k]
        sd = ren
    return sd


@pytest.mark.parametrize("newer", [False, True], ids=["checkpoint_names", "newer_names"])
def test_a_torchvision_state_dict_round_trips(newer):
    net = maskrcnn.MaskRCNN(device="cpu")
    sd = _torchvision_state_dict(newer)
    net.load_state_dict(sd, strict=True)
    back = net.state_dict()
    want = _torchvision_state_dict(False)
    assert set(back) == set(want)
    for k, v in want.items():
        assert torch.equal(back[k], v), k
    assert not any(k.endswith("num_batches_tracked") for k in back)
    assert sum(v.numel() for v in back.values()) == pytest.approx(44.4e6, rel=0.01)


def test_registry_and_dtype():
    net = get_segmentation_prediction_network("maskrcnn_resnet50_fpn", 64, device="meta",
                                              dtype=torch.bfloat16)
    assert isinstance(net, maskrcnn.MaskRCNN) and net.dtype == torch.bfloat16
    lite = get_segmentation_prediction_network("sam", 64, device="cpu", dtype=torch.bfloat16)
    assert not hasattr(lite, "dtype") or lite.dtype != torch.bfloat16


def test_spans_and_counters(weights, monkeypatch):
    made, pairs = [], maskrcnn._pairs
    monkeypatch.setattr(maskrcnn, "_pairs", lambda c: made.append(1) or pairs(c))
    pipe = _pipeline(weights)
    x = _images(2, 1)
    before = profiling.counters()
    with torch.no_grad(), profiling.recording() as session:
        pipe.detect(x)
    rows = session.summary()
    for span in ("pipeline", "canon", "predict", "maskrcnn/backbone", "maskrcnn/rpn",
                 "maskrcnn/roi_heads", "maskrcnn/box_head", "maskrcnn/mask_head",
                 "maskrcnn/paste", "canon/invert"):
        assert rows[span]["calls"] == 1, span
    assert rows["maskrcnn/nms"]["calls"] == 2
    assert rows["maskrcnn/roi_align"]["calls"] == 2
    after = profiling.counters()
    got = {k: after[k] - before.get(k, 0) for k in after if k.startswith("maskrcnn/")}
    assert got["maskrcnn/proposals"] == 20 and got["maskrcnn/detections"] == 10
    assert got["maskrcnn/nms_pairs"] > 0 and got["maskrcnn/nms_candidates"] > 20
    assert len(made) == 2  # the pairs of the RPN's NMS and of the final one
    with torch.no_grad():  # off the recorder, nothing counts, and no pair count is made
        pipe.detect(x)
    assert profiling.counters()["maskrcnn/proposals"] == after["maskrcnn/proposals"]
    assert len(made) == 2


def test_the_published_settings_are_the_references():
    for name in ("MAX_SIZE", "RPN_NMS_THRESH", "RPN_MIN_SIZE", "BOX_SCORE_THRESH",
                 "BOX_NMS_THRESH", "BOX_MIN_SIZE"):
        assert getattr(maskrcnn, name) == getattr(ref, name), name
    net = maskrcnn.MaskRCNN(device="meta")
    assert (net.num_classes, net.min_size, net.rpn_pre_nms_top_n, net.rpn_post_nms_top_n,
            net.detections) == (91, 800, 1000, 1000, 100)


def test_the_serving_cli_on_the_cpu(monkeypatch, capsys):
    build = segmentation_serve.get_segmentation_prediction_network

    def small(arch, size, **kw):  # the CLI's model at this file's caps and size
        return build(arch, size, **dict(kw, **dict(SMALL, min_size=size)))

    monkeypatch.setattr(segmentation_serve, "get_segmentation_prediction_network", small)
    monkeypatch.setattr(segmentation_serve, "NUM_BATCHES", 2)
    res = segmentation_serve.main(["prediction.architecture=maskrcnn_resnet50_fpn",
                                   "dataset.image_size=64", "experiment.batch_size=2"],
                                  device="cpu")
    assert res["images_per_s"] > 0
    assert isinstance(res["pipeline"].prediction_network, maskrcnn.MaskRCNN)
    assert res["pipeline"].prediction_network.dtype == torch.bfloat16
    assert "detections" in capsys.readouterr().out


def test_the_anchors_are_torchvisions():
    base = maskrcnn.base_anchors(32)
    assert base.tolist() == [[-23.0, -11.0, 23.0, 11.0], [-16.0, -16.0, 16.0, 16.0],
                             [-11.0, -23.0, 11.0, 23.0]]
    grid = maskrcnn.grid_anchors(base, (2, 3), (800, 800))
    assert grid.shape == (18, 4)
    assert grid[3].tolist() == [266.0 - 23.0, -11.0, 266.0 + 23.0, 11.0]  # stride 800 // 3
    feats = [torch.empty(1, 1, 200 // 2 ** i, 200 // 2 ** i) for i in range(4)]
    feats.append(torch.empty(1, 1, 13, 13))  # P6: stride 800 // 13 = 61, as torchvision
    mine = [maskrcnn.grid_anchors(maskrcnn.base_anchors(s), tuple(f.shape[-2:]), (800, 800))
            for s, f in zip(maskrcnn.ANCHOR_SIZES, feats)]
    for a, b in zip(mine, ref.anchors(feats, (800, 800))):
        assert torch.equal(a, b)
    assert math.isclose(maskrcnn.BBOX_CLIP, math.log(62.5))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the H100")
    return "cuda"


@pytest.mark.card
def test_the_served_detector_makes_no_host_sync(card):
    """The detect cell's configuration on the card: after a warm-up call,
    Mask R-CNN and the paste of a batch of 8 at 1024 px run under
    `torch.cuda.set_sync_debug_mode("error")`, which raises at any
    synchronizing call."""
    cfg = json.loads((ROOT / "benchmark" / "configs" / "maskrcnn-r50fpn-c4.json").read_text())
    s = cfg["settings"]
    pipe = segmentation_serve.build_serving_pipeline(Config.from_dict(s), card, **s["maskrcnn"])
    data.load_weights(pipe, data.make_weights(ref.param_spec(s), SEED, card))
    x = data.smooth_images(data.generator(SEED, "pool0", card), 8, s["dataset"]["image_size"])
    net = pipe.prediction_network
    with torch.no_grad():
        pipe.detect(x)
        images_c, _ = pipe.canonicalizer(x, None, training=False)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            det = net(images_c)
            probs = net.paste_masks(det["mask_probs"], det["boxes"], tuple(x.shape[1:3]))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    assert probs.shape == (8, 100, 1024, 1024)
    assert bool(det["valid"].all())
