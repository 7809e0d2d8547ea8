"""The port's segmentation path (BASELINE config 5) against the JAX package:
the box / mask transforms, the discrete canonicalizer's targets branch, the
rectangles data, the losses, the mAP metrics, ViT, the three SAMLite parts,
SAM's ViT encoder, both SAMLite encoders, the pipeline, one train step, the
group sweep, the SAM checkpoint converters and the loader's new leaves.

Both sides get the same numpy inputs; Flax variables are carried across by
`load_flax_variables`, with every bias, LayerNorm scale, relative-position
table and CLS token redrawn from a numpy seed (Flax starts the last two at
zero), so a leaf carried to the wrong place shows. The JAX side runs on the
CPU, where `rotate_select` takes its plain formulation; the port takes the
plain version of K1 on CPU tensors. Bars (fp32): the same selected
elements; eval-warped masks bit-equal; boxes within 1e-4 px; the one-hot
warp blend (training) within 1e-6; single modules within 1e-5, stacks of
LayerNorms and attention within 1e-4 (Flax's LayerNorm variance is
E[x^2] - E[x]^2, torch's a two-pass one); mAP equal to JAX's within 1e-6
(the JAX tests' bar against their numpy reference) and to the hand-derived
values of tests/test_segmentation.py; the converters' tensors
`torch.equal`. A train step: the loss within 1e-5 relative, each gradient
within 1e-4 of the largest gradient element, the first AdamW update within
1e-6 where |g| > 1e-3 max |g| (tests/test_torch_port_nbody.py's bars).
"""

import copy
import functools
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from equiadapt_tpu.data import coco as jcoco
from equiadapt_tpu.images import (
    EquivariantNetwork as JNet,
    GroupEquivariantImageCanonicalization as JCanon,
)
from equiadapt_tpu.models import sam_convert as jconv
from equiadapt_tpu.models import sam_encoder as jsam
from equiadapt_tpu.models import segmentation as jseg
from equiadapt_tpu.models import vit as jvit
from equiadapt_tpu.ops import boxes as jboxes
from equiadapt_tpu.pipelines import segmentation as jpipe
from equiadapt_tpu.utils import registry as jreg
import equiadapt_tpu_torch as tp
from equiadapt_tpu_torch.data import coco as tcoco
from equiadapt_tpu_torch.models import sam_convert as tconv
from equiadapt_tpu_torch.models import sam_encoder as tsam
from equiadapt_tpu_torch.models import segmentation as tseg
from equiadapt_tpu_torch.models import vit as tvit
from equiadapt_tpu_torch.ops import boxes as tboxes
from equiadapt_tpu_torch.pipelines import segmentation as tpipe
from equiadapt_tpu_torch.utils import registry as treg
from equiadapt_tpu_torch.utils.jax_weights import flax_placements

KEY = jax.random.key(0)
TOL = dict(rtol=1e-5, atol=1e-5)
DEEP = dict(rtol=1e-4, atol=1e-4)
REDRAWN = ("rel_pos_h", "rel_pos_w", "cls_token")


def numpy_variables(variables, seed=0):
    """Flax variables as nested dicts of numpy arrays, with biases, LayerNorm
    scales, relative-position tables and CLS tokens redrawn from `seed`."""
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        leaf = np.asarray(leaf)
        name = path[-1].key
        if name == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(leaf.dtype)
        if name == "bias" or name in REDRAWN:
            return (0.1 * rng.normal(size=leaf.shape)).astype(leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(redraw, jax.tree_util.tree_map(
        np.asarray, dict(variables)))


def random_variables(module, *args, seed=0):
    """Flax variables of `module` for inputs `args` drawn from `seed` (shapes
    by `jax.eval_shape`, so no Flax forward pass runs): kernels
    N(0, 1 / fan_in), LayerNorm scales U(0.5, 1.5), every other leaf
    0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, KEY, *args)

    def draw(path, s):
        name = path[-1].key
        if name == "scale":
            return rng.uniform(0.5, 1.5, s.shape).astype(s.dtype)
        if name == "kernel":
            qkv = len(path) > 1 and path[-2].key in ("query", "key", "value")
            fan_in = s.shape[0] if qkv else int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(s.dtype)
        return (0.1 * rng.normal(size=s.shape)).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def _carry(jmodule, tmodule, *args, seed=0, init=False):
    """Flax variables for `jmodule` (drawn by `random_variables`, or with
    init=True made by its initializers and then redrawn) loaded into the
    torch module: (variables, torch module)."""
    variables = (numpy_variables(jmodule.init(KEY, *args), seed) if init
                 else random_variables(jmodule, *args, seed=seed))
    return variables, tp.load_flax_variables(tmodule, variables)


def _apply(jmodule, variables, *args, **kwargs):
    """jmodule.apply, jitted (one compile, not an eager op at a time)."""
    return jax.jit(functools.partial(jmodule.apply, **kwargs))(variables, *args)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **(tol or TOL))


def _batch(b=2, size=32, n=3, seed=0):
    """Images, xyxy boxes and their filled masks (tests/test_segmentation.py's
    fixture), as numpy."""
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(b, size, size, 3)).astype(np.float32)
    x1 = rng.uniform(2, size // 2, size=(b, n))
    y1 = rng.uniform(2, size // 2, size=(b, n))
    boxes = np.stack([x1, y1, x1 + size // 4, y1 + size // 4], axis=-1)
    masks = np.zeros((b, n, size, size), np.float32)
    for i in range(b):
        for j in range(n):
            xa, ya, xb, yb = boxes[i, j].astype(int)
            masks[i, j, ya:yb, xa:xb] = 1.0
    return {"image": images, "targets": {
        "boxes": boxes.astype(np.float32), "masks": masks,
        "labels": rng.integers(0, 10, size=(b, n)).astype(np.int32),
        "valid": np.ones((b, n), np.float32)}}


def _torch_batch(batch):
    return {"image": _t(batch["image"]),
            "targets": {k: _t(v) for k, v in batch["targets"].items()}}


# ---------------------------------------------------------------- ops/boxes


def test_flip_boxes_and_masks_match_jax():
    rng = np.random.default_rng(1)
    boxes = rng.uniform(0, 30, (2, 3, 4)).astype(np.float32)
    masks = rng.normal(size=(2, 3, 8, 9)).astype(np.float32)
    assert torch.equal(tboxes.flip_boxes(_t(boxes), 32.0),
                       _t(jboxes.flip_boxes(jnp.asarray(boxes), 32.0)))
    assert torch.equal(tboxes.flip_masks(_t(masks)),
                       _t(jboxes.flip_masks(jnp.asarray(masks))))


@pytest.mark.parametrize("angle", [0.0, 90.0, -90.0, 180.0, 33.0, -270.0])
@pytest.mark.parametrize("batched", [True, False])
def test_rotate_points_and_boxes_match_jax(angle, batched):
    """Boxes within 1e-4 px; per-sample angles for (B, N, 4) boxes, one
    angle for (N, 4)."""
    rng = np.random.default_rng(2)
    boxes = rng.uniform(0, 40, (2, 3, 4) if batched else (3, 4)).astype(np.float32)
    ang = (np.array([angle, angle - 17.0], np.float32) if batched
           else np.float32(angle))
    got = tboxes.rotate_boxes(_t(boxes), _t(ang), 40)
    ref = jboxes.rotate_boxes(jnp.asarray(boxes), jnp.asarray(ang), 40)
    _close(got, ref, rtol=0, atol=1e-4)
    assert bool((got[..., 2] >= got[..., 0]).all() and (got[..., 3] >= got[..., 1]).all())
    px, py = rng.uniform(0, 40, (2, 5)).astype(np.float32)
    rad = np.float32(np.deg2rad(angle))
    for a, b in zip(tboxes.rotate_points((20.0, 20.0), _t(px), _t(py), _t(rad)),
                    jboxes.rotate_points((20.0, 20.0), jnp.asarray(px),
                                         jnp.asarray(py), jnp.asarray(rad))):
        _close(a, b, rtol=0, atol=1e-4)


def test_rotate_masks_matches_jax():
    masks = _batch(b=2, size=24)["targets"]["masks"]
    ang = np.array([33.0, -90.0], np.float32)
    got = tboxes.rotate_masks(_t(masks), _t(ang))
    _close(got, jboxes.rotate_masks(jnp.asarray(masks), jnp.asarray(ang)),
           rtol=0, atol=1e-5)
    assert got.shape == masks.shape


# ---------------------------------------------- the targets branch (C4, D4)


def _canonicalizers(group_type, size=32, seed=0):
    net_kw = dict(in_channels=3, out_channels=4, kernel_size=3, group_type=group_type,
                  num_rotations=4, num_layers=2, dropout_rate=0.0)
    canon_kw = dict(in_shape=(size, size, 3), input_crop_ratio=0.8, resize_shape=16,
                    num_rotations=4, group_type=group_type, beta=1.0)
    jcanon = JCanon(canonicalization_network=JNet(**net_kw), **canon_kw)
    tcanon = tp.GroupEquivariantImageCanonicalization(
        tp.EquivariantNetwork(**net_kw, device="cpu"), **canon_kw)
    variables, tcanon = _carry(jcanon, tcanon, jnp.zeros((2, size, size, 3)), seed=seed,
                               init=True)
    return jcanon, variables, tcanon


# (group_type, training) -> batch seed whose top-2 activation margins all
# exceed 1e-3 (elements [0, 0, 1, 2], [2, 3, 1, 1], [6, 6, 5, 4], [2, 1, 5, 7])
TARGET_CASES = {("rotation", False): 3, ("rotation", True): 5,
                ("roto-reflection", False): 5, ("roto-reflection", True): 3}


@pytest.mark.parametrize("group_type,training", sorted(TARGET_CASES))
def test_targets_branch_matches_jax(group_type, training):
    """Same elements; eval masks bit-equal (K1's plain version against JAX's
    rotate_select), training masks (the one-hot blend) within 1e-6; boxes
    within 1e-4 px; the other targets passed through."""
    jcanon, variables, tcanon = _canonicalizers(group_type)
    b = _batch(b=4, seed=TARGET_CASES[(group_type, training)])
    b["image"] = 4.0 * b["image"]
    jt = {k: jnp.asarray(v) for k, v in b["targets"].items()}
    if training:
        (jx, jtc, jinf), _ = jcanon.apply(variables, jnp.asarray(b["image"]), jt,
                                          training=True, mutable=["batch_stats"])
    else:
        jx, jtc, jinf = jcanon.apply(variables, jnp.asarray(b["image"]), jt)
    tb = _torch_batch(b)
    tx, ttc, tinf = tcanon.canonicalize(tb["image"], tb["targets"], training=training)
    acts = np.asarray(jinf.group_activations)
    top2 = np.sort(acts, axis=-1)[:, -2:]
    assert np.all(top2[:, 1] - top2[:, 0] > 1e-3), "seed without clear margins"
    assert np.array_equal(tinf.onehot.detach().numpy().argmax(-1), acts.argmax(-1))
    _close(tx, jx)
    _close(ttc["boxes"], jtc["boxes"], rtol=0, atol=1e-4)
    if training:
        _close(ttc["masks"], jtc["masks"], rtol=0, atol=1e-6)
    else:
        assert torch.equal(ttc["masks"], _t(jtc["masks"]))
    assert ttc["labels"] is tb["targets"]["labels"]
    assert ttc["valid"] is tb["targets"]["valid"]


def test_targets_masks_take_the_nchw_select(monkeypatch):
    """In eval the masks' (B, H, W, N) view of NCHW memory takes K1's route
    (select_planes) with no copy to NHWC memory; the NHWC image takes K3's
    (select_planes_nhwc)."""
    from equiadapt_tpu_torch.ops.kernels import select_warp as sw

    _, _, tcanon = _canonicalizers("rotation")
    tb = _torch_batch(_batch(b=2, seed=4))
    seen = []
    for name in ("select_planes", "select_planes_nhwc"):
        def spy(sources, *args, _name=name, _fn=getattr(sw, name), **kw):
            seen.append((_name, tuple(sources[0].shape), len(sources)))
            return _fn(sources, *args, **kw)
        monkeypatch.setattr(sw, name, spy)
    _, ttc, _ = tcanon.canonicalize(tb["image"], tb["targets"])
    assert seen == [("select_planes_nhwc", (2, 32, 32, 3), 1),
                    ("select_planes", (2, 3, 32, 32), 1)]
    assert ttc["masks"].is_contiguous()


# -------------------------------------------------------------------- data


def test_rectangles_batch_matches_jax_on_its_draws():
    """`synthetic_coco_batch`'s construction on the draws the JAX function
    makes from its key."""
    rng = jax.random.key(7)
    ref = jcoco.synthetic_coco_batch(rng, 3, image_size=40, num_prompts=4)
    k1, k2, k3 = jax.random.split(rng, 3)
    xy1 = jax.random.uniform(k1, (3, 4, 2)) * (40 * 0.5)
    wh = jax.random.uniform(k2, (3, 4, 2)) * (40 * 0.4) + 8
    noise = 0.05 * jax.random.normal(k3, (3, 40, 40, 3))
    got = tcoco.rectangles_batch(_t(xy1), _t(wh), _t(noise))
    _close(got["image"], ref["image"], rtol=0, atol=1e-6)
    for k in ("boxes", "masks", "labels", "valid"):
        assert np.array_equal(got["targets"][k].numpy(), np.asarray(ref["targets"][k])), k


def test_synthetic_coco_batch_draws_from_the_generator():
    a = tcoco.synthetic_coco_batch(torch.Generator().manual_seed(1), 2, image_size=32)
    b = tcoco.synthetic_coco_batch(torch.Generator().manual_seed(1), 2, image_size=32)
    c = tcoco.synthetic_coco_batch(torch.Generator().manual_seed(2), 2, image_size=32)
    assert torch.equal(a["image"], b["image"]) and not torch.equal(a["image"], c["image"])
    boxes = a["targets"]["boxes"]
    assert boxes.shape == (2, 4, 4) and a["targets"]["masks"].shape == (2, 4, 32, 32)
    assert bool((boxes[..., :2] >= 0).all() and (boxes[..., :2] < 16).all())
    wh = boxes[..., 2:] - boxes[..., :2]
    assert bool((wh >= 8).all() and (wh < 8 + 0.4 * 32 + 1e-4).all())
    assert a["image"].dtype == torch.float32 and a["targets"]["labels"].dtype == torch.int32


def test_resize_and_pad_and_annotations_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    image = rng.integers(0, 255, (30, 50, 3)).astype(np.uint8)
    boxes = rng.uniform(0, 30, (2, 4)).astype(np.float32)
    masks = (rng.uniform(size=(2, 30, 50)) > 0.5).astype(np.uint8)
    for m in (masks, masks[:0]):
        for got, ref in zip(tcoco.resize_and_pad(image, boxes, m, 64),
                            jcoco.resize_and_pad(image, boxes, m, 64)):
            assert got.dtype == ref.dtype and np.array_equal(got, ref)
    (tmp_path / "annotations").mkdir()
    ann = {"images": [{"id": 1}], "annotations": [], "categories": []}
    (tmp_path / "annotations" / "instances_val2017.json").write_text(json.dumps(ann))
    assert tcoco.load_coco_annotations(str(tmp_path)) == jcoco.load_coco_annotations(
        str(tmp_path)) == ann
    with pytest.raises(FileNotFoundError):
        tcoco.load_coco_annotations(str(tmp_path), "train2017")


# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("seed", [1, 2])
def test_losses_match_jax(seed):
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.normal(size=(2, 3, 16, 16))).astype(np.float32)
    gt = (rng.normal(size=(2, 3, 16, 16)) > 0).astype(np.float32)
    for tf, jf in ((tseg.focal_loss, jseg.focal_loss), (tseg.dice_loss, jseg.dice_loss),
                   (tseg.calc_iou, jseg.calc_iou)):
        _close(tf(_t(logits), _t(gt)), jf(jnp.asarray(logits), jnp.asarray(gt)),
               rtol=1e-6, atol=1e-7)
    perfect = (gt * 2 - 1) * 20.0
    assert torch.equal(tseg.calc_iou(_t(perfect), _t(gt)),
                       _t(jseg.calc_iou(jnp.asarray(perfect), jnp.asarray(gt))))
    iou = np.full((2, 3), 0.5, np.float32)
    outs = tseg.segmentation_forward_outputs(_t(logits), _t(iou), {
        "labels": _t(np.ones((2, 3), np.int32)), "boxes": _t(np.zeros((2, 3, 4)))})
    ref = jseg.segmentation_forward_outputs(jnp.asarray(logits), jnp.asarray(iou), {
        "labels": jnp.ones((2, 3), jnp.int32), "boxes": jnp.zeros((2, 3, 4))})
    assert outs["masks"].dtype == torch.uint8
    assert np.array_equal(outs["masks"].numpy(), np.asarray(ref["masks"]))


# ---------------------------------------------------------------------- mAP


def _random_map_inputs(seed, B=3, N=4, S=20):
    """Rectangles and shifted / duplicated / empty predictions, scores with
    ties, padded slots."""
    rng = np.random.default_rng(seed)
    gt = np.zeros((B, N, S, S), np.float32)
    pred = np.zeros((B, N, S, S), np.float32)
    for b in range(B):
        for j in range(N):
            y, x = rng.integers(1, S - 8, 2)
            h, w = rng.integers(3, 8, 2)
            gt[b, j, y:y + h, x:x + w] = 1.0
    for b in range(B):
        for j in range(N):
            src = rng.integers(0, N) if rng.uniform() < 0.3 else j
            dy, dx = rng.integers(-2, 3, 2)
            pred[b, j] = np.roll(gt[b, src], (dy, dx), axis=(0, 1))
            if rng.uniform() < 0.15:
                pred[b, j] = 0.0
    scores = rng.choice([0.2, 0.5, 0.5, 0.7, 0.9], size=(B, N)).astype(np.float32)
    valid = (rng.uniform(size=(B, N)) > 0.2).astype(np.float32)
    return pred, scores, gt, valid


# the JAX function jitted: one compile a shape, not a scan a threshold
jmap = jax.jit(jpipe.mean_average_precision_segm, static_argnames=("thresholds",))


def _maps(pred, scores, gt, valid, **kw):
    got = tpipe.mean_average_precision_segm(_t(pred), _t(scores), _t(gt), _t(valid), **kw)
    ref = jmap(jnp.asarray(pred), jnp.asarray(scores), jnp.asarray(gt),
               jnp.asarray(valid), **kw)
    return got.item(), float(ref)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_mean_average_precision_matches_jax_on_random_seeds(seed):
    pred, scores, gt, valid = _random_map_inputs(seed)
    got, ref = _maps(pred, scores, gt, valid)
    assert abs(got - ref) <= 1e-6, (got, ref)
    got3, ref3 = _maps(pred, scores, gt, valid, thresholds=(0.5, 0.75, 0.9))
    assert abs(got3 - ref3) <= 1e-6, (got3, ref3)
    m = tpipe.mask_iou_map_metric(_t(pred * 2 - 1), _t(scores), _t(gt), _t(valid))
    r = jpipe.mask_iou_map_metric(jnp.asarray(pred * 2 - 1), jnp.asarray(scores),
                                  jnp.asarray(gt), jnp.asarray(valid))
    assert abs(m.item() - float(r)) <= 1e-6


def test_mean_average_precision_on_the_jax_fixtures():
    """tests/test_segmentation.py's fixtures: its numpy-reference case, the
    perfect and empty cases and the hand-derived values (a)-(e), each equal
    to JAX's and to the value that test pins."""
    rng = np.random.default_rng(0)
    B, N, S = 3, 4, 24
    gt = np.zeros((B, N, S, S), np.float32)
    pred = np.zeros((B, N, S, S), np.float32)
    for b in range(B):
        for j in range(N):
            y, x = rng.integers(2, S - 10, 2)
            h, w = rng.integers(4, 9, 2)
            gt[b, j, y:y + h, x:x + w] = 1.0
            dy, dx = rng.integers(0, 4, 2)
            src = (b * N + j) % N if (b + j) % 3 == 0 else j
            yy, xx = np.nonzero(gt[b, src])
            pred[b, j][np.clip(yy + dy, 0, S - 1), np.clip(xx + dx, 0, S - 1)] = 1.0
    scores = rng.uniform(0.1, 1.0, (B, N)).astype(np.float32)
    valid = np.ones((B, N), np.float32)
    valid[1, 3] = valid[2, 2] = 0.0
    got, ref = _maps(pred, scores, gt, valid, thresholds=(0.5, 0.75, 0.9))
    assert abs(got - ref) <= 1e-6 and 0.0 < got < 1.0, (got, ref)

    S = 16
    gt = np.zeros((2, 3, S, S), np.float32)
    for b in range(2):
        for j in range(3):
            gt[b, j, 2 + j:6 + j, 3:9] = 1.0
    ones = np.ones((2, 3), np.float32)
    assert _maps(gt, np.full((2, 3), 0.9, np.float32), gt, ones) == pytest.approx(
        (1.0, 1.0), abs=1e-6)
    assert _maps(np.zeros_like(gt), np.full((2, 3), 0.9, np.float32), gt, ones) == (0.0, 0.0)

    def case(n):
        return np.zeros((1, n, S, S), np.float32)

    hand = []
    gt = case(1)
    gt[0, 0, 4, 2:6] = 1.0
    pred = case(1)
    pred[0, 0, 4, 2:5] = 1.0
    hand.append((pred, np.full((1, 1), 0.9, np.float32), gt, np.ones((1, 1)), 0.6))
    gt = case(2)
    gt[0, 0, 2:5, 2:5] = gt[0, 1, 8:11, 8:11] = 1.0
    hand.append((gt, np.full((1, 2), 0.5, np.float32), gt, np.ones((1, 2)), 1.0))
    gt = case(3)
    gt[0, 0, 1:4, 1:4] = gt[0, 1, 6:9, 6:9] = gt[0, 2, 11:14, 11:14] = 1.0
    pred = case(3)
    pred[0, 2] = gt[0, 2]
    hand.append((pred, np.array([[0.9, 0.9, 0.1]], np.float32), gt, np.ones((1, 3)),
                 34.0 / 303.0))
    gt = case(2)
    gt[0, 0, 2:6, 2:6] = gt[0, 1, 9:13, 9:13] = 1.0
    pred = case(2)
    pred[0, 0] = pred[0, 1] = gt[0, 0]
    scores = np.array([[0.9, 0.5]], np.float32)
    hand.append((pred, scores, gt, np.ones((1, 2)), 51.0 / 101.0))
    hand.append((np.zeros_like(gt), scores, gt, np.ones((1, 2)), 0.0))
    for pred, scores, gt, valid, value in hand:
        got, ref = _maps(pred, scores, gt, valid.astype(np.float32))
        assert abs(got - ref) <= 1e-6 and abs(got - value) <= 1e-6, (got, ref, value)


# ---------------------------------------------------------- ViT and blocks


def test_encoder_block_and_vit_match_jax():
    x = np.random.default_rng(6).normal(size=(2, 10, 64)).astype(np.float32)
    jblock = jvit.EncoderBlock(num_heads=4, mlp_dim=128)
    variables, tblock = _carry(jblock, tvit.EncoderBlock(64, 4, 128, device="cpu"),
                               jnp.asarray(x))
    _close(tblock(_t(x)), _apply(jblock, variables, jnp.asarray(x)))
    kw = dict(num_classes=5, patch_size=8, hidden_dim=64, num_layers=2, num_heads=4,
              mlp_dim=128)
    img = np.random.default_rng(7).normal(size=(2, 32, 32, 3)).astype(np.float32)
    jnet = jvit.ViT(**kw)
    variables, tnet = _carry(jnet, tvit.ViT(**kw, image_size=32, device="cpu"),
                             jnp.asarray(img), seed=1)
    _close(tnet(_t(img)), _apply(jnet, variables, jnp.asarray(img)), **DEEP)


def test_vit_dropout_draws_from_the_generator():
    net = tvit.ViT(num_classes=3, patch_size=8, hidden_dim=32, num_layers=1,
                   num_heads=2, mlp_dim=64, dropout=0.5, image_size=16, device="cpu")
    x = torch.randn(2, 16, 16, 3)
    a = net(x, training=True, generator=torch.Generator().manual_seed(0))
    b = net(x, training=True, generator=torch.Generator().manual_seed(0))
    c = net(x, training=True, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(net(x), net(x))
    with pytest.raises(ValueError, match="generator"):
        net(x, training=True)


def _shape_variables(module, *args, **kw):
    """Flax variables of `module` by shape only (`jax.eval_shape`), as
    zero-stride numpy arrays: no Flax forward pass, no storage."""
    shapes = jax.eval_shape(module.init, KEY, *args, **kw)
    return jax.tree_util.tree_map(lambda s: np.lib.stride_tricks.as_strided(
        np.zeros(1, s.dtype), s.shape, (0,) * len(s.shape)), dict(shapes))


def test_registry_vit_and_segmentation_keys_build_the_jax_trees():
    """ViT-B/16 at 224 px ("vit"), SAMLite ("sam") and the sam_vit SAMLite at
    ViT-B's encoder width (12 blocks of 768, 8 heads, 4 mask tokens) at
    1024 px: every Flax leaf has a torch tensor of its shape and every
    tensor a leaf (torch modules on the meta device)."""
    cfg = tp.compose_config(["prediction.architecture=vit"])
    jnet = jreg.get_image_prediction_network(cfg.prediction, 10, small_images=False)
    tnet = treg.get_image_prediction_network(cfg.prediction, 10, False, device="meta",
                                             image_size=224)
    variables = _shape_variables(jnet, jnp.zeros((1, 224, 224, 3)))
    assert len(flax_placements(tnet, variables)) == len(jax.tree_util.tree_leaves(variables))
    for arch, size, kw in (("sam", 64, dict(embed_dim=32, encoder_depth=1, num_heads=2)),
                           ("sam_vit", 1024, dict(embed_dim=256, encoder_depth=12,
                                                  num_heads=8))):
        jm = jreg.get_segmentation_prediction_network(arch, **kw)
        tm = treg.get_segmentation_prediction_network(arch, size, device="meta", **kw)
        variables = _shape_variables(jm, jnp.zeros((1, size, size, 3)),
                                     jnp.zeros((1, 2, 4)))
        assert len(flax_placements(tm, variables)) == len(
            jax.tree_util.tree_leaves(variables)), arch
    assert tm.SamVitEncoder_0.pos_embed.shape == (1, 64, 64, 768)
    assert tm.MaskDecoderLite_0.num_mask_tokens == 4
    assert type(treg.get_segmentation_prediction_network(
        "maskrcnn", 64, device="cpu", channels=16)).__name__ == "MaskRCNNLite"
    with pytest.raises(ValueError):
        treg.get_segmentation_prediction_network("unet", 64, device="cpu")


# ------------------------------------------------------- the SAMLite parts


def test_image_encoder_lite_matches_jax():
    img = np.random.default_rng(8).normal(size=(2, 32, 32, 3)).astype(np.float32)
    kw = dict(embed_dim=32, patch_size=8, depth=2, num_heads=4, width=64)
    jenc = jseg.ImageEncoderLite(**kw)
    variables, tenc = _carry(jenc, tseg.ImageEncoderLite(32, **kw, device="cpu"),
                             jnp.asarray(img), seed=2)
    out = tenc(_t(img))
    assert out.shape == (2, 4, 4, 32)
    _close(out, _apply(jenc, variables, jnp.asarray(img)), **DEEP)


def test_prompt_encoder_matches_jax():
    boxes = np.random.default_rng(9).uniform(0, 48, (2, 3, 4)).astype(np.float32)
    jpe = jseg.PromptEncoderLite(embed_dim=32)
    variables, tpe = _carry(jpe, tseg.PromptEncoderLite(32, device="cpu"),
                            jnp.asarray(boxes), (48, 40))
    _close(tpe(_t(boxes), (48, 40)), jpe.apply(variables, jnp.asarray(boxes), (48, 40)))


@pytest.mark.parametrize("num_mask_tokens", [1, 4])
def test_mask_decoder_matches_jax(num_mask_tokens):
    """T = 1 and T = 4 (SAM's multimask heads, the best-IoU pick; the same
    mask picked); the transposed convs' flipped kernels."""
    rng = np.random.default_rng(10)
    emb = rng.normal(size=(2, 4, 4, 32)).astype(np.float32)
    prompts = rng.normal(size=(2, 3, 2, 32)).astype(np.float32)
    jdec = jseg.MaskDecoderLite(embed_dim=32, depth=2, num_heads=4,
                                num_mask_tokens=num_mask_tokens)
    variables, tdec = _carry(
        jdec, tseg.MaskDecoderLite(32, 2, 4, num_mask_tokens, device="cpu"),
        jnp.asarray(emb), jnp.asarray(prompts), seed=3)
    masks, iou = tdec(_t(emb), _t(prompts))
    jmasks, jiou = _apply(jdec, variables, jnp.asarray(emb), jnp.asarray(prompts))
    assert masks.shape == (2, 3, 16, 16) and iou.shape == (2, 3)
    _close(masks, jmasks, **DEEP)
    _close(iou, jiou, **DEEP)


def test_rel_pos_table_matches_jax_with_and_without_a_resize():
    rng = np.random.default_rng(11)
    for length, size in ((7, 4), (5, 4), (15, 4), (9, 5)):
        table = rng.normal(size=(length, 6)).astype(np.float32)
        _close(tsam._rel_pos_table(size, size, _t(table)),
               jsam._rel_pos_table(size, size, jnp.asarray(table)), rtol=0, atol=1e-6)


def test_window_partition_pads_and_unpartitions():
    x = torch.randn(2, 6, 6, 5)
    win, pad_hw = tsam._window_partition(x, 4)
    assert win.shape == (8, 4, 4, 5) and pad_hw == (8, 8)
    jwin, jpad = jsam._window_partition(jnp.asarray(x.numpy()), 4)
    assert torch.equal(win, _t(jwin)) and tuple(jpad) == pad_hw
    assert torch.equal(tsam._window_unpartition(win, 4, pad_hw, (6, 6)), x)


SAM_KW = dict(img_size=48, patch_size=8, embed_dim=64, depth=2, num_heads=4,
              out_chans=32, window_size=4, global_attn_indexes=(1,))


def test_sam_vit_encoder_matches_jax():
    """A windowed block on a 6 x 6 grid (window 4: padded to 8 x 8) and a
    global block, the neck; the Flax names carried through `flax_aliases`."""
    img = np.random.default_rng(12).normal(size=(2, 48, 48, 3)).astype(np.float32)
    jenc = jsam.SamVitEncoder(**SAM_KW)
    variables, tenc = _carry(jenc, tsam.SamVitEncoder(**SAM_KW, device="cpu"),
                             jnp.asarray(img), seed=4)
    assert tenc.blocks[0].window_size == 4 and tenc.blocks[1].window_size == 0
    out = tenc(_t(img))
    assert out.shape == (2, 6, 6, 32)
    _close(out, _apply(jenc, variables, jnp.asarray(img)), **DEEP)


@pytest.mark.parametrize("encoder", ["lite", "sam_vit"])
def test_samlite_matches_jax(encoder):
    b = _batch(b=2, size=48, seed=5)
    kw = dict(embed_dim=32, encoder_depth=2, decoder_depth=1, num_heads=4, patch_size=8,
              encoder=encoder, num_mask_tokens=4 if encoder == "sam_vit" else 1)
    jm = jseg.SAMLite(**kw)
    args = (jnp.asarray(b["image"]), jnp.asarray(b["targets"]["boxes"]))
    variables, tm = _carry(jm, tseg.SAMLite(48, **kw, device="cpu"), *args, seed=6)
    masks, iou = tm(_t(b["image"]), _t(b["targets"]["boxes"]))
    jmasks, jiou = _apply(jm, variables, *args)
    assert masks.shape == (2, 3, 48, 48) and masks.is_contiguous()
    _close(masks, jmasks, **DEEP)
    _close(iou, jiou, **DEEP)


@pytest.mark.parametrize("encoder", ["lite", "sam_vit"])
def test_loader_new_leaves_both_directions(encoder):
    """`flax_variables` gives back the loaded tree leaf for leaf: the MHA
    kernels, the ConvTranspose flip, the raw parameters, SAM's aliases."""
    kw = dict(embed_dim=32, encoder_depth=1, decoder_depth=1, num_heads=2, patch_size=8,
              encoder=encoder)
    jm = jseg.SAMLite(**kw)
    variables, tm = _carry(jm, tseg.SAMLite(32, **kw, device="cpu"),
                           jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 2, 4)), seed=7)
    back = tp.flax_variables(tm)
    flat_a = dict(jax.tree_util.tree_leaves_with_path(variables))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert flat_a.keys() == flat_b.keys()
    for k, v in flat_a.items():
        assert np.array_equal(flat_b[k], v), k
    w = np.asarray(variables["params"]["MaskDecoderLite_0"]["upscale_conv1"]["kernel"])
    assert np.array_equal(tm.MaskDecoderLite_0.upscale_conv1.weight.detach().numpy(),
                          w[::-1, ::-1].transpose(2, 3, 0, 1))


# --------------------------------------------------- pipeline, step, sweep


SAM_SMALL = dict(embed_dim=32, encoder_depth=1, decoder_depth=1, num_heads=2,
                 patch_size=8)


def _pipelines(group_type="rotation"):
    """The JAX and port pipelines (`_canonicalizers`' C4 / D4 canonicalizer,
    a lite SAMLite at 32 px), the same weights."""
    jcanon, cvars, tcanon = _canonicalizers(group_type)
    jp = jpipe.ImageSegmentationPipeline(canonicalizer=jcanon,
                                         prediction_network=jseg.SAMLite(**SAM_SMALL))
    svars = random_variables(jseg.SAMLite(**SAM_SMALL), jnp.zeros((1, 32, 32, 3)),
                             jnp.zeros((1, 2, 4)), seed=9)
    variables = {"params": {"canonicalizer": cvars["params"],
                            "prediction_network": svars["params"]},
                 "batch_stats": {"canonicalizer": cvars["batch_stats"]}}
    tpl = tpipe.ImageSegmentationPipeline(tcanon, tseg.SAMLite(32, **SAM_SMALL,
                                                               device="cpu"))
    return jp, variables, tp.load_flax_variables(tpl, variables)


@pytest.mark.parametrize("group_type", ["rotation", "roto-reflection"])
def test_pipeline_forward_invert_and_task_loss_match_jax(group_type):
    jp, variables, tpl = _pipelines(group_type)
    b = _batch(b=4, seed=TARGET_CASES[(group_type, False)])
    b["image"] = 4.0 * b["image"]
    jt = {k: jnp.asarray(v) for k, v in b["targets"].items()}
    (jxc, jtc, jmasks, jious), jinf = _apply(jp, variables, jnp.asarray(b["image"]), jt)
    tb = _torch_batch(b)
    with torch.no_grad():
        (txc, ttc, tmasks, tious), tinf = tpl(tb["image"], tb["targets"])
        tback = tpl.invert_masks(tinf, tmasks)
    acts = np.asarray(jinf.group_activations)
    top2 = np.sort(acts, axis=-1)[:, -2:]
    assert np.all(top2[:, 1] - top2[:, 0] > 1e-3), "seed without clear margins"
    assert np.array_equal(tinf.onehot.numpy().argmax(-1), acts.argmax(-1))
    _close(txc, jxc)
    assert torch.equal(ttc["masks"], _t(jtc["masks"]))
    _close(tmasks, jmasks, **DEEP)
    _close(tious, jious, **DEEP)
    jback = _apply(jp, variables, jinf, jmasks,
                   method=jpipe.ImageSegmentationPipeline.invert_masks)
    _close(tback, jback, **DEEP)
    # the invert of the port's own masks is the plain select, exactly
    with torch.no_grad():
        again = tpl.invert_masks(tinf, _t(jmasks))
    assert torch.equal(again, _t(jback))
    tl, tm = tpipe.segmentation_task_loss(tmasks, tious, ttc)
    jl, jm = jpipe.segmentation_task_loss(jmasks, jious, jtc)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for k, v in jm.items():
        np.testing.assert_allclose(tm[k].item(), float(v), rtol=1e-5, atol=1e-6, err_msg=k)


def _grads_as_flax(module):
    ghost = copy.deepcopy(module)
    with torch.no_grad():
        for p, q in zip(ghost.parameters(), module.parameters()):
            p.copy_(q.grad if q.grad is not None else torch.zeros_like(q))
    return tp.flax_variables(ghost)["params"]


def test_train_step_matches_jax():
    """One prior-regularized step (prior weight 100, AdamW 8e-4): the loss
    and its terms, the gradients, the updated parameters and the BatchNorm
    statistics against `make_segmentation_train_step`'s arithmetic (its
    loss function under `jax.value_and_grad`, then optax's AdamW)."""
    from equiadapt_tpu.common.info import prior_regularization_loss

    lr = 8e-4
    jp, variables, tpl = _pipelines()
    b = _batch(b=4, seed=TARGET_CASES[("rotation", True)])
    b["image"] = 4.0 * b["image"]
    jt = {k: jnp.asarray(v) for k, v in b["targets"].items()}

    def jloss(params):
        ((_, tc, pm, io), info), new = jp.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(b["image"]), jt, training=True, mutable=["batch_stats"])
        task, metrics = jpipe.segmentation_task_loss(pm, io, tc)
        prior = prior_regularization_loss(info)
        loss = task + 100.0 * prior
        return loss, (dict(metrics, **{"loss/prior": prior, "loss/total": loss}),
                      new["batch_stats"])

    (_, (jm, jstats)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    tx = optax.adamw(lr)

    @jax.jit
    def adamw_step(grads, params):
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, updates)

    new_params = adamw_step(jgrads, variables["params"])
    state = tpipe.create_segmentation_state(tpl, lr)
    before = tp.flax_variables(tpl)["params"]
    state, tm = tpipe.make_segmentation_train_step(prior_weight=100.0)(
        state, _torch_batch(b))
    assert state.step == 1 and tm["loss/finite"].item() == 1.0
    for k, v in jm.items():
        np.testing.assert_allclose(tm[k].item(), float(v), rtol=1e-5, atol=1e-6, err_msg=k)
    tgrads = _grads_as_flax(tpl)
    after = tp.flax_variables(tpl)
    gmax = max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(jgrads))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tgrads))
    assert flat_j.keys() == flat_t.keys()
    upd_j = jax.tree_util.tree_map(lambda a, c: np.asarray(a) - c,
                                   new_params, variables["params"])
    upd_t = jax.tree_util.tree_map(lambda a, c: a - c, after["params"], before)
    flat_uj = dict(jax.tree_util.tree_leaves_with_path(upd_j))
    flat_ut = dict(jax.tree_util.tree_leaves_with_path(upd_t))
    moved = 0
    for k, gj in flat_j.items():
        gj = np.asarray(gj)
        np.testing.assert_allclose(flat_t[k], gj, rtol=0, atol=1e-4 * gmax, err_msg=str(k))
        big = np.abs(gj) > 1e-3 * gmax
        np.testing.assert_allclose(flat_ut[k][big], flat_uj[k][big], rtol=0, atol=1e-6,
                                   err_msg=str(k))
        moved += int(big.sum())
    assert moved > 100
    stats_t = dict(jax.tree_util.tree_leaves_with_path(after["batch_stats"]))
    for k, v in dict(jax.tree_util.tree_leaves_with_path(jstats)).items():
        np.testing.assert_allclose(stats_t[k], np.asarray(v), **TOL, err_msg=str(k))


class _JBoxOracle(fnn.Module):
    """Predicts each prompt's box as its mask (score: the box's area)."""

    @fnn.compact
    def __call__(self, images, boxes, training=False):
        H, W = images.shape[1:3]
        ys = jnp.arange(H)[None, None, :, None] + 0.5
        xs = jnp.arange(W)[None, None, None, :] + 0.5
        inside = ((xs >= boxes[..., 0, None, None]) & (xs < boxes[..., 2, None, None])
                  & (ys >= boxes[..., 1, None, None]) & (ys < boxes[..., 3, None, None]))
        area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
        return inside.astype(jnp.float32), area


class _TBoxOracle(torch.nn.Module):
    def forward(self, images, boxes, training=False, generator=None):
        H, W = images.shape[1:3]
        ys = torch.arange(H)[None, None, :, None] + 0.5
        xs = torch.arange(W)[None, None, None, :] + 0.5
        inside = ((xs >= boxes[..., 0, None, None]) & (xs < boxes[..., 2, None, None])
                  & (ys >= boxes[..., 1, None, None]) & (ys < boxes[..., 3, None, None]))
        area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
        return inside.float(), area


@pytest.mark.parametrize("group_type", ["roto-reflection"])
def test_group_sweep_matches_jax(group_type, monkeypatch):
    """The sweep's per-element and aggregated mAP equal JAX's (within 1e-6),
    with a predictor that rasterizes each canonical box: the numbers then
    measure how the rotated boxes and masks agree; and with SAMLite,
    finite and of JAX's keys."""
    jcanon, variables, tcanon = _canonicalizers(group_type, seed=5)
    b = _batch(b=3, size=32, seed=10)
    jp = jpipe.ImageSegmentationPipeline(canonicalizer=jcanon,
                                         prediction_network=_JBoxOracle())
    tpl = tpipe.ImageSegmentationPipeline(tcanon, _TBoxOracle())

    class _State:
        params = {"canonicalizer": variables["params"]}
        batch_stats = {"canonicalizer": variables["batch_stats"]}
        apply_fn = jp.apply

    jb = {"image": jnp.asarray(b["image"]),
          "targets": {k: jnp.asarray(v) for k, v in b["targets"].items()}}
    monkeypatch.setattr(jpipe, "mean_average_precision_segm", jmap)
    ref = jpipe.segmentation_group_inference(_State, jb, num_rotations=4,
                                             group_type=group_type)
    got = tpipe.segmentation_group_inference(tpl, _torch_batch(b), num_rotations=4,
                                             group_type=group_type)
    assert got.keys() == ref.keys()
    assert len(got) == (10 if group_type == "roto-reflection" else 6)
    for k, v in ref.items():
        assert abs(got[k].item() - float(v)) <= 1e-6, (k, got[k].item(), float(v))
    assert 0.0 < got["test/group_map"].item() <= 1.0
    _, _, sam_pipe = _pipelines(group_type)
    out = tpipe.segmentation_group_inference(sam_pipe, _torch_batch(b), num_rotations=4,
                                             group_type=group_type)
    assert out.keys() == ref.keys() and all(bool(torch.isfinite(v)) for v in out.values())


# ------------------------------------------------------------ sam_convert


def _sam_state_dict(rng, C, width, mlp, patch, grid, T_sam=4, depth=1):
    """A random torch SAM state dict (numpy) with a lite SAMLite's leaves."""
    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)
    sd = {"image_encoder.patch_embed.proj.weight": r(width, 3, patch, patch),
          "image_encoder.patch_embed.proj.bias": r(width),
          "image_encoder.pos_embed": r(1, grid, grid, width),
          "image_encoder.neck.0.weight": r(C, width, 1, 1),
          "image_encoder.neck.2.weight": r(C, C, 3, 3),
          "prompt_encoder.point_embeddings.2.weight": r(1, C),
          "prompt_encoder.point_embeddings.3.weight": r(1, C),
          "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix": r(2, C // 2),
          "mask_decoder.iou_token.weight": r(1, C),
          "mask_decoder.mask_tokens.weight": r(T_sam, C),
          "mask_decoder.output_upscaling.0.weight": r(C, C // 4, 2, 2),
          "mask_decoder.output_upscaling.0.bias": r(C // 4),
          "mask_decoder.output_upscaling.1.weight": r(C // 4),
          "mask_decoder.output_upscaling.1.bias": r(C // 4),
          "mask_decoder.output_upscaling.3.weight": r(C // 4, C // 8, 2, 2),
          "mask_decoder.output_upscaling.3.bias": r(C // 8)}
    for i in range(depth):
        pre = f"image_encoder.blocks.{i}."
        sd.update({pre + "attn.qkv.weight": r(3 * width, width),
                   pre + "attn.qkv.bias": r(3 * width),
                   pre + "attn.proj.weight": r(width, width),
                   pre + "attn.proj.bias": r(width),
                   pre + "norm1.weight": r(width), pre + "norm1.bias": r(width),
                   pre + "norm2.weight": r(width), pre + "norm2.bias": r(width),
                   pre + "mlp.lin1.weight": r(mlp, width), pre + "mlp.lin1.bias": r(mlp),
                   pre + "mlp.lin2.weight": r(width, mlp), pre + "mlp.lin2.bias": r(width)})
    for j in range(T_sam):
        for li, (o, i) in enumerate(((C, C), (C, C), (C // 8, C))):
            pre = f"mask_decoder.output_hypernetworks_mlps.{j}.layers.{li}"
            sd.update({pre + ".weight": r(o, i), pre + ".bias": r(o)})
    for li, (o, i) in enumerate(((C, C), (C, C), (T_sam, C))):
        pre = f"mask_decoder.iou_prediction_head.layers.{li}"
        sd.update({pre + ".weight": r(o, i), pre + ".bias": r(o)})
    return sd


@pytest.mark.parametrize("num_mask_tokens", [1, 4])
def test_convert_sam_checkpoint_matches_jax(num_mask_tokens):
    """One random SAM-layout state dict through the JAX converter and the
    Flax loader, and through the port's converter: every tensor
    `torch.equal`; the converted models' outputs agree."""
    kw = dict(embed_dim=32, encoder_depth=1, decoder_depth=1, num_heads=2, patch_size=8,
              num_mask_tokens=num_mask_tokens)
    jm = jseg.SAMLite(**kw)
    b = _batch(b=2, size=32, seed=11)
    args = (jnp.asarray(b["image"]), jnp.asarray(b["targets"]["boxes"]))
    variables = random_variables(jm, *args, seed=8)
    sd = _sam_state_dict(np.random.default_rng(12), 32, 256, 1024, 8, 4)
    jparams = jconv.convert_sam_checkpoint(sd, variables["params"])
    via_jax = tp.load_flax_variables(tseg.SAMLite(32, **kw, device="cpu"),
                                     {"params": jparams})
    port = tp.load_flax_variables(tseg.SAMLite(32, **kw, device="cpu"), variables)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    tconv.convert_sam_checkpoint({k: torch.from_numpy(v) for k, v in sd.items()}, port)
    ref = via_jax.state_dict()
    for k, v in port.state_dict().items():
        assert torch.equal(v, ref[k]), k
    changed = {k for k, v in port.state_dict().items() if not torch.equal(v, start[k])}
    assert len(changed) > 40  # the neck's LayerNorms have no SAM counterpart here
    assert not any(k.startswith("ImageEncoderLite_0.LayerNorm_") for k in changed)
    masks, iou = port(_t(b["image"]), _t(b["targets"]["boxes"]))
    jmasks, jiou = _apply(jm, {"params": jparams}, *args)
    _close(masks, jmasks, rtol=1e-4, atol=1e-4 * float(np.abs(jmasks).max()))
    with pytest.raises(ValueError, match="shape"):
        tconv.convert_sam_checkpoint(
            {"mask_decoder.iou_token.weight": torch.zeros(1, 16),
             "mask_decoder.mask_tokens.weight": torch.zeros(4, 32)}, port)


def test_convert_sam_vit_encoder_matches_jax():
    """A random SAM image-encoder state dict: the port's strict load and the
    JAX converter plus the Flax loader give `torch.equal` tensors, every
    torch leaf consumed; a missing or extra leaf raises."""
    rng = np.random.default_rng(13)
    jenc = jsam.SamVitEncoder(**SAM_KW)
    img = rng.normal(size=(2, 48, 48, 3)).astype(np.float32)
    params = random_variables(jenc, jnp.asarray(img))["params"]
    shapes = {k: tuple(v.shape) for k, v in
              tsam.SamVitEncoder(**SAM_KW, device="cpu").state_dict().items()}
    sd = {f"image_encoder.{k}": rng.normal(size=s).astype(np.float32)
          for k, s in shapes.items()}
    sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = np.zeros((2, 4))
    via_jax = tp.load_flax_variables(tsam.SamVitEncoder(**SAM_KW, device="cpu"),
                                     {"params": jconv.convert_sam_vit_encoder(sd, params)})
    port = tconv.convert_sam_vit_encoder(
        {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
        tsam.SamVitEncoder(**SAM_KW, device="cpu"))
    ref = via_jax.state_dict()
    assert port.state_dict().keys() == ref.keys()
    for k, v in port.state_dict().items():
        assert torch.equal(v, ref[k]) and torch.equal(v, _t(sd["image_encoder." + k])), k
    _close(port(_t(img)), _apply(jenc, {"params": jconv.convert_sam_vit_encoder(sd, params)},
                                  jnp.asarray(img)), **DEEP)
    del sd["image_encoder.neck.3.bias"]
    with pytest.raises(RuntimeError, match="neck.3.bias"):
        tconv.convert_sam_vit_encoder(sd, tsam.SamVitEncoder(**SAM_KW, device="cpu"))
    sd["image_encoder.neck.3.bias"] = np.zeros(32, np.float32)
    sd["image_encoder.blocks.9.norm1.weight"] = np.zeros(64, np.float32)
    with pytest.raises(RuntimeError, match="blocks.9"):
        tconv.convert_sam_vit_encoder(sd, tsam.SamVitEncoder(**SAM_KW, device="cpu"))
