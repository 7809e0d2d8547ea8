"""The point-cloud family's training half and part segmentation against the
JAX package, on the CPU: train-mode `BatchNormLastAxis` and `VNBatchNorm`,
VNSmall, PointNet, DGCNN, TransformNet and DGCNNPartSeg (eval and train,
outputs and gradients against `jax.grad`), the canonicalizer with
training=True, the augmentations on shared draws, one
`make_pointcloud_train_step` against JAX's, the part-segmentation CLI's
step and metrics against the JAX CLI's, the HDF5 loaders, the Flax
variables of DGCNNPartSeg both ways, `knn_indices`' detached input and the
FLOP count of both steps.

Every Flax variable is redrawn from a numpy seed (an all-zero kernel, as
TransformNet's last one starts, too), and every kNN graph the port builds
is checked for a 1e-5 relative margin between its k-th and (k+1)-th
float64 distances, so an fp32 difference in a stage's input cannot change
a neighbour set. Dropout is 0 in every parity test, but for PointNet,
whose rate JAX fixes at 0.5: its mask is drawn with numpy when JAX asks
and replayed to the port. The JAX sides are jitted (eager Flax gradients
take minutes).

Training runs in float64 on both sides (`jax.enable_x64`, the port's
modules `.double()`; the kNN distances stay fp32 in both). In fp32 the two
differ by far more than rounding, and the port is the closer one: Flax
takes the batch variance in one pass, E[x^2] - E[x]^2, torch in two, and
after the max over the points a global layer's BatchNorm sees B = 3
similar values, whose one-pass variance loses about three digits (the
fp32 TransformNet's gradients differ by up to 3e-4 of the largest, the
DGCNN's by 2e-3). In float64 both formulas are exact to 1e-12.

Bars: eval (fp32): outputs within 1e-5 of the largest value (1e-4 for
DGCNN-family logits, whose kNN stages stack BatchNorms), statistics
unchanged, gradients within 1e-4 of the largest gradient of the module.
Training (float64, compared through the fp32 snapshots `flax_variables`
takes): outputs, BatchNorm statistics and gradients within 1e-6 of the
largest value; a train step's loss and metrics within 1e-6 relative, its
updates as `_held_by_norms` states.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from equiadapt_tpu.common import info as jinfo
from equiadapt_tpu.data import pointcloud as jdata
from equiadapt_tpu.models import pointnet as jpn
from equiadapt_tpu.pipelines import pointcloud as jpipe
from equiadapt_tpu.pointcloud import canonicalization as jcan
from equiadapt_tpu.pointcloud import networks as jnet
from equiadapt_tpu.pointcloud import vector_neurons as jvn
import flax.linen as nn
import equiadapt_tpu_torch as tp
from equiadapt_tpu_torch.cli import partseg_train as tps
from equiadapt_tpu_torch.data import pointcloud as tdata
from equiadapt_tpu_torch.ops.kernels import knn as tknn
from equiadapt_tpu_torch.pipelines import pointcloud as tpipe
from equiadapt_tpu_torch.pointcloud import vector_neurons as tvn
from equiadapt_tpu_torch.utils import flops as tflops

from test_torch_port_pointcloud import _t, _x, assert_margins, knn_inputs  # noqa: F401
from test_torch_port_train import _close_tree, _grad_tree
from torch_port_cpu import one_intra_op_thread  # noqa: F401

KEY = jax.random.key(0)


def redrawn_variables(variables, seed):
    """Flax variables as numpy, with biases, BatchNorm scales and running
    statistics redrawn from `seed`, and every all-zero kernel drawn as
    N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        leaf = np.asarray(leaf)
        name = path[-1].key
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(leaf.dtype)
        if name in ("mean", "bias"):
            return (0.1 * rng.normal(size=leaf.shape)).astype(leaf.dtype)
        if name == "kernel" and not leaf.any():
            return (0.1 * rng.normal(size=leaf.shape)).astype(leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(redraw, jax.tree_util.tree_map(
        np.asarray, dict(variables)))


def margins_past_duplicates(seen, margin=1e-5):
    """`assert_margins` for clouds with exact duplicates (point dropout): a
    tie at the k-th distance among copies of one point picks equal
    features whichever copy it takes, so the gap is taken from the k-th
    float64 distance to the next larger one."""
    assert seen, "no kNN graph was built"
    for points, k in seen:
        p = np.asarray(points, np.float64)
        d = np.sort(((p[:, :, None, :] - p[:, None, :, :]) ** 2).sum(-1), axis=-1)
        kth = d[..., k - 1:k]
        nxt = np.where(d > kth, d, np.inf).min(-1, keepdims=True)
        gap = ((nxt - kth) / np.maximum(nxt, 1e-30)).min()
        assert gap > margin, "pick another seed"


def _tree(x):
    return jax.tree_util.tree_map(np.asarray, dict(x))


class _Masks:
    """Dropout masks drawn with numpy when the JAX module asks, replayed to
    the port in the same order."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.drawn = []

    def bernoulli(self, key, p=0.5, shape=None):
        mask = self.rng.uniform(size=shape) < p
        self.drawn.append(mask)
        return jnp.asarray(mask)

    def replay(self, dropout_module, rate):
        masks = iter(self.drawn)

        def dropout(y, training=False, generator=None):
            if not training:
                return y
            keep = torch.from_numpy(next(masks))
            return torch.where(keep, y / (1.0 - rate), torch.zeros_like(y))

        dropout_module.forward = dropout


@pytest.mark.parametrize("momentum", [0.9, 0.99])
def test_batchnorm_last_axis_train_matches_flax(momentum):
    x = _x((3, 10, 4, 6), seed=1) * 2.0 + 0.7
    jbn = nn.BatchNorm(use_running_average=False, momentum=momentum)
    variables = redrawn_variables(jbn.init(KEY, jnp.asarray(x)), seed=2)
    jy, upd = jbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    tbn = tp.load_flax_variables(
        tvn.BatchNormLastAxis(6, momentum=momentum, device="cpu"), variables)
    tbn.eval()  # the module mode is not read
    ty = tbn(_t(x), training=True)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    _close_tree(tp.flax_variables(tbn)["batch_stats"], _tree(upd["batch_stats"]), 1e-6)
    # eval reads the updated statistics
    jy_eval = nn.BatchNorm(use_running_average=True).apply(
        {**variables, **upd}, jnp.asarray(x))
    np.testing.assert_allclose(tbn(_t(x)).detach().numpy(), np.asarray(jy_eval),
                               rtol=0, atol=1e-5)


def test_vn_batchnorm_train_matches_flax():
    """VNBatchNorm normalizes vector norms with momentum 0.9."""
    x = _x((3, 12, 3, 5), seed=3)
    jbn = jvn.VNBatchNorm()
    variables = redrawn_variables(jbn.init(KEY, jnp.asarray(x)), seed=4)
    jy, upd = jbn.apply(variables, jnp.asarray(x), training=True,
                        mutable=["batch_stats"])
    tbn = tp.load_flax_variables(tvn.VNBatchNorm(5, device="cpu"), variables)
    assert tbn.BatchNorm_0.momentum == pytest.approx(0.1)  # Flax's 0.9
    ty = tbn(_t(x), training=True)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    _close_tree(tp.flax_variables(tbn)["batch_stats"], _tree(upd["batch_stats"]), 1e-6)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _check_against_jax(jmod, tmod, jargs, training, seed, w_seed, masks=None,
                       out_rel=1e-5, knn_seen=None, **jkw):
    """Outputs, BatchNorm statistics and the gradients of sum(out * w) to
    every parameter, JAX (jitted) against the port; training in float64
    (module docstring)."""
    variables = redrawn_variables(jmod.init(KEY, *jargs, **jkw), seed)
    tmod = tp.load_flax_variables(tmod, variables)
    first = lambda out: out[0] if isinstance(out, tuple) else out  # noqa: E731
    out_shape = first(jax.eval_shape(functools.partial(jmod.apply, **jkw), variables,
                                     *jargs)).shape
    w = _x(out_shape, seed=w_seed)
    if training:
        tmod.double()
        variables, jargs, jkw, w = _f64((variables, jargs, jkw, w))
        out_rel = 1e-6

    def jloss(params):
        out, upd = jmod.apply({"params": params,
                               "batch_stats": variables.get("batch_stats", {})},
                              *jargs, training=training, mutable=["batch_stats"],
                              rngs={"dropout": KEY}, **jkw)
        return jnp.sum(first(out) * w), (first(out), upd)

    with jax.enable_x64(training):
        (_, (jout, upd)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            variables["params"])
    if masks is not None:
        masks.replay(tmod.dropout, 0.5)
    out = first(tmod(*[_t(a) for a in jargs], training=training,
                     **{k: _t(v) for k, v in jkw.items()}))
    torch.sum(out * _t(w)).backward()
    if knn_seen is not None:
        assert_margins(knn_seen)
    ref = np.asarray(jout)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=out_rel * np.abs(ref).max())
    if training:
        _close_tree(tp.flax_variables(tmod)["batch_stats"],
                    _tree(upd["batch_stats"]), 1e-6)
    else:  # eval leaves the statistics as they were
        _close_tree(tp.flax_variables(tmod)["batch_stats"],
                    variables["batch_stats"], 0.0)
    _close_tree(_grad_tree(tmod), _tree(jgrads), 1e-6 if training else 1e-4,
                scale="tree")
    return tmod


# variable seeds whose kNN graphs keep their margin in both modes
SEEDS = {"dgcnn": 30}
NETWORKS = ["vnsmall_mean", "vnsmall_max", "pointnet", "dgcnn", "transformnet",
            "dgcnn_partseg"]


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("name", NETWORKS)
def test_network_matches_jax(name, training, knn_inputs, monkeypatch):  # noqa: F811
    pts = _x((3, 48, 3), seed=5) * np.array([1.0, 0.6, 0.3], np.float32)
    masks = None
    kw = {}
    if name.startswith("vnsmall"):
        pooling = name.split("_")[1]
        jmod = jnet.VNSmall(n_knn=6, pooling=pooling, dropout_rate=0.0)
        tmod = tp.VNSmall(6, pooling, dropout_rate=0.0, device="cpu")
        args = (pts,)
    elif name == "pointnet":  # JAX fixes its dropout at 0.5
        jmod, tmod, args = jpn.PointNet(num_classes=5, emb_dims=32), tp.PointNet(
            5, 32, device="cpu"), (pts,)
        if training:
            masks = _Masks(6)
            monkeypatch.setattr(jax.random, "bernoulli", masks.bernoulli)
    elif name == "dgcnn":
        jmod = jpn.DGCNN(num_classes=5, k=6, emb_dims=32, dropout=0.0)
        tmod, args = tp.DGCNN(5, 6, 32, dropout=0.0, device="cpu"), (pts,)
    elif name == "transformnet":
        edges = np.asarray(jpn.get_graph_feature(jnp.asarray(pts), 6))
        jmod, tmod, args = jpn.TransformNet(), tp.TransformNet(device="cpu"), (edges,)
    else:
        onehot = np.eye(3, dtype=np.float32)[[0, 2, 1]]
        jmod = jpn.DGCNNPartSeg(num_parts=6, num_categories=3, k=6, emb_dims=32,
                                dropout=0.0)
        tmod = tp.DGCNNPartSeg(6, 3, 6, 32, dropout=0.0, device="cpu")
        args, kw = (pts,), {"category_onehot": onehot}
    tmod.train(not training)  # the module mode is not read
    rel = 1e-5 if name.startswith(("vnsmall", "transformnet")) else 1e-4
    _check_against_jax(jmod, tmod, args, training, seed=SEEDS.get(name, 7), w_seed=8,
                       masks=masks,
                       out_rel=rel, knn_seen=knn_inputs if name != "pointnet"
                       and name != "transformnet" else None, **kw)
    if masks is not None:
        assert len(masks.drawn) == 1


def test_vn_std_feature_train_matches_jax():
    x = _x((3, 16, 3, 8), seed=9)
    _check_against_jax(jvn.VNStdFeature(normalize_frame=True),
                       tvn.VNStdFeature(8, normalize_frame=True, device="cpu"),
                       (x,), True, seed=10, w_seed=11)


def test_fresh_transformnet_is_the_identity():
    edges = torch.randn(2, 16, 4, 6)
    t = tp.TransformNet(device="cpu")(edges, training=True)
    assert torch.equal(t, torch.eye(3).expand(2, 3, 3))
    variables = jpn.TransformNet().init(KEY, jnp.asarray(edges.numpy()))
    np.testing.assert_array_equal(
        tp.flax_variables(tp.TransformNet(device="cpu"))["params"]["Dense_5"]["bias"],
        np.asarray(variables["params"]["Dense_5"]["bias"]))


@pytest.mark.parametrize("translation", [False, True])
def test_canonicalizer_train_matches_jax(translation, knn_inputs):  # noqa: F811
    """canonicalize(training=True): canonical clouds, frames, the prior
    loss and their gradients to the VNSmall parameters."""
    pts = _x((3, 48, 3), seed=12) * np.array([1.0, 0.6, 0.3], np.float32)
    jmod = jcan.EquivariantPointcloudCanonicalization(
        canonicalization_network=jnet.VNSmall(n_knn=6, knn_mode="fused",
                                              dropout_rate=0.0),
        enable_translation=translation)
    variables = redrawn_variables(jmod.init(KEY, jnp.asarray(pts)), seed=13)
    canon = tp.load_flax_variables(tp.EquivariantPointcloudCanonicalization(
        tp.VNSmall(6, knn_mode="fused", dropout_rate=0.0, device="cpu"),
        enable_translation=translation), variables).double()
    variables, pts, w = _f64((variables, pts, _x(pts.shape, seed=14)))

    def jloss(params):
        (xc, info), upd = jmod.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(pts), training=True, mutable=["batch_stats"])
        prior = jinfo.prior_regularization_loss(info)
        return jnp.sum(xc * w) + prior, (xc, info.element.rotation, prior, upd)

    with jax.enable_x64(True):
        (_, (jxc, jrot, jprior, upd)), jgrads = jax.jit(
            jax.value_and_grad(jloss, has_aux=True))(variables["params"])
    xc, info = canon.canonicalize(_t(pts), training=True)
    prior = tp.prior_regularization_loss(info)
    (torch.sum(xc * _t(w)) + prior).backward()
    assert_margins(knn_inputs)
    np.testing.assert_allclose(xc.detach().numpy(), np.asarray(jxc), rtol=0, atol=1e-9)
    np.testing.assert_allclose(info.element.rotation.detach().numpy(), np.asarray(jrot),
                               rtol=0, atol=1e-9)
    assert prior.item() == pytest.approx(float(jprior), rel=1e-8)
    _close_tree(tp.flax_variables(canon)["batch_stats"], _tree(upd["batch_stats"]), 1e-6)
    _close_tree(_grad_tree(canon), _tree(jgrads), 1e-6, scale="tree")


def test_vnsmall_dropout_needs_a_generator_and_masks_by_it():
    pts = torch.randn(2, 24, 3)
    net = tp.VNSmall(4, device="cpu")  # dropout 0.5
    with pytest.raises(ValueError, match="generator"):
        net(pts, training=True)
    a = net(pts, training=True, generator=torch.Generator().manual_seed(1))
    b = net(pts, training=True, generator=torch.Generator().manual_seed(1))
    c = net(pts, training=True, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()


def _dropout_draws(key, B, N):
    r1, r2 = jax.random.split(key)
    return (np.asarray(jax.random.uniform(r1, (B, 1))),
            np.asarray(jax.random.uniform(r2, (B, N))))


def _scale_draws(key, B):
    r1, r2 = jax.random.split(key)
    return (np.asarray(jax.random.uniform(r1, (B, 1, 3))),
            np.asarray(jax.random.uniform(r2, (B, 1, 3))))


def test_augmentations_match_jax():
    """The port on the draws the JAX functions make from their keys (the
    same splits), then the ranges of the port's own draws."""
    pts = _x((4, 40, 3), seed=15)
    key = jax.random.key(16)
    ref = np.asarray(jpipe.random_point_dropout(key, jnp.asarray(pts)))
    ours = tpipe.random_point_dropout(_t(pts), draws=tuple(
        _t(d) for d in _dropout_draws(key, 4, 40)))
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert (ref == pts[:, :1]).all(-1).sum() > 4  # some points were dropped
    ref = np.asarray(jpipe.random_scale_shift(key, jnp.asarray(pts)))
    ours = tpipe.random_scale_shift(_t(pts), draws=tuple(
        _t(d) for d in _scale_draws(key, 4)))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-6)

    gen = torch.Generator().manual_seed(0)
    dropped = tpipe.random_point_dropout(_t(pts), generator=gen)
    kept = (dropped == _t(pts)).all(-1)
    first = (dropped == _t(pts)[:, :1]).all(-1)
    assert bool((kept | first).all()) and kept.float().mean() >= 0.125 - 0.05
    ones = torch.ones(64, 1, 3)
    scaled = tpipe.random_scale_shift(torch.zeros(64, 1, 3) + ones, generator=gen,
                                      shift_range=0.0)
    assert 0.8 <= scaled.min() and scaled.max() < 1.25
    shifted = tpipe.random_scale_shift(torch.zeros(64, 1, 3), generator=gen)
    assert -0.1 <= shifted.min() and shifted.max() < 0.1


def _pipelines(seed, partseg=False):
    """VNSmall (k 6, dropout 0) before DGCNN (5 classes) or DGCNNPartSeg
    (6 parts, 3 categories), k 6, emb 32, dropout 0, in both packages from
    one draw of Flax variables."""
    jcanon = jcan.EquivariantPointcloudCanonicalization(
        canonicalization_network=jnet.VNSmall(n_knn=6, dropout_rate=0.0))
    tcanon = tp.EquivariantPointcloudCanonicalization(
        tp.VNSmall(6, dropout_rate=0.0, device="cpu"))
    pts = jnp.zeros((2, 48, 3))
    if partseg:
        jmod = jpipe.PointcloudPartSegPipeline(
            canonicalizer=jcanon, prediction_network=jpn.DGCNNPartSeg(
                num_parts=6, num_categories=3, k=6, emb_dims=32, dropout=0.0))
        tmod = tp.PointcloudPartSegPipeline(tcanon, tp.DGCNNPartSeg(
            6, 3, 6, 32, dropout=0.0, device="cpu"))
        variables = jmod.init(KEY, pts, jnp.eye(3)[:2])
    else:
        jmod = jpipe.PointcloudClassificationPipeline(
            canonicalizer=jcanon, prediction_network=jpn.DGCNN(
                num_classes=5, k=6, emb_dims=32, dropout=0.0))
        tmod = tp.PointcloudClassificationPipeline(
            tcanon, tp.DGCNN(5, 6, 32, dropout=0.0, device="cpu"))
        variables = jmod.init(KEY, pts)
    variables = redrawn_variables(variables, seed)
    return jmod, variables, tp.load_flax_variables(tmod, variables)


def _held_by_norms(ours, ref, before):
    """A step's AdamW updates: a first step moves each element by about
    lr * sign(grad), so parameters whose gradients are rounding noise (the
    biases a BatchNorm cancels) may move either way; 97% of the elements
    within 1e-6 and each top-level module's update within 1% of its norm."""
    for top in ref:
        o = np.concatenate([(a - b).ravel() for a, b in zip(
            jax.tree_util.tree_leaves(ours[top]), jax.tree_util.tree_leaves(before[top]))])
        r = np.concatenate([(a - b).ravel() for a, b in zip(
            jax.tree_util.tree_leaves(ref[top]), jax.tree_util.tree_leaves(before[top]))])
        assert np.mean(np.abs(o - r) <= 1e-6) >= 0.97, top
        assert np.linalg.norm(o - r) <= 1e-2 * np.linalg.norm(r), top


def _jax_state(jmod, variables, lr=1e-3):
    tx = optax.adamw(lr)
    return jpipe.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]),
        tx=tx, apply_fn=jmod.apply)


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
def test_pointcloud_train_step_matches_jax(label_smoothing, knn_inputs,  # noqa: F811
                                           monkeypatch):
    """One `make_pointcloud_train_step` (z rotation, point dropout, scale and
    shift, prior weight 1, AdamW 1e-3) against JAX's in float64, each
    augmentation on the draws the JAX function makes from one fixed key."""
    jmod, variables, tmod = _pipelines(seed=17)
    variables = _f64(variables)
    tmod.double()
    B, N = 4, 48
    rng = np.random.default_rng(18)
    batch = {"points": (_x((B, N, 3), seed=19) * np.array([1.0, 0.6, 0.3])),
             "label": rng.integers(0, 5, B).astype(np.int32)}
    keys = jax.random.split(jax.random.key(20), 3)
    rotate, drop, scale = jpipe.random_rotate, jpipe.random_point_dropout, \
        jpipe.random_scale_shift
    monkeypatch.setattr(jpipe, "random_rotate", lambda r, p, mode: rotate(keys[0], p, mode))
    monkeypatch.setattr(jpipe, "random_point_dropout", lambda r, p: drop(keys[1], p))
    monkeypatch.setattr(jpipe, "random_scale_shift", lambda r, p: scale(keys[2], p))
    kw = dict(num_classes=5, prior_weight=1.0, label_smoothing=label_smoothing)
    with jax.enable_x64(True):
        jstate, jm = jpipe.make_pointcloud_train_step(**kw)(
            _jax_state(jmod, variables), {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.key(0))
        theta = _t(np.asarray(jax.random.uniform(keys[0], (B,))))
        drop_draws = tuple(_t(d) for d in _dropout_draws(keys[1], B, N))
        scale_draws = tuple(_t(d) for d in _scale_draws(keys[2], B))
    t_rotate, t_drop, t_scale = tpipe.random_rotate, tpipe.random_point_dropout, \
        tpipe.random_scale_shift
    monkeypatch.setattr(tpipe, "random_rotate",
                        lambda p, mode, generator=None: t_rotate(p, mode, draws=theta))
    monkeypatch.setattr(tpipe, "random_point_dropout",
                        lambda p, generator=None: t_drop(p, draws=drop_draws))
    monkeypatch.setattr(tpipe, "random_scale_shift",
                        lambda p, generator=None: t_scale(p, draws=scale_draws))
    state = tp.create_pointcloud_state(tmod, 1e-3)
    state, tm = tp.make_pointcloud_train_step(**kw)(
        state, {"points": _t(batch["points"]), "label": torch.from_numpy(batch["label"])})
    margins_past_duplicates(knn_inputs)
    assert state.step == 1 and set(tm) == set(jm)
    for key in jm:
        assert tm[key].item() == pytest.approx(float(jm[key]), rel=1e-6, abs=1e-12), key
    ours = tp.flax_variables(tmod)
    _close_tree(ours["batch_stats"], _tree(jstate.batch_stats), 1e-6)
    _held_by_norms(ours["params"], _tree(jstate.params), variables["params"])


def _jax_miou(logits, part_label, num_parts):
    """The JAX CLI's inline `eval_metrics`
    (examples/pointcloud/part_segmentation/train.py)."""
    acc = jnp.mean((jnp.argmax(logits, -1) == part_label).astype(jnp.float32))
    pred_cls = jnp.argmax(logits, -1)
    ious = []
    for p in range(num_parts):
        inter = jnp.sum((pred_cls == p) & (part_label == p))
        union = jnp.sum((pred_cls == p) | (part_label == p))
        ious.append(inter / jnp.maximum(union, 1))
    return acc, jnp.mean(jnp.stack(ious))


def test_partseg_metrics_match_the_jax_cli():
    rng = np.random.default_rng(21)
    logits = rng.normal(size=(3, 40, 7)).astype(np.float32)
    labels = rng.integers(0, 5, (3, 40)).astype(np.int32)  # parts 5, 6 absent
    ref = _jax_miou(jnp.asarray(logits), jnp.asarray(labels), 7)
    ours = tps.eval_metrics(_t(logits), torch.from_numpy(labels), 7)
    for o, r in zip(ours, ref):
        assert o.item() == pytest.approx(float(r), rel=1e-6)


def test_partseg_step_matches_the_jax_cli(knn_inputs, monkeypatch):  # noqa: F811
    """The CLI's step (z rotation, per-point cross entropy + prior, AdamW
    1e-3) against the JAX CLI's inline step, rebuilt from its parts, in
    float64 on the same rotation draws."""
    jmod, variables, tmod = _pipelines(seed=22, partseg=True)
    variables = _f64(variables)
    tmod.double()
    B, N = 3, 48
    rng = np.random.default_rng(23)
    batch = {"points": _x((B, N, 3), seed=24) * np.array([1.0, 0.6, 0.3]),
             "category": rng.integers(0, 3, B).astype(np.int32),
             "part_label": rng.integers(0, 6, (B, N)).astype(np.int32)}
    key = jax.random.key(25)
    jstate = _jax_state(jmod, variables)

    def jloss(params):
        pts = jpipe.random_rotate(key, jnp.asarray(batch["points"]), "z")
        oh = jax.nn.one_hot(batch["category"], 3)
        (logits, info), upd = jstate.apply_fn(
            {"params": params, "batch_stats": jstate.batch_stats}, pts, oh,
            training=True, mutable=["batch_stats"])
        task = jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            logits, batch["part_label"]))
        loss = task + jinfo.prior_regularization_loss(info)
        acc, miou = _jax_miou(logits, batch["part_label"], 6)
        return loss, ({"loss/total": loss, "metric/acc": acc, "metric/miou": miou},
                      upd["batch_stats"])

    with jax.enable_x64(True):
        (_, (jm, jbs)), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            jstate.params)
        jstate = jstate.apply_gradients(grads=grads)
        theta = _t(np.asarray(jax.random.uniform(key, (B,))))
    rotate = tps.random_rotate
    monkeypatch.setattr(tps, "random_rotate",
                        lambda p, mode, generator=None: rotate(p, mode, draws=theta))
    state = tp.create_pointcloud_state(tmod, 1e-3)
    state, tm = tps.make_partseg_train_step(3, 6)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert_margins(knn_inputs)
    assert set(tm) == set(jm)
    for k in jm:
        assert tm[k].item() == pytest.approx(float(jm[k]), rel=1e-6, abs=1e-12), k
    ours = tp.flax_variables(tmod)
    _close_tree(ours["batch_stats"], _tree(jbs), 1e-6)
    _held_by_norms(ours["params"], _tree(jstate.params), variables["params"])


def test_partseg_flax_variables_round_trip():
    """DGCNNPartSeg's Flax tree (TransformNet_0, Dense_0-Dense_10,
    BatchNorm_0-BatchNorm_9) into the port and back, leaf for leaf."""
    jmod = jpn.DGCNNPartSeg(num_parts=7, num_categories=4, k=4, emb_dims=16)
    variables = redrawn_variables(jmod.init(KEY, jnp.zeros((2, 16, 3)),
                                            jnp.eye(4)[:2]), seed=26)
    assert sorted(variables["params"]) == sorted(
        ["TransformNet_0"] + [f"Dense_{i}" for i in range(11)]
        + [f"BatchNorm_{i}" for i in range(10)])
    tmod = tp.load_flax_variables(tp.DGCNNPartSeg(7, 4, 4, 16, device="cpu"), variables)
    back = tp.flax_variables(tmod)
    _close_tree(back["params"], variables["params"], 0.0)
    _close_tree(back["batch_stats"], variables["batch_stats"], 0.0)
    del variables["params"]["Dense_10"]
    with pytest.raises(KeyError):
        tp.load_flax_variables(tp.DGCNNPartSeg(7, 4, 4, 16, device="cpu"), variables)


def test_knn_input_is_detached(monkeypatch):
    """A training forward through the plain K8 keeps no (B, N, N) tensor
    for the backward pass, and its gradients equal those with the indices
    computed apart."""
    torch.manual_seed(0)
    net = tp.DGCNN(5, 6, 32, dropout=0.0, device="cpu")
    pts = torch.randn(2, 40, 3)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = net(pts, training=True)
    assert saved and (2, 40, 40) not in saved
    out.sum().backward()
    grads = [p.grad.clone() for p in net.parameters()]
    net.zero_grad()
    calls = []
    run = tknn.knn_indices

    def apart(points, k):
        calls.append(points.requires_grad)
        return run(points.detach().clone(), k)

    monkeypatch.setattr(tknn, "knn_indices", apart)
    net(pts, training=True).sum().backward()
    assert calls == [False] * 4
    # within 1e-5 of the largest: the neighbour gather's backward accumulates
    # over threads, so two runs of one step differ by about 1e-6 on the CPU
    for g, p in zip(grads, net.parameters()):
        torch.testing.assert_close(p.grad, g, rtol=0, atol=1e-5 * g.abs().max().item())


def _write_h5(path, **arrays):
    import h5py

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with h5py.File(path, "w") as f:
        for k, v in arrays.items():
            f.create_dataset(k, data=v)


def test_loaders_match_jax(tmp_path):
    rng = np.random.default_rng(27)
    mn = tmp_path / "modelnet40_ply_hdf5_2048"
    for name, n in (("ply_data_train0.h5", 5), ("ply_data_train1.h5", 3),
                    ("ply_data_test0.h5", 4)):
        _write_h5(str(mn / name), data=rng.normal(size=(n, 40, 3)).astype(np.float32),
                  label=rng.integers(0, 40, (n, 1)).astype(np.uint8))
    sp = tmp_path / "shapenet_part_seg_hdf5_data"
    for split, n in (("train", 4), ("test", 2)):
        _write_h5(str(sp / f"ply_data_{split}0.h5"),
                  data=rng.normal(size=(n, 40, 3)).astype(np.float32),
                  label=rng.integers(0, 16, (n, 1)).astype(np.uint8),
                  pid=rng.integers(0, 50, (n, 40)).astype(np.uint8))

    def same(ours, ref):
        assert sorted(ours) == sorted(ref)
        for k in ref:
            assert ours[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(ours[k], ref[k])

    for o, r in zip(tdata.load_modelnet40(str(tmp_path), 32),
                    jdata.load_modelnet40(str(tmp_path), 32)):
        same(o, r)
    assert tdata.load_modelnet40(str(tmp_path), 32)[0]["points"].shape == (8, 32, 3)
    for split in ("train", "test"):
        same(tdata.load_shapenet_part(str(tmp_path), split, 24),
             jdata.load_shapenet_part(str(tmp_path), split, 24))
    x = rng.normal(size=(3, 40, 3)).astype(np.float32)
    np.testing.assert_array_equal(tdata.normalize_pointcloud(x),
                                  jdata.normalize_pointcloud(x))
    with pytest.raises(FileNotFoundError) as ours:
        tdata.load_modelnet40(str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError) as ref:
        jdata.load_modelnet40(str(tmp_path / "none"))
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("partseg", [False, True])
def test_step_flops_match_jax_count(partseg):
    """`count_flops` and `train_step_flops` of both point-cloud pipelines
    against JAX `count_flops` of the Flax ones with exact kNN less the
    closed form of its D > 4 distance products, 2 B N^2 D a graph (K8
    counts 0 in the port, as a Pallas call does in JAX; JAX's fused mode
    takes the exact path at some of these shapes, and its Pallas kernel
    has no reverse-mode rule): the forward equal, forward + backward
    within 1%."""
    from equiadapt_tpu.utils import flops as jflops

    jmod, variables, tmod = _pipelines(seed=28, partseg=partseg)
    B, N = 2, 48
    pts = np.zeros((B, N, 3), np.float32)
    args = (pts, np.eye(3, dtype=np.float32)[:B]) if partseg else (pts,)
    jargs = [jnp.asarray(a) for a in args]

    def jfwd(params, *a):
        return jmod.apply({"params": params,
                           "batch_stats": variables["batch_stats"]}, *a)[0]

    def jstep(params, *a):
        def loss(p):
            (out, _), _ = jmod.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                     *a, training=True, mutable=["batch_stats"])
            return jnp.sum(out ** 2)
        return jax.grad(loss)(params)

    knn_dims = (64, 64) if partseg else (64, 64, 128)
    knn_flops = sum(2 * B * N * N * d for d in knn_dims)
    ref_fwd = jflops.count_flops(jfwd, variables["params"], *jargs) - knn_flops
    ref_step = jflops.count_flops(jstep, variables["params"], *jargs) - knn_flops
    targs = [_t(a) for a in args]
    fwd = tflops.count_flops(lambda m, *a: m(*a)[0], tmod, *targs)
    step = tflops.train_step_flops(
        lambda m, *a: torch.sum(m(*a, training=True)[0] ** 2), tmod, *targs)
    assert fwd == ref_fwd
    assert step == pytest.approx(ref_step, rel=0.01)
    assert all(p.grad is None for p in tmod.parameters())
