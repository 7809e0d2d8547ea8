"""The continuous family's training half against the JAX package, on the
CPU: the same numpy inputs (from seeds) and the same Flax variables (copied
by `utils/jax_weights`) through both packages.

The JAX fast warp runs its three shears only on a TPU or in interpret mode;
elsewhere it takes a four-candidate blend plus a bilinear residual, another
forward. So the port's `warp_center_rotation_fast_diff` is held to the JAX
pieces that share its forward: the rotation's cotangent to
`_fast_diff_warp_bwd` fed the port's own forward output, the image's to the
interpret-mode fast warp of the cotangent by R^{-1}; and a whole JAX
canonicalizer in fast mode runs with
`equiadapt_tpu.ops.pallas.shear_rotate.warp_rotate_center_fast` patched to
its interpret mode for the test (the JAX package imports it at call time).

Bars (fp32):
* `NormBatchNorm` in training, output and running update: 1e-6 of the
  largest value;
* the fast warp's rotation cotangent: 1e-5 of its largest entry (a sum
  over every pixel); its image cotangent: 1e-5 on cotangents in [0, 1], as
  the K5 / K6 tests hold the fast warp;
* the fast warp's gradient quality, on the port's own functions, as
  `tests/test_fast_warp.py` holds the JAX ones: the rotation's gradient
  against autograd through the exact warp, cosine > 0.98 and norm ratio in
  (0.8, 1.25) per sample; the image cotangent an adjoint within rtol 0.05;
* `rotate`, `warp_affine`, `affine_grid_sample`, their image and
  coordinate gradients: 1e-5 of the largest value;
* the steerable canonicalizer with training=True (canonicalize, then the
  scalar invert of the canonical image), exact and fast: matrices within
  1e-5, warped images within 1e-5 plus what the two frames' angle gap
  moves a pixel (`_warp_bar`), parameter gradients within 1e-4 of the
  largest gradient (a leaf's own largest value where that is rounding
  noise: the coefficients of the second frame vector in roto-reflection
  fast mode, about 4e-6), NormBatchNorm statistics within 1e-6;
* the optimized steerable canonicalizer with given draws (angles,
  reflections and, in training, the dropout mask): matrices within 1e-5,
  the canonical image as above, `steerable_optimization_loss` to rel 1e-5,
  gradients within 1e-4 of the largest gradient (the conv bias before a
  train-mode BatchNorm is cancelled: its gradient is rounding noise,
  1e-7), BatchNorm statistics within 1e-5. Roto-reflection in training is
  ill-conditioned at this draw (two samples' frame vectors 0.34 and 0.75
  degrees apart, which Gram-Schmidt divides by): matrices within 2e-5
  (measured 1.3e-5), gradients within 5e-3 of the largest (measured
  1.6e-3);
* one `make_train_step` with the steerable canonicalizer before ResNet-18
  against JAX's: loss and metrics to rel 1e-5 or 1e-6 absolute, gradient
  norms to rel 1e-3 (ResNet-18's ReLU branches; see the test), the
  BatchNorm and
  NormBatchNorm statistics within 1e-5.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equiadapt_tpu.images.canonicalization import continuous_group as jcg
from equiadapt_tpu.images.canonicalization.continuous_group import (
    _warp_center_affine as j_warp_center_affine,
)
from equiadapt_tpu.images.networks.conv import ConvNetwork as JConv
from equiadapt_tpu.images.networks.steerable import NormBatchNorm as JNormBN
from equiadapt_tpu.images.networks.steerable import SteerableNetwork as JNet
from equiadapt_tpu.models import ResNet18 as JResNet18
from equiadapt_tpu.ops import warp as jwarp
from equiadapt_tpu.ops.pallas import shear_rotate as jsr
from equiadapt_tpu.pipelines import classification as jcls
import equiadapt_tpu_torch as tp
from equiadapt_tpu_torch.images.networks import steerable as tst
from equiadapt_tpu_torch.ops import warp as twarp
from equiadapt_tpu_torch.ops.kernels import _build
from equiadapt_tpu_torch.ops.kernels import bilinear_warp as tbw
from equiadapt_tpu_torch.ops.kernels import shear_rotate as tsr
from equiadapt_tpu_torch.pipelines import classification as tcls
from equiadapt_tpu_torch.utils import registry as treg
from test_torch_port_optimized import random_variables
from test_torch_port_steerable import _redraw, _smooth
from test_torch_port_train import _close_tree, _grad_tree
from test_fast_warp import _smooth_images
from torch_port_cpu import one_intra_op_thread  # noqa: F401

IMG = 32
NET = dict(in_channels=3, out_channels=4, kernel_size=5, num_layers=1)
CLS_CFG = Path(__file__).resolve().parents[1] / "examples/images/classification/configs"


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _close(ours, ref, rel):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(ours, np.float32), ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-30))


def _warp_bar(t_rep, j_rep, j_out):
    """The bar on a warped image: 1e-5, plus what the gap between the two
    packages' frames moves a pixel: the largest angle gap of the first
    frame vectors, times the largest lever (a corner's distance from the
    centre), times the reference image's largest one-pixel step (the
    zero-filled invert's edges included). Measured: train-mode BatchNorm
    over 2B = 8 samples (the optimized canonicalizer) leaves a 5.2e-6 rad
    gap and 1.6e-5 on the canonical image; a 5.5e-7 rad gap moves the
    zero-filled invert's edges by 1.3e-5 (roto-reflection, exact)."""
    t_rep, j_rep, j_out = (np.asarray(a, np.float64) for a in (t_rep, j_rep, j_out))
    ang = lambda m: np.arctan2(m[:, 1, 0], m[:, 0, 0])
    gap = np.abs(np.angle(np.exp(1j * (ang(t_rep) - ang(j_rep))))).max()
    lever = np.hypot(j_out.shape[1] / 2.0, j_out.shape[2] / 2.0)
    step = max(np.abs(np.diff(j_out, axis=1)).max(), np.abs(np.diff(j_out, axis=2)).max())
    return 1e-5 + gap * lever * step


def _rotations(theta):
    th = np.asarray(theta, np.float32)
    c, s = np.cos(th), np.sin(th)
    return np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)


@pytest.fixture
def interpret_fast_warp(monkeypatch):
    """The JAX fast warp in interpret mode (three shears) off a TPU."""
    monkeypatch.setattr(jsr, "warp_rotate_center_fast",
                        functools.partial(jsr.warp_rotate_center_fast, interpret=True))


# ------------------------------------------------------------ NormBatchNorm


def test_norm_batchnorm_training_matches_flax():
    orders = (0, 0, 1, 1, 2, 2)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 6, 7, 10)).astype(np.float32)  # NHWC, 10 channels
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32)},
                 "batch_stats": {"norm_sq": rng.uniform(0.5, 1.5, 6).astype(np.float32)}}
    jbn = JNormBN(orders=orders)
    jy, upd = jbn.apply(variables, jnp.asarray(x), training=True,
                        mutable=["batch_stats"])
    tbn = tst.NormBatchNorm(orders, device="cpu")
    with torch.no_grad():
        tbn.scale.copy_(_t(variables["params"]["scale"]))
        tbn.norm_sq.copy_(_t(variables["batch_stats"]["norm_sq"]))
    ty = tbn(_t(x).permute(0, 3, 1, 2), training=True).permute(0, 2, 3, 1)
    _close(ty.detach().numpy(), jy, 1e-6)
    _close(tbn.norm_sq.numpy(), upd["batch_stats"]["norm_sq"], 1e-6)
    # eval reads the updated running statistic, as Flax does
    jy_eval = jbn.apply({"params": variables["params"], **_np(upd)}, jnp.asarray(x))
    with torch.no_grad():
        ty_eval = tbn(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(ty_eval.numpy(), jy_eval, 1e-6)


def test_steerable_network_passes_training_down():
    net = tp.SteerableNetwork(**NET, device="cpu")
    x = torch.rand(3, 16, 16, 3)
    before = net.NormBatchNorm_0.norm_sq.clone()
    with torch.no_grad():
        v_eval = net(x)
        assert torch.equal(net.NormBatchNorm_0.norm_sq, before)
        v_train = net(x, training=True)
    assert not torch.equal(net.NormBatchNorm_0.norm_sq, before)
    assert not torch.allclose(v_eval, v_train)


# --------------------------------------------- the differentiable fast warp


def _fast_inputs(seed, size, dtype=torch.float32, C=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(4, size, size, C)).astype(np.float32)
    g = rng.uniform(size=x.shape).astype(np.float32)
    theta = rng.uniform(-np.pi, np.pi, size=4).astype(np.float32)
    theta[0] = np.pi / 2  # a quarter turn
    return _t(x).to(dtype), _t(_rotations(theta)), _t(g).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", [16, 17])
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_fast_diff_rotation_cotangent_matches_jax_backward(padding, size, dtype):
    """Rbar against `_fast_diff_warp_bwd` fed the port's own forward output
    (fp32 R; bf16 image and cotangent in the serving dtype: the backward
    works in promote(out.dtype, fp32) in both)."""
    x, R, g = _fast_inputs(size, size, dtype)
    R.requires_grad_(True)
    out = twarp.warp_center_rotation_fast_diff(x, R, padding)
    assert out.dtype == dtype
    (rbar,) = torch.autograd.grad(out, R, g)
    jout = jnp.asarray(out.detach().float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    jg = jnp.asarray(g.float().numpy()).astype(jout.dtype)
    _, ref = jwarp._fast_diff_warp_bwd(padding, (jnp.asarray(R.detach().numpy()), jout), jg)
    assert rbar.dtype == torch.float32
    _close(rbar.numpy(), ref, 1e-5)


@pytest.mark.parametrize("size", [16, 17])
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_fast_diff_image_cotangent_is_the_inverse_fast_warp(padding, size):
    x, R, g = _fast_inputs(size + 40, size)
    x.requires_grad_(True)
    out = twarp.warp_center_rotation_fast_diff(x, R, padding)
    (xbar,) = torch.autograd.grad(out, x, g)
    Rj = jnp.asarray(R.numpy())
    det = Rj[:, 0, 0] * Rj[:, 1, 1] - Rj[:, 0, 1] * Rj[:, 1, 0]
    Rinv = jnp.stack([jnp.stack([Rj[:, 1, 1] / det, -Rj[:, 0, 1] / det], -1),
                      jnp.stack([-Rj[:, 1, 0] / det, Rj[:, 0, 0] / det], -1)], -2)
    ref = jsr.warp_rotate_center_fast(jnp.asarray(g.numpy()), Rinv, "zeros",
                                      interpret=True)
    np.testing.assert_allclose(xbar.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_fast_diff_needs_no_image_cotangent_for_the_rotation_alone(monkeypatch):
    """The image's cotangent (a second fast warp) is computed only where the
    image needs a gradient."""
    calls = []
    monkeypatch.setattr(twarp, "_fast_diff_warp_xbar",
                        lambda R, g: calls.append(1) or torch.zeros_like(g))
    x, R, g = _fast_inputs(1, 16)
    R.requires_grad_(True)
    out = twarp.warp_center_rotation_fast_diff(x, R, "border")
    torch.autograd.grad(out, R, g)
    assert calls == []
    x.requires_grad_(True)
    out = twarp.warp_center_rotation_fast_diff(x, R, "border")
    torch.autograd.grad(out, [x, R], g)
    assert calls == [1]


def test_fast_diff_forward_is_the_fast_warp():
    x, R, _ = _fast_inputs(2, 17)
    ref = tsr.warp_rotate_center_fast(x, R, "border")
    out = twarp.warp_center_rotation_fast_diff(x.requires_grad_(True),
                                               R.requires_grad_(True), "border")
    assert torch.equal(out.detach(), ref) and out.grad_fn is not None


def _quality(exact_grad, fast_grad):
    """Per sample: the cosine of the two R-gradients and the norm ratio
    fast / exact."""
    ge, gf = (np.asarray(g, np.float64).reshape(len(g), -1) for g in (exact_grad, fast_grad))
    cos = np.sum(ge * gf, 1) / (np.linalg.norm(ge, axis=1) * np.linalg.norm(gf, axis=1))
    return cos, np.linalg.norm(gf, axis=1) / np.linalg.norm(ge, axis=1)


def _quality_inputs():
    """tests/test_fast_warp.py's smooth images, weights and angles."""
    x = _t(np.asarray(_smooth_images(jax.random.key(21), 4, 64)))
    weight = _t(np.asarray(_smooth_images(jax.random.key(22), 4, 64)))
    return x, weight, _t(_rotations([0.25, -0.9, 1.7, 2.9]))


def _r_gradient(warp, x, weight, R0):
    R = R0.clone().requires_grad_(True)
    (gr,) = torch.autograd.grad(torch.sum(warp(x, R, "border") * weight), R)
    return gr.numpy()


def test_fast_diff_rotation_gradient_tracks_the_exact_warp():
    """tests/test_fast_warp.py's bound (cosine > 0.98, norm ratio in
    (0.8, 1.25)) on the port: the closed-form R-gradient of the fast warp
    against autograd through the exact warp, on that test's images and
    angles, with the loss weight zero outside the inscribed disk
    (radius W / 2).

    Why the disk: the three-shear forward (the port's, and the JAX
    package's on a TPU or in interpret mode) applies the border clamp at
    each pass, the exact warp once. Inside the disk the two forwards agree
    within 0.0104 (mean 1e-3); in the corners, which sample outside the
    image, they differ by up to 0.73 at the 52-degree sample (residual -38
    degrees), and the corners carry the largest lever u = R^{-1}(p - c).
    The full-image bound of test_fast_warp.py holds there only for the
    forward the JAX package takes off a TPU (a blend plus a bilinear
    residual: cosines 0.9993-0.99997). With the full-image loss the
    three-shear forward gives cosine 0.851 and ratio 1.555 at that sample,
    the JAX package's function and the port's alike
    (`test_fast_diff_full_image_quality_equals_the_jax_backward`); inside
    the disk the cosines are 0.9996-0.9999 and the ratios 0.985-1.019."""
    x, weight, R = _quality_inputs()
    yy, xx = torch.meshgrid(torch.arange(64.0), torch.arange(64.0), indexing="ij")
    disk = (((yy - 32) ** 2 + (xx - 32) ** 2) < 32 ** 2).float()[None, :, :, None]
    ge = _r_gradient(tbw._warp_center_affine, x, weight * disk, R)
    gf = _r_gradient(twarp.warp_center_rotation_fast_diff, x, weight * disk, R)
    assert np.isfinite(gf).all()
    cos, ratio = _quality(ge, gf)
    assert (cos > 0.98).all(), cos
    assert ((0.8 < ratio) & (ratio < 1.25)).all(), ratio


def test_fast_diff_full_image_quality_equals_the_jax_backward(interpret_fast_warp):
    """With the full-image loss of test_fast_warp.py, the port's gradient
    quality is the JAX package's on the same three-shear forward: cosine
    and norm ratio per sample within 1e-5 of the JAX function's (its fast
    warp in interpret mode), the measured values of the docstring above
    included."""
    x, weight, R = _quality_inputs()
    ge = _r_gradient(tbw._warp_center_affine, x, weight, R)
    gf = _r_gradient(twarp.warp_center_rotation_fast_diff, x, weight, R)
    jx, jw = jnp.asarray(x.numpy()), jnp.asarray(weight.numpy())
    j_ge, j_gf = (np.asarray(jax.grad(lambda Rm, f=f: jnp.sum(f(jx, Rm, "border") * jw))(
        jnp.asarray(R.numpy()))) for f in (j_warp_center_affine,
                                          jwarp.warp_center_rotation_fast_diff))
    cos, ratio = _quality(ge, gf)
    j_cos, j_ratio = _quality(j_ge, j_gf)
    np.testing.assert_allclose(cos, j_cos, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ratio, j_ratio, rtol=0, atol=1e-5)
    assert (cos[[0, 2, 3]] > 0.98).all(), cos


def test_fast_diff_image_cotangent_is_near_adjoint():
    """<g, W(x)> ~ <W^T(g), x> for rotations, on test_fast_warp.py's
    smooth images and angles."""
    x = _t(np.asarray(_smooth_images(jax.random.key(23), 2, 64))).requires_grad_(True)
    g = _t(np.asarray(_smooth_images(jax.random.key(24), 2, 64)))
    R = _t(_rotations([0.35, -1.1]))
    y = twarp.warp_center_rotation_fast_diff(x, R, "zeros")
    (xbar,) = torch.autograd.grad(y, x, g)
    lhs = float(torch.sum(g * y.detach()))
    rhs = float(torch.sum(xbar * x.detach()))
    np.testing.assert_allclose(lhs, rhs, rtol=0.05)


# ------------------------------------------------------------ affine warps


def _warp_args(fn, rng, B):
    """The warp's coordinate argument (numpy) and keyword arguments."""
    if fn == "rotate":
        return np.array([17.0, -100.0, 243.0], np.float32)[:B], {}
    if fn == "warp_affine":
        R = _rotations([0.3, -1.2, 2.2]) * np.float32(1.1)
        t = rng.uniform(-2, 2, size=(B, 2, 1)).astype(np.float32)
        return np.concatenate([R, t], -1), {"dsize": (10, 11)}
    theta = _rotations([0.4, -0.7, 1.9]) * np.float32(0.9)
    t = rng.uniform(-0.2, 0.2, size=(B, 2, 1)).astype(np.float32)
    return np.concatenate([theta, t], -1), {}


@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("fn", ["rotate", "warp_affine", "affine_grid_sample"])
def test_affine_warps_and_their_gradients_match_jax(fn, padding):
    rng = np.random.default_rng(len(fn) + len(padding))
    B = 3
    x = rng.normal(size=(B, 12, 13, 2)).astype(np.float32)
    p, kw = _warp_args(fn, rng, B)
    out_hw = kw.get("dsize", (12, 13))
    w = rng.normal(size=(B,) + tuple(out_hw) + (2,)).astype(np.float32)
    jfn, tfn = getattr(jwarp, fn), getattr(twarp, fn)

    def jloss(xx, pp):
        y = jfn(xx, pp, padding_mode=padding, **kw)
        return jnp.sum(y * w), y

    (_, jy), (jgx, jgp) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(p))
    tx, tpp = _t(x).requires_grad_(True), _t(p).requires_grad_(True)
    ty = tfn(tx, tpp, padding_mode=padding, **kw)
    tgx, tgp = torch.autograd.grad(torch.sum(ty * _t(w)), [tx, tpp])
    assert ty.shape == jy.shape
    _close(ty.detach().numpy(), jy, 1e-5)
    _close(tgx.numpy(), jgx, 1e-5)
    _close(tgp.numpy(), jgp, 1e-5)


# ------------------------------------------- the steerable canonicalizer


def _canon_kwargs(group_type, warp_mode):
    return dict(in_shape=(IMG, IMG, 3), input_crop_ratio=0.9, resize_shape=16,
                group_type=group_type, warp_mode=warp_mode)


CASES = [("rotation", "exact"), ("roto-reflection", "exact"),
         ("rotation", "fast"), ("roto-reflection", "fast")]


@pytest.mark.parametrize("group_type,warp_mode", CASES)
def test_steerable_training_matches_jax(group_type, warp_mode, interpret_fast_warp):
    """canonicalize(training=True), then the scalar invert (training=True)
    of a map made from the canonical image, so the image cotangent of the
    canonicalizing warp is on the gradient's path; the loss of bench.py's
    steer_train plus the invert's term."""
    rng = np.random.default_rng(len(group_type) + len(warp_mode))
    x = _smooth(rng, 4, IMG)
    wx = rng.normal(size=x.shape).astype(np.float32)
    wy = rng.normal(size=x.shape).astype(np.float32)
    kw = _canon_kwargs(group_type, warp_mode)
    jcanon = jcg.SteerableImageCanonicalization(canonicalization_network=JNet(**NET), **kw)
    variables = _redraw(jcanon.init(jax.random.key(3), jnp.asarray(x)), seed=7)

    def jloss(params):
        vs = {"params": params, "batch_stats": variables["batch_stats"]}
        (xc, info), upd = jcanon.apply(vs, jnp.asarray(x), training=True,
                                       mutable=["batch_stats"])
        yi = jcanon.apply(vs, info, xc, induced_rep_type="scalar",
                          training=True,
                          method=jcg.SteerableImageCanonicalization.invert_canonicalization)
        loss = (jnp.sum(xc * wx) + jnp.sum(yi * wy)
                + 1e-3 * jnp.sum(info.matrix_rep ** 2))
        return loss, (xc, yi, info.matrix_rep, upd)

    (jl, (jxc, jyi, jrep, upd)), jgrads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(variables["params"])

    tcanon = tp.load_flax_variables(
        tp.SteerableImageCanonicalization(tp.SteerableNetwork(**NET, device="cpu"), **kw),
        variables)
    xc, info = tcanon.canonicalize(_t(x), training=True)
    yi = tcanon.invert_canonicalization(info, xc, "scalar", training=True)
    loss = (torch.sum(xc * _t(wx)) + torch.sum(yi * _t(wy))
            + 1e-3 * torch.sum(info.matrix_rep ** 2))
    loss.backward()
    rep = info.matrix_rep.detach().numpy()
    np.testing.assert_allclose(rep, np.asarray(jrep), rtol=0, atol=1e-5)
    for ours, ref in ((xc, jxc), (yi, jyi)):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=0,
                                   atol=_warp_bar(rep, jrep, ref))
    assert loss.item() == pytest.approx(float(jl), rel=1e-5, abs=1e-4)
    _close_tree(tp.flax_variables(tcanon)["batch_stats"], _np(upd["batch_stats"]), 1e-6)
    _close_tree(_grad_tree(tcanon), _np(jgrads), 1e-4, scale="tree")


def test_fast_training_warps_through_the_differentiable_warp():
    """Fast mode: training takes `warp_center_rotation_fast_diff`
    (canonicalize and invert), eval the fast warp; exact mode: training
    takes `_warp_center_affine`, eval K7's wrapper."""
    net = tp.SteerableNetwork(**NET, device="cpu")
    x = torch.rand(2, IMG, IMG, 3)
    for mode, train_fn in (("fast", "_FastDiffWarpBackward"),
                           ("exact", None)):
        canon = tp.SteerableImageCanonicalization(net, **_canon_kwargs("rotation", mode))
        xc, info = canon.canonicalize(x, training=True)
        yi = canon.invert_canonicalization(info, xc, "scalar", training=True)
        for t in (xc, yi):
            assert t.grad_fn is not None
            if train_fn:
                assert type(t.grad_fn).__name__ == train_fn
            else:
                assert "FastDiff" not in type(t.grad_fn).__name__


# ------------------------------- the optimized steerable canonicalizer


def _draws(rng, B, group_type):
    u = rng.uniform(size=B).astype(np.float32)
    bits = rng.integers(0, 2, size=B).astype(np.int32)
    return u, (bits if group_type == "roto-reflection" else None)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("group_type", ["rotation", "roto-reflection"])
def test_optimized_steerable_matches_jax(group_type, training, monkeypatch):
    """The JAX module draws its angles, reflections and dropout mask from
    `jax.random`; the test hands both packages the same numpy draws."""
    rng = np.random.default_rng(5 + training + 2 * (group_type == "rotation"))
    B = 4
    x = _smooth(rng, B, IMG)
    u, bits = _draws(rng, B, group_type)
    net_kw = dict(in_channels=3, out_channels=8, kernel_size=3, num_layers=2,
                  out_vector_size=4)
    kw = _canon_kwargs(group_type, "exact")
    jcanon = jcg.OptimizedSteerableImageCanonicalization(
        canonicalization_network=JConv(**net_kw), **kw)
    variables = random_variables(jcanon, jnp.asarray(x), seed=11)
    features = 8 * 3 * 3
    keep = rng.uniform(size=(2 * B, features)) < 0.5
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=(), *a, **k: jnp.asarray(u))
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, minval, maxval, *a, **k: jnp.asarray(bits))
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p=0.5, shape=None, *a, **k: jnp.asarray(keep))

    def jloss(params):
        vs = {"params": params, "batch_stats": variables["batch_stats"]}
        (xc, info), upd = jcanon.apply(
            vs, jnp.asarray(x), training=training, mutable=["batch_stats"],
            rngs={"augment": jax.random.key(0), "dropout": jax.random.key(1)})
        loss = (jcg.steerable_optimization_loss(info)
                + 1e-2 * jnp.sum(info.matrix_rep ** 2))
        return loss, (xc, info, upd)

    (jl, (jxc, jinf, upd)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        variables["params"])

    net = tp.ConvNetwork(**net_kw, input_size=16, device="cpu")
    mask = torch.from_numpy(keep)
    net.Dropout_0.forward = (lambda y, training=False, generator=None:
                             torch.where(mask, y / 0.5, torch.zeros_like(y))
                             if training else y)
    tcanon = tp.load_flax_variables(
        tp.OptimizedSteerableImageCanonicalization(net, **kw), variables)
    angles = _t(u) * 2.0 * np.pi
    reflect = None if bits is None else _t(bits) * 2.0 - 1.0
    tcanon._draw_augmentation = lambda B_, gen: (angles, reflect)
    xc, info = tcanon.canonicalize(_t(x), training=training,
                                   generator=torch.Generator())
    loss = (tp.steerable_optimization_loss(info)
            + 1e-2 * torch.sum(info.matrix_rep ** 2))
    loss.backward()
    np.testing.assert_allclose(
        xc.detach().numpy(), np.asarray(jxc), rtol=0,
        atol=_warp_bar(info.matrix_rep.detach().numpy(), jinf.matrix_rep, jxc))
    # In training, roto-reflection: train-mode BatchNorm leaves two of the
    # 2B samples' two frame vectors 0.34 and 0.75 degrees apart (sin 0.0059
    # and 0.0131), and the Gram-Schmidt step divides by the second vector's
    # orthogonal residual: the frames measured 1.3e-5 apart in one entry,
    # the gradients 1.6e-3 of the largest (Conv_0's kernel). Every other
    # case: sin >= 0.21.
    ill_conditioned = training and group_type == "roto-reflection"
    bar = 2e-5 if ill_conditioned else 1e-5
    for key in ("matrix_rep_augmented", "matrix_rep_augmented_gt"):
        np.testing.assert_allclose(info.extras[key].detach().numpy(),
                                   np.asarray(jinf.extras[key]), rtol=0, atol=bar)
    np.testing.assert_allclose(info.matrix_rep.detach().numpy(),
                               np.asarray(jinf.matrix_rep), rtol=0, atol=bar)
    assert tp.steerable_optimization_loss(info).item() == pytest.approx(
        float(jcg.steerable_optimization_loss(jinf)), rel=1e-5)
    assert loss.item() == pytest.approx(float(jl), rel=1e-5)
    _close_tree(_grad_tree(tcanon), _np(jgrads), 5e-3 if ill_conditioned else 1e-4,
                scale="tree")
    _close_tree(tp.flax_variables(tcanon)["batch_stats"], _np(upd["batch_stats"]), 1e-5)


def test_optimized_steerable_draws_from_the_generator():
    net = tp.ConvNetwork(3, 8, 3, num_layers=2, out_vector_size=4, input_size=16,
                         device="cpu")
    canon = tp.OptimizedSteerableImageCanonicalization(
        net, **_canon_kwargs("roto-reflection", "exact"))
    x = torch.rand(3, IMG, IMG, 3)
    with pytest.raises(ValueError, match="generator"):
        canon.canonicalize(x)
    runs = [canon.canonicalize(x, generator=torch.Generator().manual_seed(s))[1]
            for s in (0, 0, 1)]
    gts = [i.extras["matrix_rep_augmented_gt"] for i in runs]
    assert torch.equal(gts[0], gts[1]) and not torch.equal(gts[0], gts[2])
    # the draws: angles in [0, 2 pi), then a reflection sign (+-1) for the
    # (0, 0) entry of the sampling matrix theta, which the ground truth
    # takes with the transpose trick (as the JAX module builds it)
    gen = torch.Generator().manual_seed(0)
    angles = torch.rand(3, generator=gen) * 2.0 * np.pi
    sign = torch.randint(0, 2, (3,), generator=gen).float() * 2.0 - 1.0
    c, s = torch.cos(angles), torch.sin(angles)
    want = torch.stack([torch.stack([c * sign, s], -1), torch.stack([-s, c], -1)], -2)
    assert torch.equal(gts[0], want)


def test_registry_builds_the_optimized_steerable_canonicalizer():
    """opt_steerable.yaml through the port's registry: a ConvNetwork (a
    4-vector: two frame vectors) in an OptimizedSteerableImageCanonicalization
    that trains on `steerable_optimization_loss`."""
    cfg = tp.compose_config([f"config={CLS_CFG / 'default.yaml'}",
                             "canonicalization=opt_steerable"],
                            config_dir=str(CLS_CFG))
    c = cfg.canonicalization
    in_shape = (IMG, IMG, 3)
    net = treg.get_image_canonicalization_network(c, in_shape, device="cpu")
    canon = treg.get_image_canonicalizer(c, net, in_shape, device="cpu")
    assert isinstance(canon, tp.OptimizedSteerableImageCanonicalization)
    assert isinstance(net, tp.ConvNetwork)
    x = torch.rand(2, IMG, IMG, 3)
    _, info = canon.canonicalize(x, training=True,
                                 generator=torch.Generator().manual_seed(0))
    logits = torch.randn(2, 10, requires_grad=True)
    loss, metrics = tcls.classification_loss(
        logits, torch.zeros(2, dtype=torch.int64), info, group_contrast_weight=1.0,
        canonicalization_type="opt_steerable")
    loss.backward()
    assert "loss/group_contrast" in metrics
    assert all(p.grad is not None for p in net.parameters())


# ------------------------------------------------------------ train step


def _steerable_pipelines(seed, warp_mode):
    canon_kw = _canon_kwargs("rotation", warp_mode)
    jpipe = jcls.ImageClassifierPipeline(
        canonicalizer=jcg.SteerableImageCanonicalization(
            canonicalization_network=JNet(**NET), **canon_kw),
        prediction_network=JResNet18(num_classes=10, small_images=True))
    variables = random_variables(jpipe, jnp.zeros((2, IMG, IMG, 3)), seed=seed)
    tpipe = tcls.ImageClassifierPipeline(
        tp.SteerableImageCanonicalization(tp.SteerableNetwork(**NET, device="cpu"),
                                          **canon_kw),
        tp.ResNet18(num_classes=10, small_images=True, device="cpu"))
    return jpipe, variables, tp.load_flax_variables(tpipe, variables)


@pytest.mark.parametrize("warp_mode", ["exact", "fast"])
def test_train_step_with_the_steerable_canonicalizer_matches_jax(
        warp_mode, interpret_fast_warp):
    """One `make_train_step` (SGD + decay for ResNet-18, AdamW for the
    canonicalizer, prior weight 100, gradient norms) against JAX's: the loss
    and the other metrics to rel 1e-5 (or 1e-6 absolute: the identity
    metric, about 0.01, is a difference of order-one matrix entries whose
    fp32 ulp is 6e-8; measured 1.2e-7 apart), the gradient norms to rel
    1e-3, the statistics within 1e-5.

    Why 1e-3 for the norms: ResNet-18's backward is not elementwise
    reproducible in fp32 (a ReLU input within rounding of 0 takes the other
    branch in one framework, `tests/test_torch_port_train.py`). Measured in
    exact mode: the prediction network's gradient norm 1.3e-4 apart, the
    canonicalizer's 1.2e-4; with the prior loss alone (no ResNet on the
    gradient's path) the canonicalizer's norm is 1.9e-7 apart."""
    jpipe, variables, tpipe = _steerable_pipelines(60, warp_mode)
    rng = np.random.default_rng(61)
    batch = {"image": _smooth(rng, 4, IMG),
             "label": rng.integers(0, 10, size=4).astype(np.int32)}
    opt_kw = dict(architecture="resnet50", dataset_name="cifar10",
                  learning_rate=0.05, milestones=(1,))
    loss_kw = {"prior_weight": 100.0}
    tx = jcls.make_optimizer(**opt_kw)
    jstate = jcls.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]),
        tx=tx, apply_fn=jpipe.apply)
    jstate, jm = jcls.make_train_step(loss_kw, watch_gradients=True)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0))

    state = tcls.create_train_state(tpipe, tcls.make_optimizer(tpipe, **opt_kw))
    state, tm = tcls.make_train_step(loss_kw, watch_gradients=True)(
        state, {"image": _t(batch["image"]), "label": torch.from_numpy(batch["label"])})
    assert state.step == 1
    assert set(tm) == set(jm)
    for key in jm:
        rel = 1e-3 if key.startswith("grad/") else 1e-5
        assert tm[key].item() == pytest.approx(float(jm[key]), rel=rel, abs=1e-6), key
    _close_tree(tp.flax_variables(tpipe)["batch_stats"], _np(jstate.batch_stats), 1e-5)


# ------------------------------------------------------ the gradient guard


def test_direct_fast_warp_on_the_card_still_refuses_grad(monkeypatch):
    """A direct call of the fast warp on a CUDA input that requires grad
    raises before it launches; the differentiable warp runs the same
    kernels with grad mode off in its forward and on the cotangent."""
    monkeypatch.setattr(_build, "route", lambda tensors, kernels: "cuda")
    launched = []

    def stub(name):
        def launch(x, *args):
            launched.append(name)
            return torch.zeros_like(x)
        return launch

    monkeypatch.setattr(tsr, "_launch_select", stub("K5"))
    monkeypatch.setattr(tsr, "_launch_shear", stub("K6"))
    x = torch.rand(2, 8, 8, 3, requires_grad=True)
    R = _t(_rotations([0.3, 2.0])).requires_grad_(True)
    with pytest.raises(RuntimeError, match="warp_center_rotation_fast_diff"):
        tsr.warp_rotate_center_fast(x, R)
    assert launched == []
    out = twarp.warp_center_rotation_fast_diff(x, R)
    assert launched == ["K5", "K6"]
    torch.autograd.grad(out, [x, R], torch.ones_like(out))
    assert launched == ["K5", "K6", "K5", "K6"]
