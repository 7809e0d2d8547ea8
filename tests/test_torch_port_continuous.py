"""Port kernels K5, K6 and K7 (plain PyTorch versions), the continuous
warps around them, and the continuous infos and frame math, against the
JAX package on the same numpy inputs.

The JAX fast warp runs its three shears only on a TPU or in interpret mode
(elsewhere it takes a blend plus a bilinear residual), so every fast-mode
reference here is `interpret=True`. Bars:
* K5 (pure data movement): bit-identical to the Pallas kernel and to
  `_rot90_centered`, fp32 and bf16;
* K6: fp32 within 1e-5 on inputs in [0, 1] (tan / sin and the shear
  products may round differently in XLA and PyTorch), bf16 within 4e-3
  (one bf16 ulp below 1);
* `warp_rotate_center_fast`, per-sample angles over the full circle:
  within 1e-5 on inputs in [0, 1];
* K7: rtol 1e-4, atol 1e-5 against the Pallas kernel and the XLA taps
  form, as the JAX package's own test holds them (the same taps, summed in
  another order on the TPU's path);
* a NaN rotation gives NaN pixels in the plain versions, and only in its
  own sample.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equiadapt_tpu.common import info as jinfo
from equiadapt_tpu.common import math as jmath
from equiadapt_tpu.images.canonicalization.continuous_group import (
    _warp_center_affine as j_warp_center_affine,
)
from equiadapt_tpu.ops.pallas import bilinear_warp as jbw
from equiadapt_tpu.ops.pallas import shear_rotate as jsr
from equiadapt_tpu.ops.warp import bilinear_sample as j_bilinear_sample
from equiadapt_tpu_torch.common import info as tinfo
from equiadapt_tpu_torch.common import math as tmath
from equiadapt_tpu_torch.ops.kernels import bilinear_warp as tbw
from equiadapt_tpu_torch.ops.kernels import shear_rotate as tsr
from equiadapt_tpu_torch.ops.warp import bilinear_sample
from torch_port_cpu import one_intra_op_thread  # noqa: F401

DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    _, jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), _t(x).to(tdt)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, dtype=np.float32)


def _rotations(theta, reflect=False):
    th = np.asarray(theta, np.float32)
    c, s = np.cos(th), np.sin(th)
    if reflect:  # det -1: a rotation times diag(1, -1)
        return np.stack([np.stack([c, s], -1), np.stack([s, -c], -1)], -2)
    return np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("size", [16, 17])
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_k5_plain_bitidentical_to_pallas(padding, size, dtype):
    rng = np.random.default_rng(size)
    x = rng.normal(size=(4, size, size, 3)).astype(np.float32)
    k = np.array([5, -2, -1, 0], np.int32)  # floor mod 4: 1, 2, 3, 0
    jx, tx = _pair(x, dtype)
    c = size // 2
    ours = tsr.rot90_centered_select(tx, _t(k), c, c, padding)
    assert ours.dtype == tx.dtype
    ref = jsr.pallas_rot90_centered_select(jx, jnp.asarray(k), c, c, padding,
                                           interpret=True)
    assert np.array_equal(_np(ours), _np(ref))
    for b in range(4 if dtype == "float32" else 0):
        one = jsr._rot90_centered(jx[b:b + 1], int(k[b]), c, c, padding)
        assert np.array_equal(_np(ours[b:b + 1]), _np(one)), b


def test_k5_shifts_match_jax_centres():
    """The per-k shifts, off-centre too, as `_rot90_centered` takes them."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 9, 9, 2)).astype(np.float32)
    for cx, cy in ((4, 4), (5, 3), (0, 8)):
        for k in range(4):
            ref = jsr._rot90_centered(jnp.asarray(x), k, cx, cy, "border")
            ours = tsr._rot90_centered(_t(x), k, cx, cy, "border")
            assert np.array_equal(ours.numpy(), np.asarray(ref)), (cx, cy, k)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("size", [16, 17, 32])
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_k6_plain_matches_pallas(padding, size, dtype):
    rng = np.random.default_rng(3 * size)
    x = rng.uniform(size=(4, size, size, 3)).astype(np.float32)
    r = np.array([-np.pi / 4, -0.3, 0.0, 0.7], np.float32)
    jx, tx = _pair(x, dtype)
    c = float(size // 2)
    ours = tsr.shear_rotate_residual(tx, _t(r), c, c, padding)
    assert ours.dtype == tx.dtype
    ref = jsr.shear_rotate_residual(jx, jnp.asarray(r), c, c, padding,
                                    interpret=True)
    tol = 1e-5 if dtype == "float32" else 4e-3
    np.testing.assert_allclose(_np(ours), _np(ref), rtol=0, atol=tol)
    assert np.array_equal(_np(ours[2]), _np(tx[2]))  # r = 0 is the identity


@pytest.mark.parametrize("size", [16, 17, 32])
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_fast_warp_matches_jax_interpret(padding, size):
    rng = np.random.default_rng(size + 7)
    x = rng.uniform(size=(4, size, size, 2)).astype(np.float32)
    theta = rng.uniform(-np.pi, np.pi, size=4).astype(np.float32)
    theta[:2] = [np.pi / 2, -np.pi]  # quarter turns
    R = _rotations(theta)
    ref = jsr.warp_rotate_center_fast(jnp.asarray(x), jnp.asarray(R), padding,
                                      interpret=True)
    ours = tsr.warp_rotate_center_fast(_t(x), _t(R), padding)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_fast_warp_angle_split_in_bf16():
    """bf16 R: the angle is taken in bf16, then split in fp32."""
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(4, 16, 16, 3)).astype(np.float32)
    R = _rotations(rng.uniform(-np.pi, np.pi, size=4))
    jx, tx = _pair(x, "bfloat16")
    jR, tR = _pair(R, "bfloat16")
    ref = jsr.warp_rotate_center_fast(jx, jR, "border", interpret=True)
    ours = tsr.warp_rotate_center_fast(tx, tR, "border")
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(ours), _np(ref), rtol=0, atol=4e-3)


@pytest.mark.parametrize("shape", [(16, 16, 1), (17, 17, 3), (16, 32, 2)])
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_k7_plain_matches_pallas_and_taps_form(padding, shape):
    H, W, C = shape
    rng = np.random.default_rng(H + W + C)
    x = (1 / (1 + np.exp(-rng.normal(size=(4, H, W, C))))).astype(np.float32)
    R = _rotations([np.pi / 2, np.pi, 0.7, 2.5])  # quarter turns: 0/1 weights
    ours = tbw.warp_rotate_center_exact(_t(x), _t(R), padding).numpy()
    taps = j_warp_center_affine(jnp.asarray(x), jnp.asarray(R), padding)
    np.testing.assert_allclose(ours, np.asarray(taps), rtol=1e-4, atol=1e-5)
    kernel = jbw.warp_rotate_center_exact(jnp.asarray(x), jnp.asarray(R), padding,
                                          interpret=True)
    np.testing.assert_allclose(ours, np.asarray(kernel), rtol=1e-4, atol=1e-5)


def test_k7_roto_reflection_factored_matrix():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    R = _rotations([0.4, 2.2], reflect=True)
    ref = jbw.warp_rotate_center_exact(jnp.asarray(x), jnp.asarray(R), "border",
                                       interpret=True)
    ours = tbw.warp_rotate_center_exact(_t(x), _t(R), "border")
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_k7_bf16_rounds_once():
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(3, 16, 16, 3)).astype(np.float32)
    R = _rotations([0.3, 1.9, 4.0])
    jx, tx = _pair(x, "bfloat16")
    ours = tbw.warp_rotate_center_exact(tx, _t(R), "zeros")
    ref = jbw.warp_rotate_center_exact(jx, jnp.asarray(R), "zeros", interpret=True)
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(ours), _np(ref), rtol=0, atol=4e-3)


@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_bilinear_sample_matches_taps_form(padding):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, 11, 3)).astype(np.float32)
    sx = rng.uniform(-3, 14, size=(2, 7, 5)).astype(np.float32)
    sy = rng.uniform(-3, 12, size=(2, 7, 5)).astype(np.float32)
    ref = j_bilinear_sample(jnp.asarray(x), jnp.asarray(sx), jnp.asarray(sy), padding)
    ours = bilinear_sample(_t(x), _t(sx), _t(sy), padding)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_nan_rotation_gives_nan_pixels_in_plain_versions():
    """A zero vector normalizes to a NaN rotation: its sample is all NaN,
    the other sample is untouched, and no address is built from it."""
    rng = np.random.default_rng(11)
    x = _t(rng.uniform(size=(2, 16, 16, 3)).astype(np.float32))
    R_nan = tmath.rotmat_2d_from_vector(torch.zeros(1, 2))
    R = torch.cat([R_nan, _t(_rotations([0.3]))])
    assert torch.isnan(R_nan).all()
    for padding in ("border", "zeros"):
        exact = tbw.warp_rotate_center_exact(x, R, padding)
        fast = tsr.warp_rotate_center_fast(x, R, padding)
        for out in (exact, fast):
            assert torch.isnan(out[0]).all()
            assert torch.isfinite(out[1]).all()
        residual = tsr.shear_rotate_residual(
            x, torch.tensor([float("nan"), float("inf")]), 8.0, 8.0, padding)
        assert torch.isnan(residual).all()


def test_frame_math_matches_jax():
    rng = np.random.default_rng(6)
    v3 = rng.normal(size=(5, 3, 3)).astype(np.float32)
    v2 = rng.normal(size=(5, 2, 2)).astype(np.float32)
    for name, arg in (("gram_schmidt", v3), ("modified_gram_schmidt", v3),
                      ("gram_schmidt_2d", v2), ("rotmat_2d_from_vector", v2[:, 0]),
                      ("det_2x2", v2)):
        ref = np.asarray(getattr(jmath, name)(jnp.asarray(arg)))
        ours = getattr(tmath, name)(_t(arg)).numpy()
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6, err_msg=name)


def test_continuous_info_losses_match_jax():
    rng = np.random.default_rng(8)
    rep = rng.normal(size=(4, 2, 2)).astype(np.float32)
    jin = jinfo.ContinuousCanonicalizationInfo(
        matrix_rep=jnp.asarray(rep),
        element=jinfo.ContinuousGroupElement(rotation=jnp.asarray(rep)))
    tin = tinfo.ContinuousCanonicalizationInfo(
        matrix_rep=_t(rep), element=tinfo.ContinuousGroupElement(rotation=_t(rep)))
    assert tinfo.prior_regularization_loss(tin).item() == pytest.approx(
        float(jinfo.prior_regularization_loss(jin)), rel=1e-6)
    assert tinfo.identity_metric(tin).item() == pytest.approx(
        float(jinfo.identity_metric(jin)), rel=1e-6)


def test_cpu_tensors_do_not_count_as_launches():
    tsr.reset_launches()
    tbw.reset_launches()
    x = torch.zeros(2, 8, 8, 3)
    R = _t(_rotations([0.2, -2.0]))
    tsr.warp_rotate_center_fast(x, R)
    tbw.warp_rotate_center_exact(x, R)
    assert tsr.launches == {} and tbw.launches == {}


def test_non_cpu_non_cuda_tensors_raise():
    """Only a CPU tensor takes the plain version: any other device must
    reach the kernel or raise, never fall back."""
    x = torch.zeros(2, 8, 8, 3, device="meta")
    k = torch.zeros(2, dtype=torch.int32, device="meta")
    r = torch.zeros(2, device="meta")
    R = torch.zeros(2, 2, 2, device="meta")
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tsr.rot90_centered_select(x, k, 4, 4)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tsr.shear_rotate_residual(x, r, 4.0, 4.0)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tbw.warp_rotate_center_exact(x, R)
    with pytest.raises(RuntimeError, match="CUDA tensors"):  # mixed devices
        tbw.warp_rotate_center_exact(torch.zeros(2, 8, 8, 3), R)


@pytest.mark.parametrize("bad", ["square", "k_shape", "r_shape", "R_shape",
                                 "padding", "rank"])
def test_wrappers_reject_bad_arguments(bad):
    x = torch.zeros(2, 8, 8, 3)
    with pytest.raises(ValueError):
        if bad == "square":
            tsr.rot90_centered_select(torch.zeros(2, 8, 9, 3), torch.zeros(2), 4, 4)
        elif bad == "k_shape":
            tsr.rot90_centered_select(x, torch.zeros(3), 4, 4)
        elif bad == "r_shape":
            tsr.shear_rotate_residual(x, torch.zeros(2, 1), 4.0, 4.0)
        elif bad == "R_shape":
            tbw.warp_rotate_center_exact(x, torch.zeros(2, 3, 3))
        elif bad == "padding":
            tbw.warp_rotate_center_exact(x, torch.zeros(2, 2, 2), "reflect")
        else:
            tsr.shear_rotate_residual(torch.zeros(8, 8, 3), torch.zeros(8), 4.0, 4.0)
