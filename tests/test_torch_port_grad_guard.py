"""The gradient guard of kernels K4-K7, their launch paths, and the CPU
gradients of K5 and K7 against the JAX package.

K4 (orbit), K5 (centered quarter turn), K6 (three-shear residual) and K7
(exact bilinear warp) have no backward on the card: their CUDA branches
raise under grad mode when a floating input requires grad, before they
launch, and run under `torch.no_grad()` / `torch.inference_mode()`. Their
CPU branches are the plain versions, differentiable by autograd; K5's and
K7's gradients are held to `jax.grad` of the JAX package's XLA forms
(`shear_rotate._rot90_centered`, `continuous_group._warp_center_affine` over
`ops/warp.bilinear_sample`) on the same numpy inputs, within 1e-6 (fp32
sums of the same few products, in another order; the matrix gradient
within 1e-6 of its largest entry, a sum over every pixel).

The CUDA branches are reached here without a card by routing the wrappers
to "cuda" and stubbing their launches. The launch path of K5 and K7 is a
pure function of C, the dtype and the pointers' alignment.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equiadapt_tpu.images.canonicalization.continuous_group import (
    _warp_center_affine as j_warp_center_affine,
)
from equiadapt_tpu.ops.pallas import shear_rotate as jsr
from equiadapt_tpu_torch.ops.kernels import _build
from equiadapt_tpu_torch.ops.kernels import bilinear_warp as tbw
from equiadapt_tpu_torch.ops.kernels import orbit as torbit
from equiadapt_tpu_torch.ops.kernels import shear_rotate as tsr
from torch_port_cpu import one_intra_op_thread  # noqa: F401


def _rotations(theta):
    th = np.asarray(theta, np.float32)
    c, s = np.cos(th), np.sin(th)
    return np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)


# ---------------------------------------------------------------- refuse_grad


def test_refuse_grad_raises_under_grad_mode():
    x = torch.zeros(2, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward on the card.*item 99"):
        _build.refuse_grad([torch.zeros(2), x], "kernel KX", "see item 99")


def test_refuse_grad_raises_for_a_complex_input():
    """A complex tensor that requires grad (the spectral contraction's
    spectra) is refused like a floating one."""
    x = torch.zeros(2, 3, dtype=torch.complex64, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward on the card.*item 99"):
        _build.refuse_grad([torch.zeros(2, dtype=torch.complex64), x], "kernel KX",
                           "see item 99")
    with torch.no_grad():
        _build.refuse_grad([x], "kernel KX", "see item 99")


@pytest.mark.parametrize("context", ["no_grad", "inference_mode"])
def test_refuse_grad_passes_without_grad_mode(context):
    x = torch.zeros(2, 3, requires_grad=True)
    with getattr(torch, context)():
        _build.refuse_grad([x], "kernel KX", "see item 99")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_refuse_grad_passes_inputs_without_grad(dtype):
    tensors = [torch.zeros(2, 3, dtype=dtype), torch.arange(4),
               torch.zeros(2, dtype=torch.int32), torch.zeros(2, requires_grad=True).detach()]
    _build.refuse_grad(tensors, "kernel KX", "see item 99")


# ------------------------------------------- the CUDA branches guard first


class _Stub:
    """Stands in for a wrapper's launch: records that it was reached."""

    def __init__(self):
        self.calls = 0

    def __call__(self, x, *args):
        self.calls += 1
        return torch.zeros_like(x)


def _k4(x, extra):
    return torbit.rot90_flip_orbit(x, 4, reflections=True)


def _k5(x, extra):
    return tsr.rot90_centered_select(x, torch.tensor([1, 3]), 4, 4, "border")


def _k6(x, extra):
    return tsr.shear_rotate_residual(x, extra, 4.0, 4.0, "zeros")


def _k7(x, extra):
    return tbw.warp_rotate_center_exact(x, extra, "zeros")


# kernel -> (module, launch attribute, call, extra input, the differentiable
# route the message names)
GUARDED = {
    "K4": (torbit, "_launch", _k4, None, "hand it data"),
    "K5": (tsr, "_launch_select", _k5, None, "warp_center_rotation_fast_diff"),
    "K6": (tsr, "_launch_shear", _k6, "r", "warp_center_rotation_fast_diff"),
    "K7": (tbw, "_launch", _k7, "R", "_warp_center_affine"),
}


def _extra(kind):
    if kind == "r":
        return torch.tensor([0.3, -0.5])
    if kind == "R":
        return torch.from_numpy(_rotations([0.3, -2.0]))
    return None


@pytest.fixture
def on_card(monkeypatch):
    """Route every wrapper to its CUDA branch."""
    monkeypatch.setattr(_build, "route", lambda tensors, kernels: "cuda")


# every floating input of each kernel: x, and r (K6) or R (K7)
CASES = [(k, "x") for k in sorted(GUARDED)] + [
    (k, "extra") for k in sorted(GUARDED) if GUARDED[k][3] is not None]


@pytest.mark.parametrize("kernel,which", CASES)
def test_cuda_branch_refuses_grad_before_launch(kernel, which, on_card, monkeypatch):
    module, attr, call, kind, item = GUARDED[kernel]
    stub = _Stub()
    monkeypatch.setattr(module, attr, stub)
    x = torch.rand(2, 8, 8, 3)
    extra = _extra(kind)
    if which == "x":
        x.requires_grad_(True)
    else:
        extra.requires_grad_(True)
    with pytest.raises(RuntimeError, match=f"no backward on the card.*{item}"):
        call(x, extra)
    assert stub.calls == 0
    with torch.no_grad():
        call(x, extra)
    with torch.inference_mode():
        call(x, extra)
    assert stub.calls == 2
    call(x.detach(), None if extra is None else extra.detach())
    assert stub.calls == 3


def test_fast_warp_checks_x_and_R_before_the_split(on_card, monkeypatch):
    """`warp_rotate_center_fast` refuses a rotation that requires grad
    before it derives k (integer) and r from it."""
    select, shear = _Stub(), _Stub()
    monkeypatch.setattr(tsr, "_launch_select", select)
    monkeypatch.setattr(tsr, "_launch_shear", shear)
    x = torch.rand(2, 8, 8, 3)
    R = torch.from_numpy(_rotations([0.3, 2.0])).requires_grad_(True)
    with pytest.raises(RuntimeError,
                       match="no backward on the card.*warp_center_rotation_fast_diff"):
        tsr.warp_rotate_center_fast(x, R)
    assert select.calls == shear.calls == 0
    with torch.no_grad():
        tsr.warp_rotate_center_fast(x, R)
    assert select.calls == shear.calls == 1


def test_cpu_branches_stay_differentiable():
    """Without the routing stub every wrapper takes its plain version on the
    CPU, which carries a grad_fn."""
    x = torch.rand(2, 8, 8, 3, requires_grad=True)
    R = torch.from_numpy(_rotations([0.3, -2.0])).requires_grad_(True)
    r = torch.tensor([0.3, -0.5], requires_grad=True)
    outs = [torbit.rot90_flip_orbit(x, 4, reflections=True),
            tsr.rot90_centered_select(x, torch.tensor([1, 3]), 4, 4),
            tsr.shear_rotate_residual(x, r, 4.0, 4.0),
            tbw.warp_rotate_center_exact(x, R),
            tsr.warp_rotate_center_fast(x, R)]
    for out in outs:
        assert out.grad_fn is not None


# ------------------------------------------ CPU gradients against jax.grad


@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_k5_gradient_matches_jax(padding, size):
    rng = np.random.default_rng(size)
    x = rng.normal(size=(4, size, size, 3)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    k = np.array([5, -2, -1, 0], np.int32)  # floor mod 4: 1, 2, 3, 0
    c = size // 2

    def jloss(xx):
        return sum(jnp.sum(jsr._rot90_centered(xx[b:b + 1], int(k[b]), c, c, padding)
                           * g[b:b + 1]) for b in range(4))

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tsr.rot90_centered_select(tx, torch.from_numpy(k), c, c, padding)
    (gx,) = torch.autograd.grad(out, tx, torch.from_numpy(g))
    np.testing.assert_allclose(gx.numpy(), ref, rtol=0, atol=1e-6)
    assert np.abs(ref).max() > 0.5


@pytest.mark.parametrize("shape", [(12, 12, 2), (9, 13, 3)])
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_k7_gradient_matches_jax(padding, shape):
    H, W, C = shape
    rng = np.random.default_rng(H * W + C)
    x = rng.uniform(size=(3, H, W, C)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    R = _rotations([0.4, 2.3, -1.1])

    def jloss(xx, RR):
        return jnp.sum(j_warp_center_affine(xx, RR, padding) * g)

    jgx, jgR = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(R))
    tx = torch.from_numpy(x).requires_grad_(True)
    tR = torch.from_numpy(R).requires_grad_(True)
    out = tbw.warp_rotate_center_exact(tx, tR, padding)
    gx, gR = torch.autograd.grad(out, (tx, tR), torch.from_numpy(g))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=0, atol=1e-6)
    jgR = np.asarray(jgR)
    np.testing.assert_allclose(gR.numpy(), jgR, rtol=0,
                               atol=1e-6 * np.abs(jgR).max())
    assert np.abs(jgR).max() > 1.0


# ----------------------------------------------------------- launch paths

# C -> whole 16-byte words a pixel, by dtype
WORDS = {torch.float32: {1: False, 3: False, 4: True, 8: True, 16: True},
         torch.bfloat16: {1: False, 3: False, 4: False, 8: True, 16: True}}


@pytest.mark.parametrize("C", [1, 3, 4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_path_follows_channels_dtype_and_alignment(dtype, C):
    x = torch.zeros(2, 6, 6, C, dtype=dtype)
    out = torch.empty_like(x)
    assert x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    whole = WORDS[dtype][C]
    assert tbw._path(x, out) == ("word" if whole else "element")
    assert tsr._select_path(x, out) == ("word" if whole else "tile")
    # the same shape one element into a buffer: never 16-byte aligned
    view = torch.zeros(x.numel() + 1, dtype=dtype)[1:].view(x.shape)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    assert tbw._path(view, out) == "element"
    assert tsr._select_path(view, out) == "tile"
    assert tbw._path(x, view) == "element"
    assert tsr._select_path(x, view) == "tile"
