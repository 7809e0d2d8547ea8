"""Exact per-sample bilinear rotation warp (K7).

Counterpart of `equiadapt_tpu/ops/pallas/bilinear_warp.py`:
out(p) = x(R^{-1}(p - c) + c) with direct 4-tap bilinear sampling,
c = (H//2, W//2), "border" or "zeros" padding, for per-sample rotation (or
roto-reflection-factored) matrices R (B, 2, 2).

`warp_rotate_center_exact` launches the hand-written CUDA kernel of
`csrc/bilinear_warp.cu` for CUDA tensors, takes the plain PyTorch version
beside it (`_warp_center_affine` -> `ops.warp.bilinear_sample`) for CPU
tensors, and raises for anything else. There is no tiling gate: the kernel
takes any image shape. It moves whole 16-byte words of channels where C and
the pointers allow (`_path`), single elements otherwise. `launches` counts
its launches by dtype.

The kernel has no backward: under grad mode, an input that requires grad
raises on the card (`_build.refuse_grad`) instead of returning a result
without a `grad_fn`. Training warps through `_warp_center_affine`, as the
JAX package does.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from equiadapt_tpu_torch.ops.kernels import _build
from equiadapt_tpu_torch.ops.warp import _dst_grid, _inverse_2x2, bilinear_sample

Tensor = torch.Tensor

__all__ = ["warp_rotate_center_exact", "launches", "reset_launches"]

_KERNELS = "the exact-warp kernel (K7)"
_DIFFERENTIABLE = (
    "differentiate the exact warp through its plain version "
    "`_warp_center_affine` (autograd through the sample coordinates), the "
    "route continuous training takes")

# kernel launches by dtype, e.g. launches["warp_rotate_center_exact/float32"]
launches: Dict[str, int] = {}


def reset_launches() -> None:
    launches.clear()


def _lib() -> ctypes.CDLL:
    lib = _build.load("bilinear_warp")
    fn = lib.eqt_warp_rotate_center_exact
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
    return lib


def _inverse_coefficients(R: Tensor, dtype: torch.dtype) -> Tensor:
    """(B, 4) [i00, i01, i10, i11] of R^{-1} by the adjugate over det, in
    `dtype`."""
    return torch.stack(_inverse_2x2(R.to(dtype)), dim=-1)


def _warp_center_affine(x: Tensor, R: Tensor, padding_mode: str) -> Tensor:
    """Plain version of K7: warp NHWC x with forward map
    dst = R (src - c) + c, c = (H//2, W//2) (the reference's
    shape[-2]//2, shape[-1]//2; equal to (W//2, H//2) on square images).
    R rows are (x, y), as kornia's matrices. Computes in fp32 (or x's
    wider dtype)."""
    B, H, W, _ = x.shape
    dtype = torch.promote_types(x.dtype, torch.float32)
    inv = _inverse_coefficients(R, dtype)
    cx, cy = H // 2, W // 2
    gx, gy = _dst_grid(B, H, W, dtype, x.device)
    dx = gx - cx
    dy = gy - cy
    i00, i01, i10, i11 = (inv[:, q, None, None] for q in range(4))
    src_x = i00 * dx + i01 * dy + cx
    src_y = i10 * dx + i11 * dy + cy
    return bilinear_sample(x, src_x, src_y, padding_mode=padding_mode)


def warp_rotate_center_exact(x: Tensor, R: Tensor,
                             padding_mode: str = "border") -> Tensor:
    """K7: out(p) = x(R^{-1}(p - c) + c), c = (H//2, W//2), exact 4-tap
    bilinear, NHWC in and out, x's dtype."""
    if x.dim() != 4:
        raise ValueError(f"expected an NHWC batch (B, H, W, C), got {tuple(x.shape)}")
    B, H, W, C = x.shape
    if R.shape != (B, 2, 2):
        raise ValueError(f"R of shape ({B}, 2, 2), got {tuple(R.shape)}")
    if padding_mode not in ("border", "zeros"):
        raise ValueError(f"padding_mode must be border or zeros, got {padding_mode}")
    where = _build.route([x, R], _KERNELS)
    if where == "meta":
        return torch.empty_like(x)
    if where == "cpu":
        return _warp_center_affine(x, R, padding_mode)
    _build.refuse_grad([x, R], _KERNELS, _DIFFERENTIABLE)
    return _warp_op(x, R, padding_mode)


def _path(x: Tensor, out: Tensor) -> str:
    """The kernel's launch path: "word" (16-byte words of channels) when a
    pixel is whole words and both pointers are 16-byte aligned, "element"
    otherwise."""
    return "word" if _build.whole_words(x, out) else "element"


# K7 as a registered operator around `_launch` (`_build.register_op`)
_warp_op = _build.register_op(
    "warp_rotate_center_exact(Tensor x, Tensor R, str padding_mode) -> Tensor",
    lambda x, R, padding_mode: _launch(x, R, padding_mode),
    lambda x, R, padding_mode: x.new_empty(x.shape))


def _launch(x: Tensor, R: Tensor, padding_mode: str) -> Tensor:
    B, H, W, C = x.shape
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{_KERNELS} takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{_KERNELS} needs NHWC-contiguous input")
    if B > 65535 or H * W * C >= 2**31:
        raise ValueError(f"grid limit: B <= 65535 and H * W * C < 2^31, got {tuple(x.shape)}")
    Rf = R.to(torch.float32).contiguous()
    tab = torch.empty((B, 4), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    err = _lib().eqt_warp_rotate_center_exact(
        _build.DTYPE_CODES[x.dtype], x.data_ptr(), out.data_ptr(), Rf.data_ptr(),
        tab.data_ptr(), int(padding_mode == "zeros"), B, H, W, C,
        int(_path(x, out) == "word"),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"warp_rotate_center_exact launch failed: cudaError {err}")
    key = f"warp_rotate_center_exact/{str(x.dtype).removeprefix('torch.')}"
    launches[key] = launches.get(key, 0) + 1
    return out
