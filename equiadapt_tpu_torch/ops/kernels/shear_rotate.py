"""Continuous fast-mode rotation: centered quarter turn (K5) then three-shear
residual (K6).

Counterpart of `equiadapt_tpu/ops/pallas/shear_rotate.py`. A per-sample
rotation by phi splits as Rot(phi) = Rot90^k . Rot(r), r in [-45, 45]
degrees, and Rot(r) = Sx(alpha) . Sy(beta) . Sx(alpha) with
alpha = -tan(r/2), beta = sin(r):

* K5 `rot90_centered_select`: z[b] = rot90^{k[b]}(x[b]) about the integer
  centre (cx, cy), an exact lattice permutation plus a 1-pixel shift per k,
  edge-clamped ("border") or zero-filled ("zeros");
* K6 `shear_rotate_residual`: the three 1-D linear shears, fp32 between
  passes, with the padding rule applied per pass;
* `warp_rotate_center_fast`: the angle decomposition, K5, then K6.

Both wrappers launch the hand-written CUDA kernels of `csrc/shear_rotate.cu`
for CUDA tensors, take the plain PyTorch versions beside them for CPU
tensors, and raise for anything else. K5 moves whole 16-byte words of a
pixel where C and the pointers allow, and stages 32 x 32 tiles through
shared memory otherwise (`_select_path`). K6 keeps each (b, c) plane in
shared memory for all three shears, one launch with no scratch, where the
fp32 plane fits (`_shear_path`: "resident"); the blocks of a cluster
(`_shear_cluster`) own consecutive channels of a sample and load and store
whole pixel runs together. Larger planes take three launches through fp32
scratch ("passes"). `launches` counts wrapper calls that launched a kernel,
by dtype; `path_launches` counts them again by launch path.

Neither kernel has a backward: under grad mode, an input that requires grad
raises on the card (`_build.refuse_grad`) instead of returning a result
without a `grad_fn`. The differentiable fast warp is
`ops.warp.warp_center_rotation_fast_diff`, an autograd Function that calls
`warp_rotate_center_fast` with grad mode off and gives the JAX package's
closed-form backward.

The TPU kernel's roll-depth bound (`_max_shift`) has no counterpart: the
CUDA kernel addresses each tap directly and clamps it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import torch

from equiadapt_tpu_torch.ops.kernels import _build

Tensor = torch.Tensor

__all__ = [
    "rot90_centered_select",
    "rot90_centered_select_plain",
    "shear_rotate_residual",
    "shear_rotate_residual_plain",
    "warp_rotate_center_fast",
    "launches",
    "reset_launches",
]

_PADDING = ("border", "zeros")
_KERNELS = "shear-rotate kernels"
_DIFFERENTIABLE = (
    "differentiate the fast warp through "
    "`ops.warp.warp_center_rotation_fast_diff` (K5 and K6 forward, a "
    "closed-form backward), the route continuous training takes")

# kernel launches per wrapper and dtype, e.g. launches["shear_rotate_residual/bfloat16"]
launches: Dict[str, int] = {}
# the same launches by path, e.g. path_launches["shear_rotate_residual/bfloat16/resident"]
path_launches: Dict[str, int] = {}

# K6's resident path: the shared memory a block may opt into on sm_90, and
# the portable cluster size
RESIDENT_MAX_BYTES = 232448
MAX_CLUSTER = 8


def reset_launches() -> None:
    launches.clear()
    path_launches.clear()


def _count(name: str, dtype: torch.dtype, path: str) -> None:
    key = f"{name}/{str(dtype).removeprefix('torch.')}"
    launches[key] = launches.get(key, 0) + 1
    path_launches[f"{key}/{path}"] = path_launches.get(f"{key}/{path}", 0) + 1


def _lib() -> ctypes.CDLL:
    lib = _build.load("shear_rotate")
    if lib.eqt_rot90_centered_select.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.eqt_rot90_centered_select.argtypes = [
            ci, vp, vp, vp, ctypes.POINTER(ci), ci, ci, ci, ci, ci, vp]
        lib.eqt_rot90_centered_select.restype = ci
        lib.eqt_shear_rotate_residual.argtypes = [
            ci, vp, vp, vp, vp, vp, ci, ci, ci, ci, cf, cf, ci, vp]
        lib.eqt_shear_rotate_residual.restype = ci
        lib.eqt_shear_rotate_resident.argtypes = [
            ci, vp, vp, vp, ci, ci, ci, ci, cf, cf, ci, ci, ci, ci, vp]
        lib.eqt_shear_rotate_resident.restype = ci
    return lib


def _check_image(x: Tensor, padding_mode: str) -> None:
    if x.dim() != 4:
        raise ValueError(f"expected an NHWC batch (B, H, W, C), got {tuple(x.shape)}")
    if padding_mode not in _PADDING:
        raise ValueError(f"padding_mode must be border or zeros, got {padding_mode}")


def _check_launch(x: Tensor) -> None:
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{_KERNELS} take float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{_KERNELS} need NHWC-contiguous input")
    B, H, W, C = x.shape
    if B > 65535 or H > 65535 or W * C >= 2**31 - 256:
        raise ValueError(f"grid limit: B, H <= 65535 and W * C < 2^31, got {tuple(x.shape)}")


@functools.lru_cache(maxsize=64)
def _centered_shifts(H: int, W: int, cx: int, cy: int) -> Tuple[Tuple[int, int], ...]:
    """(sy, sx) per k: rot90^k about the lattice midpoint m = ((W-1)/2,
    (H-1)/2) followed by out(p) = z(p + s) is the rotation about c, with
    s = Rot90^{-k} d - d, d = c - m."""
    shifts = [(0, 0)]
    dx, dy = cx - (W - 1) / 2.0, cy - (H - 1) / 2.0
    for k in (1, 2, 3):
        c, s = [1, 0, -1, 0][k], [0, -1, 0, 1][k]  # cos / sin of -90k degrees
        sx = int(round((c * dx - s * dy) - dx))
        sy = int(round((s * dx + c * dy) - dy))
        shifts.append((sy, sx))
    return tuple(shifts)


def _rot90_centered(x: Tensor, k: int, cx: int, cy: int,
                    padding_mode: str) -> Tensor:
    """z(p) = x(Rot90^k (p - c) + c) for one static k and integer centre c:
    torch.rot90 (about the lattice midpoint), then the shift
    out[py, px] = z[py + sy, px + sx], edge-clamped or zero-filled."""
    k = k % 4
    if k == 0:
        return x
    B, H, W, C = x.shape
    z = torch.rot90(x, k, dims=(1, 2))
    sy, sx = _centered_shifts(H, W, cx, cy)[k]
    if sx == 0 and sy == 0:
        return z
    rows = torch.arange(H, device=x.device) + sy
    cols = torch.arange(W, device=x.device) + sx
    out = z.index_select(1, rows.clamp(0, H - 1)).index_select(2, cols.clamp(0, W - 1))
    if padding_mode == "zeros":
        valid = (((rows >= 0) & (rows < H))[:, None]
                 & ((cols >= 0) & (cols < W))[None, :])
        out = torch.where(valid[None, :, :, None], out, torch.zeros_like(out))
    return out


def rot90_centered_select_plain(x: Tensor, k_idx: Tensor, cx: int, cy: int,
                                padding_mode: str = "border") -> Tensor:
    """Plain version of K5: `_rot90_centered` of each sample by
    k_idx[b] mod 4."""
    k = torch.remainder(k_idx.long(), 4)
    out = torch.empty_like(x)
    for kk in range(4):
        m = k == kk
        out[m] = _rot90_centered(x[m], kk, cx, cy, padding_mode)
    return out


def rot90_centered_select(x: Tensor, k_idx: Tensor, cx: int, cy: int,
                          padding_mode: str = "border") -> Tensor:
    """K5: z[b] = rot90^{k_idx[b]}(x[b]) about the integer centre (cx, cy),
    square NHWC images."""
    _check_image(x, padding_mode)
    B, H, W, C = x.shape
    if H != W:
        raise ValueError(f"rot90_centered_select needs square images, got {H}x{W}")
    if k_idx.shape != (B,):
        raise ValueError(f"k_idx of shape ({B},), got {tuple(k_idx.shape)}")
    where = _build.route([x, k_idx], _KERNELS)
    if where == "meta":
        return torch.empty_like(x)
    if where == "cpu":
        return rot90_centered_select_plain(x, k_idx, cx, cy, padding_mode)
    _build.refuse_grad([x], "the quarter-turn kernel (K5)", _DIFFERENTIABLE)
    return _select_op(x, k_idx, int(cx), int(cy), padding_mode)


def _select_path(x: Tensor, out: Tensor) -> str:
    """K5's launch path: "word" (16-byte words of a pixel) when a pixel is
    whole words and both pointers are 16-byte aligned, "tile" (32 x 32 tiles
    through shared memory) otherwise."""
    return "word" if _build.whole_words(x, out) else "tile"


# K5 as a registered operator around `_launch_select` (`_build.register_op`)
_select_op = _build.register_op(
    "rot90_centered_select(Tensor x, Tensor k_idx, int cx, int cy, "
    "str padding_mode) -> Tensor",
    lambda *args: _launch_select(*args),
    lambda x, k_idx, cx, cy, padding_mode: x.new_empty(x.shape))


def _launch_select(x: Tensor, k_idx: Tensor, cx: int, cy: int,
                   padding_mode: str) -> Tensor:
    _check_launch(x)
    B, H, W, C = x.shape
    shifts = _centered_shifts(H, W, cx, cy)
    table = (ctypes.c_int * 8)(*[s[0] for s in shifts], *[s[1] for s in shifts])
    k = k_idx.to(torch.int32).contiguous()
    out = torch.empty_like(x)
    path = _select_path(x, out)
    err = _lib().eqt_rot90_centered_select(
        _build.DTYPE_CODES[x.dtype], x.data_ptr(), out.data_ptr(), k.data_ptr(), table,
        int(padding_mode == "zeros"), B, H, C, int(path == "word"),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"rot90_centered_select launch failed: cudaError {err}")
    _count("rot90_centered_select", x.dtype, path)
    return out


def _shear_coefficients(r: Tensor) -> Tensor:
    """(B, 2) fp32 (alpha, beta) = (-tan(r/2), sin(r)) of fp32 r."""
    r = r.to(torch.float32)
    return torch.stack([-torch.tan(r / 2.0), torch.sin(r)], dim=-1)


def _shear_pass(img: Tensor, slope: Tensor, axis: int, center: float,
                padding_mode: str) -> Tensor:
    """One fp32 shear pass of an NHWC batch. axis 2 (x-shear): out[h, w] =
    lerp of img[h, w + d] with d = slope * (h - center); axis 1 (y-shear):
    out[h, w] = lerp of img[h + d, w] with d = slope * (w - center)."""
    B, H, W, C = img.shape
    size = img.shape[axis]
    var = torch.arange(H if axis == 2 else W, dtype=torch.float32, device=img.device)
    d = slope[:, None] * (var - center)  # (B, var)
    kf = torch.floor(d)
    f = d - kf
    # address fence, as the kernel: non-finite -> 0, finite clamped so that
    # every out-of-range tap stays out of range
    kf = torch.where(torch.isfinite(kf), kf, torch.zeros_like(kf))
    k = kf.clamp(-(size + 1), size + 1).long()
    src0 = torch.arange(size, device=img.device)[None, None, :] + k[..., None]
    if axis == 1:  # (B, w, h) -> (B, h, w)
        src0, f = src0.transpose(1, 2), f[:, None, :]
    else:
        f = f[:, :, None]
    f = f[..., None]

    def tap(src: Tensor) -> Tensor:
        idx = src.clamp(0, size - 1)[..., None].expand(B, H, W, C)
        t = torch.gather(img, axis, idx)
        if padding_mode == "zeros":
            valid = ((src >= 0) & (src <= size - 1))[..., None]
            t = torch.where(valid, t, torch.zeros_like(t))
        return t

    return (1.0 - f) * tap(src0) + f * tap(src0 + 1)


def shear_rotate_residual_plain(z: Tensor, r: Tensor, cx: float, cy: float,
                                padding_mode: str = "border") -> Tensor:
    """Plain version of K6: Sx(alpha) Sy(beta) Sx(alpha) in fp32 (x-shear
    about cy along rows, y-shear about cx along columns), output in z's
    dtype."""
    ab = _shear_coefficients(r)
    img = z.to(torch.float32)
    img = _shear_pass(img, ab[:, 0], 2, cy, padding_mode)
    img = _shear_pass(img, ab[:, 1], 1, cx, padding_mode)
    img = _shear_pass(img, ab[:, 0], 2, cy, padding_mode)
    return img.to(z.dtype)


def shear_rotate_residual(z: Tensor, r: Tensor, cx: float, cy: float,
                          padding_mode: str = "border") -> Tensor:
    """K6: rotate each NHWC sample by its residual angle r[b] (radians,
    [-pi/4, pi/4] on the fast path) about (cx, cy); sampling map
    out(p) = z(Rot(r)(p - c) + c)."""
    _check_image(z, padding_mode)
    B, H, W, C = z.shape
    if r.shape != (B,):
        raise ValueError(f"r of shape ({B},), got {tuple(r.shape)}")
    where = _build.route([z, r], _KERNELS)
    if where == "meta":
        return torch.empty_like(z)
    if where == "cpu":
        return shear_rotate_residual_plain(z, r, cx, cy, padding_mode)
    _build.refuse_grad([z, r], "the three-shear kernel (K6)", _DIFFERENTIABLE)
    return _shear_op(z, r, float(cx), float(cy), padding_mode)


def _resident_bytes(H: int, W: int) -> int:
    """The shared memory a block of K6's resident path holds: one fp32
    plane of H rows, W | 1 floats apart (an odd pitch, so that a warp
    walking a column touches 32 banks)."""
    return H * (W | 1) * 4


def _shear_path(z: Tensor) -> str:
    """K6's launch path, by shape: "resident" (one launch, each (b, c)
    plane in shared memory for the three shears) when the plane fits in
    RESIDENT_MAX_BYTES, "passes" (three launches through fp32 scratch)
    otherwise."""
    _, H, W, _ = z.shape
    return "resident" if _resident_bytes(H, W) <= RESIDENT_MAX_BYTES else "passes"


def _shear_cluster(C: int, element_size: int) -> int:
    """The blocks of a resident cluster. Rank q of the cluster of channel c
    owns channel c - c % size + q, so a cluster loads and stores runs of
    `size` channels of each pixel: one 16-byte word of channels (8 bf16, 4
    fp32) where that divides C, else the whole pixel where C <= MAX_CLUSTER,
    else the largest divisor of C up to MAX_CLUSTER."""
    word = 16 // element_size
    if C % word == 0:
        return word
    if C <= MAX_CLUSTER:
        return C
    return max(d for d in range(1, MAX_CLUSTER + 1) if C % d == 0)


def _shear_words(z: Tensor, out: Tensor, cluster: int) -> bool:
    """Whether a resident cluster moves 16-byte words: its run of channels
    and a pixel are whole words and both pointers 16-byte aligned."""
    return (cluster * z.element_size()) % 16 == 0 and _build.whole_words(z, out)


# K6 as a registered operator around `_launch_shear` (`_build.register_op`)
_shear_op = _build.register_op(
    "shear_rotate_residual(Tensor z, Tensor r, float cx, float cy, "
    "str padding_mode) -> Tensor",
    lambda *args: _launch_shear(*args),
    lambda z, r, cx, cy, padding_mode: z.new_empty(z.shape))


def _launch_shear(z: Tensor, r: Tensor, cx: float, cy: float,
                  padding_mode: str) -> Tensor:
    """K6 on the card. The resident path takes no scratch; the passes path
    allocates two fp32 copies of the batch."""
    _check_launch(z)
    B, H, W, C = z.shape
    ab = _shear_coefficients(r).contiguous()
    out = torch.empty_like(z)
    code, zeros = _build.DTYPE_CODES[z.dtype], int(padding_mode == "zeros")
    stream = torch.cuda.current_stream(z.device).cuda_stream
    path = _shear_path(z)
    if path == "resident":
        cluster = _shear_cluster(C, z.element_size())
        err = _lib().eqt_shear_rotate_resident(
            code, z.data_ptr(), out.data_ptr(), ab.data_ptr(), B, H, W, C,
            float(cx), float(cy), zeros, cluster,
            int(_shear_words(z, out, cluster)), _resident_bytes(H, W), stream)
    else:
        scratch = torch.empty((2,) + tuple(z.shape), dtype=torch.float32,
                              device=z.device)
        err = _lib().eqt_shear_rotate_residual(
            code, z.data_ptr(), out.data_ptr(), scratch[0].data_ptr(),
            scratch[1].data_ptr(), ab.data_ptr(), B, H, W, C, float(cx),
            float(cy), zeros, stream)
    if err != 0:
        raise RuntimeError(f"shear_rotate_residual launch failed: cudaError {err}")
    _count("shear_rotate_residual", z.dtype, path)
    return out


def warp_rotate_center_fast(x: Tensor, R: Tensor,
                            padding_mode: str = "border") -> Tensor:
    """Fast-mode warp of square NHWC images by per-sample rotations R
    (B, 2, 2): sampling src = R^{-1}(dst - c) + c, c = (W//2, H//2),
    through K5 and K6.

    Parity notes. The JAX function runs the three shears only on a TPU or
    with interpret=True; elsewhere it takes a 4-candidate blend plus a
    bilinear residual, so the port is held to its interpret mode. The
    sampling angle phi = -atan2(R10, R00) is taken in R's dtype and only
    then cast to fp32; k = round-half-even(phi / (pi/2)), r = phi - k pi/2,
    then k mod 4.
    """
    B, H, W, C = x.shape
    if _build.route([x, R], _KERNELS) == "cuda":
        _build.refuse_grad([x, R], "the fast warp's kernels (K5, K6)", _DIFFERENTIABLE)
    cx, cy = W // 2, H // 2
    phi = -torch.atan2(R[:, 1, 0], R[:, 0, 0]).to(torch.float32)
    # divide by a tensor, not a Python scalar: CUDA divides by a host scalar
    # as a product with its reciprocal, which can move a rounding tie
    k = torch.round(phi / torch.full_like(phi, math.pi / 2.0))
    k = torch.where(torch.isfinite(k), k, torch.zeros_like(k)).to(torch.int32)
    r = phi - k.to(torch.float32) * (math.pi / 2.0)
    z = rot90_centered_select(x, torch.remainder(k, 4), cx, cy, padding_mode)
    return shear_rotate_residual(z, r, float(cx), float(cy), padding_mode)
