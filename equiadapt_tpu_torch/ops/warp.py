"""Image warps of the canonicalizers, in PyTorch.

Counterpart of `equiadapt_tpu/ops/warp.py`. Public functions keep the JAX
package's NHWC layout; the `_from_nchw` residual warps take and give
(B, C, H, W), the layout the select kernels read.

* `_static_rotate*` is the exact-mode residual source: four bilinear taps per
  pixel whose indices and weights are computed once per (H, W, angle, mode)
  on the host in float64 numpy (kornia `rotate` semantics, centre
  ((W-1)/2, (H-1)/2)) and moved to the device once.
* `rotate_twopass*` is the fast-mode residual source: one vertical and one
  horizontal 1-D interpolation, each a batched matrix product. The two
  products stay `torch.einsum`, as the JAX package leaves them to XLA; V is
  rounded to the payload dtype between them, as in JAX.
* `rotate_select_fast` and `rotate_discrete` are the JAX package's pure
  formulations of the hard select and of the one-hot blend, references for
  the tests; the optimized canonicalizer's artifact dummies (off by
  default) take `rotate_discrete`, as in JAX.
* `bilinear_sample` is the direct four-tap bilinear sampler at per-pixel
  coordinates (the JAX taps form; its "slab" form is a TPU index-traffic
  variant with the same values and has no counterpart here). It is the
  plain version of kernel K7 and the reference of K6's residual bounds.
  Autograd differentiates it in the image and in the sample coordinates.
* `rotate` (kornia's per-sample rotation), `warp_affine` (kornia's 2 x 3
  forward map) and `affine_grid_sample` (`F.affine_grid` + `F.grid_sample`,
  align_corners=False) are coordinate maps onto `bilinear_sample`, so they
  are differentiable in the image and in their angles or matrices.
* `warp_center_rotation_fast_diff` is the differentiable fast warp of
  continuous training: forward K5 then K6 (`warp_rotate_center_fast`), and
  the JAX package's closed-form backward (`_fast_diff_warp_bwd`).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

__all__ = [
    "hflip",
    "group_angles",
    "rotate_twopass",
    "rotate_twopass_nchw",
    "rotate_twopass_from_nchw",
    "rotate_select_fast",
    "rotate_discrete",
    "bilinear_sample",
    "rotate",
    "warp_affine",
    "affine_grid_sample",
    "warp_center_rotation_fast_diff",
    "center_crop",
    "resize",
    "crop_and_resize",
    "crop_and_resize_size",
]


def hflip(x: Tensor) -> Tensor:
    """Horizontal flip (width axis) of an NHWC image batch."""
    return torch.flip(x, dims=(2,))


@functools.lru_cache(maxsize=None)
def _angle_table(num_rotations: int) -> np.ndarray:
    """Host fp32 linspace(0, 360, n+1)[:n], the JAX `group_angles` values."""
    return np.linspace(0.0, 360.0, num_rotations + 1, dtype=np.float32)[
        :num_rotations
    ]


def _angle_tuple(num_rotations: int) -> tuple:
    """The angle table as Python floats (static filter-rotation angles)."""
    return tuple(float(a) for a in _angle_table(num_rotations))


def group_angles(
    num_rotations: int, device="cuda", dtype: torch.dtype = torch.float32
) -> Tensor:
    """Rotation-angle table linspace(0, 360, n+1)[:n] in degrees."""
    return torch.from_numpy(_angle_table(num_rotations)).to(
        device=device, dtype=dtype
    )


@functools.lru_cache(maxsize=256)
def _static_warp_taps(H: int, W: int, angle_deg: float, padding_mode: str):
    """Host bilinear taps of one static rotation: (idx (4, H*W) int32,
    weights (4, H*W) float32), kornia `rotate` semantics, float64 geometry."""
    rad = math.radians(angle_deg)
    a, b = math.cos(rad), math.sin(rad)
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    gy, gx = np.meshgrid(np.arange(H, dtype=np.float64),
                         np.arange(W, dtype=np.float64), indexing="ij")
    dx = gx - cx
    dy = gy - cy
    sx = a * dx - b * dy + cx
    sy = b * dx + a * dy + cy
    x0 = np.floor(sx)
    y0 = np.floor(sy)
    fx = (sx - x0).astype(np.float32)
    fy = (sy - y0).astype(np.float32)
    idxs, wts = [], []
    for ddx, ddy, w in (
        (0, 0, (1 - fx) * (1 - fy)),
        (1, 0, fx * (1 - fy)),
        (0, 1, (1 - fx) * fy),
        (1, 1, fx * fy),
    ):
        xi = x0 + ddx
        yi = y0 + ddy
        if padding_mode == "border":
            wt = w
        else:  # zeros
            valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
            wt = w * valid.astype(np.float32)
        xc = np.clip(xi, 0, W - 1).astype(np.int64)
        yc = np.clip(yi, 0, H - 1).astype(np.int64)
        idxs.append((yc * W + xc).reshape(-1).astype(np.int32))
        wts.append(wt.reshape(-1).astype(np.float32))
    return np.stack(idxs), np.stack(wts)


_device_taps: Dict[tuple, Tuple[Tensor, Tensor]] = {}


def _taps_on(device: torch.device, H: int, W: int, angle_deg: float,
             padding_mode: str) -> Tuple[Tensor, Tensor]:
    """`_static_warp_taps` moved to `device` once and kept there."""
    key = (str(device), H, W, angle_deg, padding_mode)
    taps = _device_taps.get(key)
    if taps is None:
        idx, wts = _static_warp_taps(H, W, angle_deg, padding_mode)
        taps = (
            torch.from_numpy(idx.astype(np.int64)).to(device),
            torch.from_numpy(wts).to(device),
        )
        _device_taps[key] = taps
    return taps


def _quarter_turns(angle_deg: float):
    """k if angle_deg is a multiple of 90 degrees, else None."""
    k = angle_deg / 90.0
    return int(round(k)) % 4 if abs(k - round(k)) < 1e-9 else None


def _static_rotate(x: Tensor, angle_deg: float, padding_mode: str) -> Tensor:
    """Rotate an NHWC batch by one static angle (exact rot90 for multiples
    of 90 degrees on square images, static-tap bilinear otherwise)."""
    B, H, W, C = x.shape
    k = _quarter_turns(angle_deg)
    if H == W and k is not None:
        return torch.rot90(x, k, dims=(1, 2))
    idx, wts = _taps_on(x.device, H, W, float(angle_deg) % 360.0, padding_mode)
    flat = x.reshape(B, H * W, C)
    out = None
    for t in range(4):
        tap = flat.index_select(1, idx[t]) * wts[t][None, :, None]
        out = tap if out is None else out + tap
    return out.reshape(B, H, W, C)


def _static_rotate_from_nchw(x: Tensor, angle_deg: float,
                             padding_mode: str) -> Tensor:
    """`_static_rotate` for (B, C, H, W) input, emitting NCHW in x's dtype:
    the same taps, weights and summation order over the flat H*W axis."""
    B, C, H, W = x.shape
    k = _quarter_turns(angle_deg)
    if H == W and k is not None:
        return torch.rot90(x, k, dims=(2, 3))
    idx, wts = _taps_on(x.device, H, W, float(angle_deg) % 360.0, padding_mode)
    flat = x.reshape(B, C, H * W)
    out = None
    for t in range(4):
        tap = flat.index_select(2, idx[t]) * wts[t][None, None, :]
        out = tap if out is None else out + tap
    return out.reshape(B, C, H, W).to(x.dtype)


def _twopass_matrices(H: int, W: int, angle_deg: float, padding_mode: str,
                      dtype: torch.dtype, device) -> Tuple[Tensor, Tensor]:
    """Two-pass (column, then row) rotation resampling matrices.

    Pass A interpolates each input column w vertically at
    p(y, w) = (b*(w-cx) + (y-cy)) / a + cy; pass B each output row
    horizontally at q(y, x) = a*(x-cx) - b*(y-cy) + cx, a = cos, b = sin.
    Built in fp32 as in JAX, then cast to `dtype`.

    Returns M1 (H, H, W): weight of in[h, w] in V[y, w], and
    M2 (H, W, W): weight of V[y, w] in out[y, x].
    """
    rad = math.radians(angle_deg)
    a, b = math.cos(rad), math.sin(rad)
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    f32 = dict(dtype=torch.float32, device=device)
    yv = torch.arange(H, **f32)
    wv = torch.arange(W, **f32)
    xv = torch.arange(W, **f32)

    def taps(pos, size):
        lo = torch.floor(pos)
        f = pos - lo
        if padding_mode == "border":
            w0, w1 = 1.0 - f, f
        else:  # zeros
            v0 = (lo >= 0) & (lo <= size - 1)
            v1 = (lo + 1 >= 0) & (lo + 1 <= size - 1)
            w0 = (1.0 - f) * v0.float()
            w1 = f * v1.float()
        i0 = torch.clamp(lo, 0, size - 1).long()
        i1 = torch.clamp(lo + 1, 0, size - 1).long()
        return i0, i1, w0, w1

    p = (b * (wv[None, :] - cx) + (yv[:, None] - cy)) / a + cy  # (y, w)
    h0, h1, u0, u1 = taps(p, H)
    hh = torch.arange(H, device=device)
    M1 = ((hh[None, :, None] == h0[:, None, :]) * u0[:, None, :]
          + (hh[None, :, None] == h1[:, None, :]) * u1[:, None, :]).to(dtype)

    q = a * (xv[None, :] - cx) - b * (yv[:, None] - cy) + cx  # (y, x)
    w0i, w1i, g0, g1 = taps(q, W)
    ww = torch.arange(W, device=device)
    M2 = ((ww[None, :, None] == w0i[:, None, :]) * g0[:, None, :]
          + (ww[None, :, None] == w1i[:, None, :]) * g1[:, None, :]).to(dtype)
    return M1, M2


def _reduce_angle(angle_deg: float):
    """angle = 90 k + r with r in [-45, 45]; (k mod 4, r)."""
    ang = float(angle_deg) % 360.0
    k = int(round(ang / 90.0))
    return k % 4, ang - 90.0 * k


def rotate_twopass_from_nchw(x: Tensor, angle_deg: float,
                             padding_mode: str = "border") -> Tensor:
    """Whole-batch rotation by a static angle as two batched products,
    (B, C, H, W) in and out. Exact for multiples of 90 degrees."""
    B, C, H, W = x.shape
    if H != W:
        raise ValueError("rotate_twopass_from_nchw requires square images")
    k, r = _reduce_angle(angle_deg)
    if abs(r) < 1e-9:
        return torch.rot90(x, k, dims=(2, 3)) if k else x
    dt = x.dtype
    M1, M2 = _twopass_matrices(H, W, r, padding_mode, dt, x.device)
    V = torch.einsum("yhw,bchw->bcyw", M1, x).to(dt)
    out = torch.einsum("ywx,bcyw->bcyx", M2, V).to(dt)
    return torch.rot90(out, k, dims=(2, 3)) if k else out


def rotate_twopass_nchw(x: Tensor, angle_deg: float,
                        padding_mode: str = "border") -> Tensor:
    """`rotate_twopass` for NHWC input, emitting (B, C, H, W)."""
    return rotate_twopass_from_nchw(x.permute(0, 3, 1, 2), angle_deg,
                                    padding_mode)


def rotate_twopass(x: Tensor, angle_deg: float,
                   padding_mode: str = "border") -> Tensor:
    """Two-pass static rotation of an NHWC batch (fast-mode residual), NHWC
    in and out: the two products contract H, then W, with C minor."""
    B, H, W, C = x.shape
    k, r = _reduce_angle(angle_deg)
    if abs(r) < 1e-9:
        return torch.rot90(x, k, dims=(1, 2)) if k else x
    if H != W:
        raise ValueError("rotate_twopass requires square images")
    dt = x.dtype
    M1, M2 = _twopass_matrices(H, W, r, padding_mode, dt, x.device)
    V = torch.einsum("yhw,bhwc->bywc", M1, x).to(dt)
    out = torch.einsum("ywx,bywc->byxc", M2, V).to(dt)
    return torch.rot90(out, k, dims=(1, 2)) if k else out


def _residual_rotate(x: Tensor, angle_deg: float, padding_mode: str,
                     mode: str) -> Tensor:
    if mode == "fast":
        return rotate_twopass(x, angle_deg, padding_mode)
    return _static_rotate(x, angle_deg, padding_mode)


def rotate_select_fast(x: Tensor, idx: Tensor, num_rotations: int,
                       sign: float = -1.0,
                       padding_mode: str = "border") -> Tensor:
    """Hard per-sample select in fast mode as plain tensor ops (reference):
    out[b] = rotate(x[b], sign * theta_{idx[b]}), each mod-90 residual warped
    once by `rotate_twopass`, the quarter turns as exact rot90 blends."""
    if x.shape[1] != x.shape[2]:
        onehot = F.one_hot(idx.long(), num_rotations).to(x.dtype)
        return rotate_discrete(x, onehot, num_rotations, sign, padding_mode)
    angles = np.linspace(0.0, 360.0, num_rotations + 1)[:num_rotations]
    residuals, res_of_g, k_of_g = [], [], []
    for g in range(num_rotations):
        ang = (sign * float(angles[g])) % 360.0
        r = ang % 90.0
        k = int(round((ang - r) / 90.0)) % 4
        if r not in residuals:
            residuals.append(r)
        res_of_g.append(residuals.index(r))
        k_of_g.append(k)
    cands = [
        x if r == 0.0 else rotate_twopass(x, r, padding_mode) for r in residuals
    ]
    idx = idx.long()
    if len(cands) == 1:
        z = cands[0]
    else:
        res_idx = torch.tensor(res_of_g, device=x.device)[idx]
        oh_r = F.one_hot(res_idx, len(cands)).to(x.dtype)
        z = sum(c * oh_r[:, i][:, None, None, None] for i, c in enumerate(cands))
    k_idx = torch.tensor(k_of_g, device=x.device)[idx]
    k0 = (k_idx % 2).to(x.dtype)[:, None, None, None]
    k1 = (k_idx // 2).to(x.dtype)[:, None, None, None]
    w = (1.0 - k0) * z + k0 * torch.rot90(z, 1, dims=(1, 2))
    return (1.0 - k1) * w + k1 * torch.rot90(w, 2, dims=(1, 2))


def rotate_discrete(x: Tensor, onehot: Tensor, num_rotations: int,
                    sign: float = -1.0, padding_mode: str = "zeros",
                    mode: str = "exact") -> Tensor:
    """One-hot blend of static warps (reference):
    out[b] = sum_g onehot[b, g] * rotate(x[b], sign * theta_g)."""
    angles = np.linspace(0.0, 360.0, num_rotations + 1)[:num_rotations]
    square = x.shape[1] == x.shape[2]
    warped: dict = {}
    out = None
    for g in range(num_rotations):
        ang = (sign * float(angles[g])) % 360.0
        if square:
            residual = ang % 90.0
            k = int(round((ang - residual) / 90.0)) % 4
            if residual not in warped:
                warped[residual] = (
                    x if residual == 0.0
                    else _residual_rotate(x, residual, padding_mode, mode)
                )
            cand = torch.rot90(warped[residual], k, dims=(1, 2))
        else:
            cand = _static_rotate(x, ang, padding_mode)
        term = cand * onehot[:, g][:, None, None, None]
        out = term if out is None else out + term
    return out


def center_crop(x: Tensor, size: Tuple[int, int]) -> Tensor:
    """torchvision CenterCrop semantics on NHWC (top = round((H - h) / 2))."""
    H, W = x.shape[1], x.shape[2]
    h, w = size
    top = int(round((H - h) / 2.0))
    left = int(round((W - w) / 2.0))
    return x[:, top : top + h, left : left + w, :]


def _resize_nearest(x: Tensor, size: Tuple[int, int], dims: Tuple[int, int]) -> Tensor:
    """Nearest resize of `x` along `dims` to `size` as `jax.image.resize(...,
    "nearest")` takes it: output index i reads floor((i + 0.5) * in / out),
    computed in fp32; a dimension already at its size is left alone."""
    for dim, n in zip(dims, size):
        m = x.shape[dim]
        if m == n:
            continue
        src = torch.floor((torch.arange(n, dtype=torch.float32, device=x.device) + 0.5)
                          * m / n).long()
        x = x.index_select(dim, src)
    return x


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _lanczos(radius: float):
    def kernel(x: np.ndarray) -> np.ndarray:
        y = radius * np.sin(np.pi * x) * np.sin(np.pi * x / radius)
        out = np.where(x > 1e-3, y / np.where(x != 0, np.pi ** 2 * x ** 2, 1.0), 1.0)
        return np.where(x > radius, 0.0, out)
    return kernel


_RESIZE_KERNELS = {"cubic": _keys_cubic, "lanczos3": _lanczos(3.0),
                   "lanczos5": _lanczos(5.0)}


@functools.lru_cache(maxsize=None)
def _resize_weights(n_in: int, n_out: int, method: str) -> Tensor:
    """The (n_out, n_in) float64 matrix of `jax.image.scale_and_translate`
    at scale n_out / n_in, no translation: the kernel at the distance from
    each output's sample point, (i + 0.5) * n_in / n_out - 0.5, widened by
    max(1, n_in / n_out) (antialiased when it shrinks), each output's taps
    normalised to sum 1 (0 where the sum is within 1000 fp32 epsilons of
    0) and zero for a sample point outside the input."""
    inv_scale = n_in / n_out
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / max(inv_scale, 1.0)
    w = _RESIZE_KERNELS[method](x)
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, 0.0)
    return torch.from_numpy(np.ascontiguousarray(w.T))


def resize(x: Tensor, size: Tuple[int, int], method: str = "linear") -> Tensor:
    """Resize of an NHWC batch's (H, W) to `size` as `jax.image.resize`
    does it (antialias on). `method`:

    * "linear": bilinear, half-pixel centres, antialiased when it shrinks
      (`F.interpolate(..., antialias=True)`);
    * "nearest": output i reads input floor((i + 0.5) * in / out);
    * "cubic" (Keys, a = -0.5), "lanczos3", "lanczos5": JAX's separable
      weight matrices (`_resize_weights`), built on the host in float64,
      cast to the compute dtype and applied as two products. Torch's
      bicubic (a = -0.75 without antialias) is another function.

    Reduced-precision input is resized in fp32 and rounded once; "nearest"
    moves the values as they are."""
    if method == "nearest":
        return _resize_nearest(x, size, (1, 2))
    if method == "linear":
        xn = x.permute(0, 3, 1, 2)
        out = F.interpolate(
            xn.float(), size=tuple(size), mode="bilinear", align_corners=False,
            antialias=True,
        )
        return out.to(x.dtype).permute(0, 2, 3, 1)
    if method not in _RESIZE_KERNELS:
        raise ValueError(f'Unknown resize method "{method}"')
    compute = x.dtype if x.dtype in (torch.float32, torch.float64) else torch.float32
    out = x.to(compute)
    for dim, n in zip((1, 2), size):
        m = out.shape[dim]
        if m == n:  # JAX skips a dimension at its size
            continue
        w = _resize_weights(m, n, method).to(device=x.device, dtype=compute)
        out = (torch.einsum("oh,bhwc->bowc", w, out) if dim == 1
               else torch.einsum("ow,bhwc->bhoc", w, out))
    return out.to(x.dtype) if x.dtype.is_floating_point else out


def crop_and_resize(x: Tensor, in_shape: Tuple[int, int, int],
                    input_crop_ratio: float,
                    resize_shape: Optional[int]) -> Tensor:
    """A canonicalization network's NHWC input: centre-crop by
    `input_crop_ratio` (ceil of the side), then resize to `resize_shape`;
    grayscale inputs (in_shape[-1] == 1) pass through."""
    if in_shape[-1] == 1:
        return x
    H, W = in_shape[0], in_shape[1]
    ch = math.ceil(H * input_crop_ratio)
    cw = math.ceil(W * input_crop_ratio)
    if (ch, cw) != (H, W):
        x = center_crop(x, (ch, cw))
    if resize_shape is not None:
        x = resize(x, (resize_shape, resize_shape))
    return x


def crop_and_resize_size(in_shape: Tuple[int, int, int],
                         input_crop_ratio: float,
                         resize_shape: Optional[int]) -> Tuple[int, int]:
    """(H, W) of `crop_and_resize`'s output for images of `in_shape`."""
    H, W = in_shape[0], in_shape[1]
    if in_shape[-1] == 1:
        return H, W
    if resize_shape is not None:
        return resize_shape, resize_shape
    return math.ceil(H * input_crop_ratio), math.ceil(W * input_crop_ratio)


def bilinear_sample(x: Tensor, src_x: Tensor, src_y: Tensor,
                    padding_mode: str = "zeros") -> Tensor:
    """Bilinear sampling of NHWC images at float pixel coordinates.

    x: (B, H, W, C); src_x, src_y: (B, Ho, Wo) in pixel units.
    "zeros": out-of-range taps weigh 0 (grid_sample's zeros mode);
    "border": taps clamp to the edge (the reference's edge-pad + crop).
    Computes in fp32 (or x's wider dtype) and returns x's dtype. Taps are
    summed in the order (x0, y0), (x1, y0), (x0, y1), (x1, y1).

    A non-finite coordinate gives NaN weights and so a NaN pixel; its
    address is fenced to 0 before the integer conversion.
    """
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"padding_mode must be zeros or border, got {padding_mode}")
    B, H, W, C = x.shape
    Ho, Wo = src_x.shape[1], src_x.shape[2]
    cdt = torch.promote_types(x.dtype, torch.float32)
    sx = src_x.to(cdt)
    sy = src_y.to(cdt)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0

    def index(t: Tensor, size: int) -> Tensor:
        # [-2, size + 1] keeps every out-of-range tap out of range
        t = torch.where(torch.isfinite(t), t, torch.zeros_like(t))
        return t.clamp(-2, size + 1).long()

    x0i = index(x0, W)
    y0i = index(y0, H)
    flat = x.reshape(B * H * W, C).to(cdt)
    base = (torch.arange(B, device=x.device) * (H * W))[:, None, None]

    def tap(xi: Tensor, yi: Tensor, w: Tensor) -> Tensor:
        if padding_mode == "zeros":
            valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
            w = w * valid.to(cdt)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1) + base
        return flat[idx.reshape(-1)].reshape(B, Ho, Wo, C) * w[..., None]

    out = (
        tap(x0i, y0i, (1.0 - fx) * (1.0 - fy))
        + tap(x0i + 1, y0i, fx * (1.0 - fy))
        + tap(x0i, y0i + 1, (1.0 - fx) * fy)
        + tap(x0i + 1, y0i + 1, fx * fy)
    )
    return out.to(x.dtype)


def _dst_grid(B: int, Ho: int, Wo: int, dtype: torch.dtype,
              device) -> Tuple[Tensor, Tensor]:
    """Destination pixel-coordinate grids (gx, gy), broadcast to (B, Ho, Wo)."""
    ys = torch.arange(Ho, dtype=dtype, device=device)
    xs = torch.arange(Wo, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return gx[None].expand(B, Ho, Wo), gy[None].expand(B, Ho, Wo)


def rotate(x: Tensor, angle_deg, padding_mode: str = "zeros",
           center: Optional[Tuple[float, float]] = None) -> Tensor:
    """Per-sample rotation of an NHWC batch, kornia.geometry.rotate
    semantics: dst(xd, yd) = src(a (xd - cx) - b (yd - cy) + cx,
    b (xd - cx) + a (yd - cy) + cy), a = cos, b = sin of `angle_deg` ((B,)
    or a scalar, degrees), centre ((W-1)/2, (H-1)/2) unless `center`
    (cx, cy) is given."""
    B, H, W, _ = x.shape
    dtype = torch.promote_types(x.dtype, torch.float32)
    angle = torch.as_tensor(angle_deg, device=x.device).to(dtype).broadcast_to((B,))
    rad = angle * (math.pi / 180.0)
    a = torch.cos(rad)[:, None, None]
    b = torch.sin(rad)[:, None, None]
    cx, cy = ((W - 1) / 2.0, (H - 1) / 2.0) if center is None else center
    gx, gy = _dst_grid(B, H, W, dtype, x.device)
    dx = gx - cx
    dy = gy - cy
    src_x = a * dx - b * dy + cx
    src_y = b * dx + a * dy + cy
    return bilinear_sample(x, src_x, src_y, padding_mode=padding_mode)


def warp_affine(x: Tensor, affine: Tensor,
                dsize: Optional[Tuple[int, int]] = None,
                padding_mode: str = "zeros") -> Tensor:
    """Per-sample affine warp, kornia.geometry.warp_affine semantics:
    `affine` (B, 2, 3) is the forward map [R | t] in pixel coordinates with
    rows (x, y); sampling inverts it, src = R^{-1}(dst - t). `dsize` is the
    output (H, W), the input's by default."""
    B, H, W, _ = x.shape
    Ho, Wo = dsize if dsize is not None else (H, W)
    dtype = torch.promote_types(x.dtype, torch.float32)
    A = affine.to(dtype)
    r00, r01, t0 = A[:, 0, 0], A[:, 0, 1], A[:, 0, 2]
    r10, r11, t1 = A[:, 1, 0], A[:, 1, 1], A[:, 1, 2]
    inv_det = 1.0 / (r00 * r11 - r01 * r10)
    i00, i01 = r11 * inv_det, -r01 * inv_det
    i10, i11 = -r10 * inv_det, r00 * inv_det
    gx, gy = _dst_grid(B, Ho, Wo, dtype, x.device)
    ux = gx - t0[:, None, None]
    uy = gy - t1[:, None, None]
    src_x = i00[:, None, None] * ux + i01[:, None, None] * uy
    src_y = i10[:, None, None] * ux + i11[:, None, None] * uy
    return bilinear_sample(x, src_x, src_y, padding_mode=padding_mode)


def affine_grid_sample(x: Tensor, theta: Tensor,
                       padding_mode: str = "zeros") -> Tensor:
    """`F.affine_grid` + `F.grid_sample` (align_corners=False) on an NHWC
    batch: `theta` (B, 2, 3) maps output normalized coordinates to input
    normalized coordinates (torch's convention); a normalized coordinate g
    is the pixel ((g + 1) size - 1) / 2."""
    B, H, W, _ = x.shape
    dtype = torch.promote_types(x.dtype, torch.float32)
    th = theta.to(dtype)
    gx, gy = _dst_grid(B, H, W, dtype, x.device)
    nx = (2.0 * gx + 1.0) / W - 1.0
    ny = (2.0 * gy + 1.0) / H - 1.0
    t = [[th[:, r, c, None, None] for c in range(3)] for r in range(2)]
    sx_n = t[0][0] * nx + t[0][1] * ny + t[0][2]
    sy_n = t[1][0] * nx + t[1][1] * ny + t[1][2]
    src_x = ((sx_n + 1.0) * W - 1.0) / 2.0
    src_y = ((sy_n + 1.0) * H - 1.0) / 2.0
    return bilinear_sample(x, src_x, src_y, padding_mode=padding_mode)


def _inverse_2x2(Rm: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(i00, i01, i10, i11) of Rm^{-1}, (B, 2, 2), by the adjugate over det."""
    det = Rm[:, 0, 0] * Rm[:, 1, 1] - Rm[:, 0, 1] * Rm[:, 1, 0]
    return (Rm[:, 1, 1] / det, -Rm[:, 0, 1] / det, -Rm[:, 1, 0] / det,
            Rm[:, 0, 0] / det)


def _fast_diff_warp_rbar(R: Tensor, out: Tensor, g: Tensor) -> Tensor:
    """The rotation's cotangent of the fast warp out(p) = x(R^{-1}(p - c) + c),
    c = (W//2, H//2), as the JAX package's `_fast_diff_warp_bwd` computes it:
    Rbar[i, j] = -sum_p sum_c g(p) (grad out)_i(p) u_j(p), u = R^{-1}(p - c),
    grad out by central differences of the forward output (one-sided at the
    edges, `jnp.gradient`), in promote(out.dtype, fp32), cast to R's dtype."""
    B, H, W, _ = out.shape
    cx, cy = W // 2, H // 2
    dt = torch.promote_types(out.dtype, torch.float32)
    gf = g.to(dt)
    outf = out.to(dt)
    d_dy, d_dx = torch.gradient(outf, dim=(1, 2))
    i00, i01, i10, i11 = (t[:, None, None] for t in _inverse_2x2(R.to(dt)))
    gx, gy = _dst_grid(B, H, W, dt, out.device)
    dx = gx - cx
    dy = gy - cy
    u1 = i00 * dx + i01 * dy
    u2 = i10 * dx + i11 * dy
    gdx = torch.sum(gf * d_dx, dim=-1)
    gdy = torch.sum(gf * d_dy, dim=-1)
    rbar = -torch.stack([
        torch.stack([torch.sum(gdx * u1, (1, 2)), torch.sum(gdx * u2, (1, 2))], -1),
        torch.stack([torch.sum(gdy * u1, (1, 2)), torch.sum(gdy * u2, (1, 2))], -1),
    ], dim=-2)
    return rbar.to(R.dtype)


def _fast_diff_warp_xbar(R: Tensor, g: Tensor) -> Tensor:
    """The image's cotangent of the fast warp: the same fast warp of the
    output cotangent by R^{-1} with zeros fill (the JAX package's "sample ~
    splat" approximation of the bilinear adjoint; no transpose kernel), K5
    then K6 on the card."""
    from equiadapt_tpu_torch.ops.kernels.shear_rotate import warp_rotate_center_fast

    dt = torch.promote_types(g.dtype, torch.float32)
    i00, i01, i10, i11 = _inverse_2x2(R.to(dt))
    Rinv = torch.stack([torch.stack([i00, i01], -1),
                        torch.stack([i10, i11], -1)], dim=-2).to(R.dtype)
    return warp_rotate_center_fast(g.contiguous(), Rinv, "zeros")


class _FastDiffWarp(torch.autograd.Function):
    """The fast warp with the JAX package's closed-form backward. Forward
    runs with grad mode off, so the kernels' gradient guard does not fire
    here."""

    @staticmethod
    def forward(ctx, x: Tensor, R: Tensor, padding_mode: str) -> Tensor:
        from equiadapt_tpu_torch.ops.kernels.shear_rotate import warp_rotate_center_fast

        out = warp_rotate_center_fast(x.contiguous(), R, padding_mode)
        ctx.save_for_backward(R, out)
        return out

    @staticmethod
    def backward(ctx, g: Tensor):
        R, out = ctx.saved_tensors
        xbar = _fast_diff_warp_xbar(R, g) if ctx.needs_input_grad[0] else None
        rbar = _fast_diff_warp_rbar(R, out, g) if ctx.needs_input_grad[1] else None
        return xbar, rbar, None


def warp_center_rotation_fast_diff(x: Tensor, R: Tensor,
                                   padding_mode: str = "border") -> Tensor:
    """Differentiable fast-mode centred rotation warp of square NHWC images,
    out(p) = x(R^{-1}(p - c) + c), c = (W//2, H//2).

    Forward: `warp_rotate_center_fast` (K5 then K6 on the card, their plain
    versions on the CPU). Backward, as the JAX package's: the rotation's
    cotangent in closed form, -(grad out)_i u_j summed against the output
    cotangent (`_fast_diff_warp_rbar`), and the image's cotangent as the
    fast warp of the output cotangent by R^{-1} (`_fast_diff_warp_xbar`),
    only where the image needs a gradient. Neither is autograd through the
    forward, and the image's is not an exact adjoint."""
    return _FastDiffWarp.apply(x, R, padding_mode)
