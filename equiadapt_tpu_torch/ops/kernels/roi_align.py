"""Multi-scale RoIAlign over a feature pyramid, as one hand-written kernel.

For regions of interest `boxes` (R, 4) xyxy in image pixels, each with its
image `batch_idx` (R,) and pyramid `level` (R,), and feature maps `feats`
(one (B, C, H_l, W_l) map a level, image pixel i of level l at feature
position i * scales[l]), the output (R, C, P, P) is torchvision's
`roi_align(..., aligned=False)` of each region on its level's map:

* the region's corners times the level's scale; its width and height at
  least 1; bins of a P-th of each;
* S x S samples a bin (S = `sampling_ratio`), at y = start + ph bin_h +
  (iy + 0.5) bin_h / S (and x likewise);
* each sample bilinear in the map: 0 where y < -1, y > H, x < -1 or x > W;
  coordinates below 0 taken as 0; the upper tap clamped to the last row or
  column (and the coordinate with it);
* the bin the mean of its samples, accumulated in fp32.

`roi_align` launches the kernel of `csrc/roi_align.cu` for CUDA tensors,
one launch over every region and every level, reading fp32 or bf16 maps of
any strides (the FPN's channels-last maps read a region's taps as whole
rows of channels) and writing the output in the maps' dtype, channels-last
(`out.permute(0, 2, 3, 1)` is contiguous). CPU tensors take
`roi_align_plain`, the same arithmetic in PyTorch. The kernel replaces no
TPU kernel: the JAX package has no RoIAlign (its MaskRCNNLite pools no
regions). Its source says what bounds it and how it is built.

`launches` counts the launches by dtype, e.g.
`launches["roi_align/bfloat16"]`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

from equiadapt_tpu_torch.ops.kernels import _build

Tensor = torch.Tensor

__all__ = ["roi_align", "roi_align_plain", "sample_axis", "launches", "reset_launches",
           "MAX_LEVELS"]

_KERNELS = "the multi-scale RoIAlign kernel"
_DIFFERENTIABLE = "roi_align_plain (CPU tensors) is the differentiable version"
MAX_LEVELS = 4

# kernel launches by dtype, e.g. launches["roi_align/bfloat16"]
launches: Dict[str, int] = {}


def reset_launches() -> None:
    launches.clear()


def sample_axis(lo: Tensor, hi: Tensor, scale: float, size: int, pooled: int,
                sampling_ratio: int):
    """One axis of every region's samples, torchvision's arithmetic in
    fp32: lo and hi (R,) are the region's edges in image pixels. Returns
    (i_low, i_high, w_low, w_high), each (R, pooled * sampling_ratio), the
    samples in bin-major order; the weights are 0 where a sample lies
    outside (below -1 or above `size`)."""
    start = lo.float() * scale
    length = torch.clamp(hi.float() * scale - start, min=1.0)
    # divisors as tensors: PyTorch's CUDA division by a scalar multiplies by
    # its reciprocal, which moves a sample by an ulp from the kernel's
    bin_size = length / torch.full_like(length, pooled)
    p = torch.arange(pooled, device=lo.device, dtype=torch.float32)
    i = torch.arange(sampling_ratio, device=lo.device, dtype=torch.float32)
    part = (i[None, None, :] + 0.5) * bin_size[:, None, None]
    pos = ((start[:, None, None] + p[None, :, None] * bin_size[:, None, None])
           + part / torch.full_like(part, sampling_ratio))
    pos = pos.reshape(pos.shape[0], -1)
    inside = (pos >= -1.0) & (pos <= size)
    pos = torch.clamp(pos, min=0.0)
    low = pos.to(torch.int64)
    last = low >= size - 1
    low = torch.where(last, torch.full_like(low, size - 1), low)
    high = torch.where(last, low, low + 1)
    pos = torch.where(last, low.float(), pos)
    frac = pos - low.float()
    zero = torch.zeros_like(frac)
    return low, high, torch.where(inside, 1.0 - frac, zero), torch.where(inside, frac, zero)


def _check(feats: Sequence[Tensor], boxes: Tensor, batch_idx: Tensor, level: Tensor,
           scales: Sequence[float]) -> None:
    if not 1 <= len(feats) <= MAX_LEVELS or len(scales) != len(feats):
        raise ValueError(f"1 to {MAX_LEVELS} maps with a scale each, got {len(feats)} maps "
                         f"and {len(scales)} scales")
    B, C = feats[0].shape[:2]
    for f in feats:
        if f.dim() != 4 or f.shape[:2] != (B, C) or f.dtype != feats[0].dtype:
            raise ValueError("maps of one batch, channel count and dtype, (B, C, H, W)")
    if boxes.dim() != 2 or boxes.shape[1] != 4 or boxes.dtype != torch.float32:
        raise ValueError(f"boxes (R, 4) float32, got {tuple(boxes.shape)} {boxes.dtype}")
    R = boxes.shape[0]
    for name, t in (("batch_idx", batch_idx), ("level", level)):
        if t.shape != (R,) or t.is_floating_point():
            raise ValueError(f"{name} ({R},) integers, got {tuple(t.shape)} {t.dtype}")


def roi_align_plain(feats: Sequence[Tensor], boxes: Tensor, batch_idx: Tensor,
                    level: Tensor, scales: Sequence[float], output_size: int,
                    sampling_ratio: int = 2) -> Tensor:
    """The kernel's function in PyTorch (module docstring): (R, C, P, P) in
    the maps' dtype, each bin's samples summed in fp32 in torchvision's
    order (the four taps of a sample, then the samples row by row)."""
    _check(feats, boxes, batch_idx, level, scales)
    P, S = output_size, sampling_ratio
    R, C = boxes.shape[0], feats[0].shape[1]
    out = torch.zeros(R, C, P, P, dtype=torch.float32, device=boxes.device)
    b = batch_idx.long()
    for lv, (f, scale) in enumerate(zip(feats, scales)):
        H, W = f.shape[2:]
        ylo, yhi, wyl, wyh = sample_axis(boxes[:, 1], boxes[:, 3], scale, H, P, S)
        xlo, xhi, wxl, wxh = sample_axis(boxes[:, 0], boxes[:, 2], scale, W, P, S)
        f32 = f.float()

        def tap(yi, xi):  # (R, P S, P S, C)
            return f32[b[:, None, None], :, yi[:, :, None], xi[:, None, :]]

        val = (((wyl[:, :, None] * wxl[:, None, :])[..., None] * tap(ylo, xlo)
                + (wyl[:, :, None] * wxh[:, None, :])[..., None] * tap(ylo, xhi))
               + (wyh[:, :, None] * wxl[:, None, :])[..., None] * tap(yhi, xlo)) \
            + (wyh[:, :, None] * wxh[:, None, :])[..., None] * tap(yhi, xhi)
        val = val.reshape(R, P, S, P, S, C)
        acc = torch.zeros(R, P, P, C, dtype=torch.float32, device=boxes.device)
        for iy in range(S):
            for ix in range(S):
                acc = acc + val[:, :, iy, :, ix]
        pooled = (acc / float(S * S)).permute(0, 3, 1, 2)
        out = torch.where((level.long() == lv)[:, None, None, None], pooled, out)
    return out.to(feats[0].dtype)


def _fake(feats, boxes, batch_idx, level, scales, output_size, sampling_ratio):
    R, C = boxes.shape[0], feats[0].shape[1]
    P = output_size
    return feats[0].new_empty((R, P, P, C)).permute(0, 3, 1, 2)


def roi_align(feats: Sequence[Tensor], boxes: Tensor, batch_idx: Tensor, level: Tensor,
              scales: Sequence[float], output_size: int, sampling_ratio: int = 2) -> Tensor:
    """Multi-scale RoIAlign (module docstring): the kernel for CUDA tensors,
    `roi_align_plain` for CPU tensors; (R, C, P, P) in the maps' dtype.
    Meta tensors inside `_build.shapes_only()` give an empty result of
    that shape."""
    _check(feats, boxes, batch_idx, level, scales)
    tensors = [*feats, boxes, batch_idx, level]
    where = _build.route(tensors, _KERNELS)
    if where == "meta":
        return _fake(feats, boxes, batch_idx, level, scales, output_size, sampling_ratio)
    if where == "cpu":
        return roi_align_plain(feats, boxes, batch_idx, level, scales, output_size,
                               sampling_ratio)
    _build.refuse_grad(list(feats), _KERNELS, _DIFFERENTIABLE)
    return _roi_align_op(list(feats), boxes, batch_idx, level, [float(s) for s in scales],
                         output_size, sampling_ratio)


def _lib() -> ctypes.CDLL:
    lib = _build.load("roi_align")
    fn = lib.eqt_roi_align
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(ctypes.c_longlong),
                       ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float), ci,
                       vp, vp, vp, vp, ctypes.POINTER(ctypes.c_longlong),
                       ci, ci, ci, ci, ci, vp]
        fn.restype = ci
    return lib


def _launch(feats, boxes, batch_idx, level, scales, output_size, sampling_ratio):
    f0 = feats[0]
    if f0.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{_KERNELS} takes float32 or bfloat16 maps, got {f0.dtype}")
    if not 1 <= sampling_ratio <= 8 or not 1 <= output_size <= 32:
        raise ValueError(f"{_KERNELS} takes sampling ratios 1-8 and outputs up to 32, got "
                         f"{sampling_ratio} and {output_size}")
    R, C, P = boxes.shape[0], f0.shape[1], output_size
    out = torch.empty((R, P, P, C), dtype=f0.dtype, device=f0.device).permute(0, 3, 1, 2)
    if R == 0:
        return out
    L = len(feats)
    ptrs = (ctypes.c_void_p * MAX_LEVELS)(*[f.data_ptr() for f in feats],
                                          *[None] * (MAX_LEVELS - L))
    strides = [s for f in feats for s in f.stride()] + [0] * 4 * (MAX_LEVELS - L)
    sizes = [n for f in feats for n in f.shape[2:]] + [0] * 2 * (MAX_LEVELS - L)
    boxes = boxes.contiguous()
    bi, lv = batch_idx.to(torch.int32).contiguous(), level.to(torch.int32).contiguous()
    err = _lib().eqt_roi_align(
        ptrs, (ctypes.c_longlong * (4 * MAX_LEVELS))(*strides),
        (ctypes.c_int * (2 * MAX_LEVELS))(*sizes),
        (ctypes.c_float * MAX_LEVELS)(*scales, *[0.0] * (MAX_LEVELS - L)), L,
        boxes.data_ptr(), bi.data_ptr(), lv.data_ptr(), out.data_ptr(),
        (ctypes.c_longlong * 4)(*out.stride()), R, C, P, sampling_ratio,
        _build.DTYPE_CODES[f0.dtype], torch.cuda.current_stream(f0.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"roi_align launch failed: cudaError {err}")
    key = f"roi_align/{str(f0.dtype).removeprefix('torch.')}"
    launches[key] = launches.get(key, 0) + 1
    return out


# the kernel as a registered operator around `_launch` (`_build.register_op`)
_roi_align_op = _build.register_op(
    "roi_align(Tensor[] feats, Tensor boxes, Tensor batch_idx, Tensor level, float[] scales, "
    "int output_size, int sampling_ratio) -> Tensor",
    _launch, _fake)
