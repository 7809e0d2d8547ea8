"""Greedy non-maximum suppression of many segments at once, on the device.

For boxes (S, N, 4) xyxy fp32, scores (S, N) and valid (S, N), each of the
S segments (an image and level, or an image and class) is suppressed on its
own: its valid boxes in descending score order (a stable sort, so that
equal scores keep their index order), each box kept unless a kept box
before it overlaps it by an IoU above `threshold`. IoU is inter / (area_a
+ area_b - inter) in fp32, each operation rounded on its own; torchvision's
`nms` computes it so. `segment_nms` returns keep (S, N) bool in the input
order; invalid boxes are never kept and suppress nothing. No result is read
on the host: the served call does not wait for the card.

`segment_nms` launches the kernels of `csrc/nms.cu` (an IoU bitmask pass,
then a greedy scan, one warp a segment) for CUDA tensors, and takes
`nms_keep_plain` (the pairwise IoU matrix and the greedy loop in PyTorch)
for CPU tensors; both take the boxes already sorted. The kernels replace no
TPU kernel: the JAX package suppresses nothing. The source says what bounds
them and how they are built.

`launches` counts the launches, `launches["nms"]`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from equiadapt_tpu_torch.ops.kernels import _build

Tensor = torch.Tensor

__all__ = ["segment_nms", "sort_segments", "nms_keep", "nms_keep_plain", "pairwise_iou",
           "launches", "reset_launches", "MAX_N"]

_KERNELS = "the segmented NMS kernels"
MAX_N = 2048  # boxes a segment: 32 words of the removed set, one a lane of the scan's warp
MAX_SEGMENTS = 65535

launches: Dict[str, int] = {}


def reset_launches() -> None:
    launches.clear()


def pairwise_iou(a: Tensor, b: Tensor) -> Tensor:
    """(..., n, 4) x (..., m, 4) -> (..., n, m) IoU, rows a, columns b, in
    the kernel's order of operations."""
    ax1, ay1, ax2, ay2 = (t[..., :, None] for t in a.unbind(-1))
    bx1, by1, bx2, by2 = (t[..., None, :] for t in b.unbind(-1))
    w = torch.clamp(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1), min=0.0)
    h = torch.clamp(torch.minimum(ay2, by2) - torch.maximum(ay1, by1), min=0.0)
    inter = w * h
    return inter / ((ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter)


def nms_keep_plain(boxes: Tensor, counts: Tensor, threshold: float) -> Tensor:
    """The kernels' function in PyTorch: sorted boxes (S, N, 4), each
    segment's first counts[s] valid -> keep (S, N) bool in that order."""
    S, N, _ = boxes.shape
    sup = pairwise_iou(boxes, boxes) > threshold
    idx = torch.arange(N, device=boxes.device)
    later = idx[None, :] > idx[:, None]
    valid = idx[None, :] < counts[:, None]
    keep = torch.zeros(S, N, dtype=torch.bool, device=boxes.device)
    removed = torch.zeros(S, N, dtype=torch.bool, device=boxes.device)
    for i in range(N):
        k = valid[:, i] & ~removed[:, i]
        keep[:, i] = k
        removed |= k[:, None] & sup[:, i, :] & later[i][None, :]
    return keep


def _check(boxes: Tensor, counts: Tensor) -> None:
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or boxes.dtype != torch.float32:
        raise ValueError(f"boxes (S, N, 4) float32, got {tuple(boxes.shape)} {boxes.dtype}")
    if counts.shape != boxes.shape[:1] or counts.is_floating_point():
        raise ValueError(f"counts ({boxes.shape[0]},) integers, got {tuple(counts.shape)}")


def nms_keep(boxes: Tensor, counts: Tensor, threshold: float) -> Tensor:
    """Sorted boxes (S, N, 4) fp32 and each segment's valid count (S,) ->
    keep (S, N) bool, sorted order: the kernels for CUDA tensors,
    `nms_keep_plain` for CPU tensors."""
    _check(boxes, counts)
    where = _build.route([boxes, counts], _KERNELS)
    if where == "meta":
        return _fake(boxes, counts, threshold)
    if where == "cpu":
        return nms_keep_plain(boxes, counts, threshold)
    return _nms_op(boxes, counts, float(threshold))


def sort_segments(scores: Tensor, valid: Tensor) -> Tuple[Tensor, Tensor]:
    """(order, counts): each segment's indices by descending score, valid
    ones first, ties in index order; and its valid count (int32)."""
    key = torch.where(valid, scores.float(), torch.full_like(scores, float("-inf"),
                                                              dtype=torch.float32))
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices
    return order, valid.sum(-1, dtype=torch.int32)


def segment_nms(boxes: Tensor, scores: Tensor, valid: Tensor,
                threshold: float) -> Tuple[Tensor, Tensor]:
    """Greedy NMS of each segment (module docstring): boxes (S, N, 4),
    scores and valid (S, N) -> (keep (S, N) bool in the input order, the
    valid counts (S,) int32)."""
    order, counts = sort_segments(scores, valid)
    sorted_boxes = torch.gather(boxes.float(), 1, order[..., None].expand(-1, -1, 4))
    kept = nms_keep(sorted_boxes.contiguous(), counts, threshold)
    keep = torch.zeros_like(kept).scatter_(1, order, kept)
    return keep, counts


def _fake(boxes, counts, threshold):
    return boxes.new_empty(boxes.shape[:2], dtype=torch.bool)


def _lib() -> ctypes.CDLL:
    lib = _build.load("nms")
    fn = lib.eqt_nms_keep
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ctypes.c_float, vp]
        fn.restype = ci
    return lib


def _launch(boxes: Tensor, counts: Tensor, threshold: float) -> Tensor:
    S, N, _ = boxes.shape
    if N > MAX_N or S > MAX_SEGMENTS:
        raise ValueError(f"{_KERNELS} take up to {MAX_SEGMENTS} segments of up to {MAX_N} "
                         f"boxes, got {S} of {N}")
    boxes = boxes.contiguous()
    counts = counts.to(torch.int32).contiguous()
    words = -(-N // 64)
    mask = torch.empty((S, N, words), dtype=torch.int64, device=boxes.device)
    keep = torch.empty((S, N), dtype=torch.uint8, device=boxes.device)
    err = _lib().eqt_nms_keep(boxes.data_ptr(), counts.data_ptr(), mask.data_ptr(),
                              keep.data_ptr(), S, N, threshold,
                              torch.cuda.current_stream(boxes.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nms launch failed: cudaError {err}")
    launches["nms"] = launches.get("nms", 0) + 1
    return keep.view(torch.bool)


# the kernels as a registered operator around `_launch` (`_build.register_op`)
_nms_op = _build.register_op(
    "nms_keep(Tensor boxes, Tensor counts, float threshold) -> Tensor", _launch, _fake)
