"""Batched box and mask group transforms for instance-segmentation targets.

Counterpart of `equiadapt_tpu/ops/boxes.py`: every op is vectorized over
(B, N, ...). Boxes are xyxy in pixel coordinates; masks are (..., H, W)
bitmaps. `rotate_masks` goes through the bilinear `ops.warp.rotate`
(zeros fill); no kernel lies on it.
"""

from __future__ import annotations

import torch

from equiadapt_tpu_torch.ops.warp import rotate

Tensor = torch.Tensor

__all__ = ["flip_boxes", "flip_masks", "rotate_points", "rotate_boxes", "rotate_masks"]


def flip_boxes(boxes: Tensor, width: float) -> Tensor:
    """Horizontal flip of (..., 4) xyxy boxes."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([width - x2, y1, width - x1, y2], dim=-1)


def flip_masks(masks: Tensor) -> Tensor:
    """Horizontal flip of (..., H, W) masks."""
    return masks.flip(-1)


def rotate_points(origin, px: Tensor, py: Tensor, angle_rad: Tensor):
    """Rotate points about `origin` (ox, oy); angle_rad broadcasts against
    the point arrays."""
    ox, oy = origin
    c = torch.cos(angle_rad)
    s = torch.sin(angle_rad)
    qx = ox + c * (px - ox) - s * (py - oy)
    qy = oy + s * (px - ox) + c * (py - oy)
    return qx, qy


def rotate_boxes(boxes: Tensor, angle_deg, width: float) -> Tensor:
    """Rotate xyxy boxes about the image centre and re-axis-align them: the
    (min, min) and (max, max) corners are rotated and the coordinate-wise
    min / max taken (the reference's lossy re-alignment).

    Args:
        boxes: (B, N, 4) or (N, 4).
        angle_deg: degrees, broadcastable per box or per batch ((B,) with
            (B, N, 4) boxes).
    """
    origin = (width / 2.0, width / 2.0)
    rad = torch.deg2rad(torch.as_tensor(angle_deg, device=boxes.device))
    if boxes.ndim == 3 and rad.ndim == 1:
        rad = rad[:, None]
    x1, y1, x2, y2 = boxes.unbind(-1)
    xmin_r, ymin_r = rotate_points(origin, x1, y1, rad)
    xmax_r, ymax_r = rotate_points(origin, x2, y2, rad)
    xlo = torch.minimum(xmin_r, xmax_r)
    xhi = torch.maximum(xmin_r, xmax_r)
    ylo = torch.minimum(ymin_r, ymax_r)
    yhi = torch.maximum(ymin_r, ymax_r)
    return torch.stack([xlo, ylo, xhi, yhi], dim=-1)


def rotate_masks(masks: Tensor, angle_deg) -> Tensor:
    """Rotate (B, N, H, W) masks by per-sample angles (degrees): the N masks
    of a sample are the channels of one bilinear rotate, zeros fill."""
    out = rotate(masks.movedim(1, -1), angle_deg, padding_mode="zeros")
    return out.movedim(-1, 1)
