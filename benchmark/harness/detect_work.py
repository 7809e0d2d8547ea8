"""The work of the detection cell, counted from the configuration, the shapes
and the regions the program pooled.

* FLOPs (2 x multiply-accumulate of every convolution and matrix product),
  counted with `FlopCounterMode` on meta tensors run through the benchmark's
  reference, never through the program: the C4 GCNN on the batch, and per
  image the ResNet-50-FPN at the resized size, the RPN head on P2-P6, the
  box head on `rpn_post_nms_top_n` regions and the mask head on
  `box_detections_per_img` detections. NMS, RoIAlign, the paste and the
  selections count no FLOPs here (no product).
* RoIAlign's byte floor (`roi_align_bytes`): every distinct map pixel that
  some sample's four taps name, read once, and every output value written
  once, at the maps' dtype. Taps shared by neighbouring samples count once,
  so the floor does not exceed what the maps hold: a kernel can reach it
  and not pass it.
* NMS: each pair of valid boxes of one segment is one IoU of
  `NMS_PAIR_FLOPS` fp32 operations (four min / max, two differences, two
  clamps, the intersection's product, a sum and a difference for the union,
  a division, a comparison: each box's area once a box, not a pair), at the
  card's fp32 rate, `FP32_PEAK_FLOPS` (H100 SXM data sheet, 67 TFLOP/s
  without tensor cores).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

NMS_PAIR_FLOPS = 13
FP32_PEAK_FLOPS = 67e12
_BYTES = {"float32": 4, "bfloat16": 2}


def _meta_weights(ref, settings: dict) -> dict:
    return {name: torch.empty(shape, device="meta")
            for name, shape, _ in ref.param_spec(settings)}


def count_flops(ref, settings: dict, batch: int) -> Dict[str, int]:
    """{"flops_per_iter", "canon_flops", "image_flops"}: the reference's
    FLOPs of one batch, of its canonicalizer and of one image's detector."""
    size = settings["dataset"]["image_size"]
    m = settings["maskrcnn"]
    w = _meta_weights(ref, settings)
    with FlopCounterMode(display=False) as c:
        ref.canon.energy_map(w, torch.empty(batch, size, size, 3, device="meta"), settings)
    with FlopCounterMode(display=False) as d:
        _, feats = ref.features(w, torch.empty(1, size, size, 3, device="meta"), settings)
        ref.rpn_head(w, feats)
        ref.box_head(w, torch.empty(m["rpn_post_nms_top_n"], 256, 7, 7, device="meta"))
        D = m["box_detections_per_img"]
        ref.mask_head(w, torch.empty(D, 256, 14, 14, device="meta"),
                      torch.zeros(D, dtype=torch.long, device="meta"))
    canon, image = int(c.get_total_flops()), int(d.get_total_flops())
    return {"flops_per_iter": canon + batch * image, "canon_flops": canon,
            "image_flops": image}


def _taps(lo: torch.Tensor, hi: torch.Tensor, scale: float, size: int, P: int,
          S: int) -> torch.Tensor:
    """(n, 2 P S) map rows (or columns) the samples of n regions read:
    torchvision's sample positions, their lower and upper taps."""
    start = lo * scale
    bin_size = torch.clamp(hi * scale - start, min=1.0) / P
    p = torch.arange(P, device=lo.device, dtype=torch.float32)
    i = torch.arange(S, device=lo.device, dtype=torch.float32)
    pos = (start[:, None, None] + p[None, :, None] * bin_size[:, None, None]
           + (i[None, None, :] + 0.5) * bin_size[:, None, None] / S).reshape(len(lo), -1)
    low = torch.clamp(pos, min=0.0).long().clamp(max=size - 1)
    high = torch.clamp(low + 1, max=size - 1)
    return torch.cat([low, high], dim=1)


def roi_align_bytes(boxes: torch.Tensor, maps: Sequence[Tuple[int, int]],
                    image: Tuple[int, int], P: int, S: int, channels: int,
                    dtype: str) -> int:
    """RoIAlign's byte floor for one launch over boxes (B, R, 4) in the
    resized image's pixels, on maps of `maps` (H, W) (P2 first), each
    region on its level (`LevelMapper`)."""
    B, R, _ = boxes.shape
    rois = boxes.reshape(-1, 4).float()
    batch = torch.arange(B, device=boxes.device).repeat_interleave(R)
    scales = [2.0 ** round(math.log2(h / image[0])) for h, _ in maps]
    k_min = int(-math.log2(scales[0]))
    s = torch.sqrt((rois[:, 2] - rois[:, 0]) * (rois[:, 3] - rois[:, 1]))
    lvl = torch.floor(4 + torch.log2(s / 224) + torch.tensor(1e-6, dtype=s.dtype))
    level = torch.clamp(lvl, k_min, k_min + len(maps) - 1).long() - k_min
    pixels = 0
    for lv, ((H, W), scale) in enumerate(zip(maps, scales)):
        sel = level == lv
        if not bool(sel.any()):
            continue
        r, b = rois[sel], batch[sel]
        ys = _taps(r[:, 1], r[:, 3], scale, H, P, S)
        xs = _taps(r[:, 0], r[:, 2], scale, W, P, S)
        occupied = torch.zeros(B, H, W, dtype=torch.bool, device=boxes.device)
        occupied[b[:, None, None], ys[:, :, None], xs[:, None, :]] = True
        pixels += int(occupied.sum())
    each = _BYTES[dtype]
    return (pixels + B * R * P * P) * channels * each
