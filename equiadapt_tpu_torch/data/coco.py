"""COCO instance-segmentation data: the local annotation reader and the
synthetic stand-in.

Counterpart of `equiadapt_tpu/data/coco.py`: SAM's ResizeLongestSide with
square zero padding (`resize_and_pad`, numpy), the annotation JSON of a
local COCO tree (`load_coco_annotations`; nothing is downloaded) and the
synthetic rectangles task (`synthetic_coco_batch`), whose draws come from
an explicit `torch.Generator` and whose tensors are made on its device.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

__all__ = ["resize_and_pad", "synthetic_coco_batch", "load_coco_annotations"]


def resize_and_pad(
    image: np.ndarray, boxes: np.ndarray, masks: np.ndarray, target: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Nearest-neighbour resize of the longest side to `target`, zero pad to
    a square, with the boxes scaled and the (N, H, W) masks resized and
    padded alike."""
    h, w = image.shape[:2]
    scale = target / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    yi = (np.arange(nh) / scale).clip(0, h - 1).astype(int)
    xi = (np.arange(nw) / scale).clip(0, w - 1).astype(int)
    img_r = image[yi][:, xi]
    out = np.zeros((target, target) + image.shape[2:], image.dtype)
    out[:nh, :nw] = img_r
    boxes = boxes * scale
    if masks.size:
        masks_r = masks[:, yi][:, :, xi]
        masks_out = np.zeros((masks.shape[0], target, target), masks.dtype)
        masks_out[:, :nh, :nw] = masks_r
    else:
        masks_out = np.zeros((0, target, target), masks.dtype)
    return out, boxes, masks_out


def load_coco_annotations(data_path: str, split: str = "val2017") -> Dict:
    """Parse `<data_path>/annotations/instances_<split>.json`."""
    ann_file = os.path.join(data_path, "annotations", f"instances_{split}.json")
    if not os.path.isfile(ann_file):
        raise FileNotFoundError(
            f"COCO annotations not found at {ann_file}; nothing is downloaded: "
            "place a local copy or use synthetic_coco_batch"
        )
    with open(ann_file) as f:
        return json.load(f)


def rectangles_batch(xy1: Tensor, wh: Tensor, noise: Tensor) -> Dict[str, Tensor]:
    """The rectangles task from its draws: boxes [xy1, xy1 + wh] (B, N, 4)
    prompt their own filled masks (B, N, S, S); the image (B, S, S, 3) is the
    masks' sum in every channel plus `noise` (B, S, S, 3)."""
    B, N, _ = xy1.shape
    size = noise.shape[1]
    boxes = torch.cat([xy1, xy1 + wh], dim=-1)
    ys = torch.arange(size, device=xy1.device)[None, None, :, None]
    xs = torch.arange(size, device=xy1.device)[None, None, None, :]
    masks = (
        (xs >= boxes[..., 0, None, None])
        & (xs < boxes[..., 2, None, None])
        & (ys >= boxes[..., 1, None, None])
        & (ys < boxes[..., 3, None, None])
    ).float()
    image = masks.sum(dim=1)[..., None].expand(B, size, size, 3) + noise
    return {
        "image": image.float(),
        "targets": {
            "boxes": boxes,
            "masks": masks,
            "labels": torch.ones(B, N, dtype=torch.int32, device=xy1.device),
            "valid": torch.ones(B, N, device=xy1.device),
        },
    }


def synthetic_coco_batch(generator: torch.Generator, batch: int,
                         image_size: int = 128,
                         num_prompts: int = 4) -> Dict[str, Tensor]:
    """Random rectangles: corners uniform in [0, size / 2), sides uniform in
    [8, 8 + 0.4 size), image noise N(0, 0.05^2); every prompt valid."""
    dev = generator.device
    xy1 = torch.rand(batch, num_prompts, 2, generator=generator,
                     device=dev) * (image_size * 0.5)
    wh = torch.rand(batch, num_prompts, 2, generator=generator,
                    device=dev) * (image_size * 0.4) + 8
    noise = 0.05 * torch.randn(batch, image_size, image_size, 3,
                               generator=generator, device=dev)
    return rectangles_batch(xy1, wh, noise)
