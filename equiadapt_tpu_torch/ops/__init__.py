"""Warps, group actions and the hand-written kernels (`ops.kernels`)."""

from equiadapt_tpu_torch.ops.boxes import (
    flip_boxes,
    flip_masks,
    rotate_boxes,
    rotate_masks,
    rotate_points,
)
from equiadapt_tpu_torch.ops.group_action import (
    get_action_on_image_features,
    roll_by_gather,
)
from equiadapt_tpu_torch.ops.warp import (
    affine_grid_sample,
    bilinear_sample,
    center_crop,
    group_angles,
    hflip,
    resize,
    rotate,
    warp_affine,
)

__all__ = [
    "flip_boxes",
    "flip_masks",
    "rotate_boxes",
    "rotate_masks",
    "rotate_points",
    "get_action_on_image_features",
    "roll_by_gather",
    "affine_grid_sample",
    "bilinear_sample",
    "center_crop",
    "group_angles",
    "hflip",
    "resize",
    "rotate",
    "warp_affine",
]
