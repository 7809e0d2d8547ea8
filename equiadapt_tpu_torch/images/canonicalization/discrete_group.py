"""Discrete-group (C_n / D_n) image canonicalizers, eval path.

Counterpart of `equiadapt_tpu/images/canonicalization/discrete_group.py`
(`DiscreteGroupImageCanonicalization`, `GroupEquivariantImageCanonicalization`).
NHWC in and out. `canonicalize` returns `(x_canon, info)`:

1. crop and resize the batch for the energy network;
2. (B, |G|) group activations, kept in fp32;
3. hard argmax selection;
4. the D_n reflection blend;
5. the rotate-select of each sample by its element, through kernel K1.

`invert_canonicalization` goes through `ops.group_action` (kernel K2 for a
regular rep).

Not ported yet: training (the `rotate_discrete` blend with a
straight-through one-hot), co-canonicalized targets (boxes and masks) and
the optimized (orbit-scoring) canonicalizer; see ROADMAP.md queue 1. The
JAX package's NCHW-spine serving branch is a TPU layout path with no
counterpart here.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import nn

from equiadapt_tpu_torch.common.base import BaseCanonicalization
from equiadapt_tpu_torch.common.info import (
    DiscreteCanonicalizationInfo,
    DiscreteGroupElement,
)
from equiadapt_tpu_torch.common.selector import select_onehot
from equiadapt_tpu_torch.ops.group_action import get_action_on_image_features
from equiadapt_tpu_torch.ops.kernels.select_warp import rotate_select
from equiadapt_tpu_torch.ops.warp import crop_and_resize, group_angles, hflip

Tensor = torch.Tensor

__all__ = [
    "DiscreteGroupImageCanonicalization",
    "GroupEquivariantImageCanonicalization",
]

_TRAINING = (
    "training is not ported yet (ROADMAP.md queue 1, training slice); "
    "call .eval() and canonicalize with training=False"
)


class DiscreteGroupImageCanonicalization(BaseCanonicalization):
    """Base discrete image canonicalizer.

    Args mirror the JAX module: `in_shape` (H, W, C); `beta` scales the
    straight-through softmax; `input_crop_ratio` / `resize_shape` shape the
    energy network's input (grayscale inputs skip both and warp with zeros
    fill); `warp_mode` "exact" (static-tap residual warps) or "fast"
    (two-pass products); `compute_dtype` for the energy network and the
    warp (None keeps the input's); `output_dtype` None casts the output back
    to the input dtype, "compute" keeps `compute_dtype`.
    """

    def __init__(self, canonicalization_network: nn.Module,
                 in_shape: Tuple[int, int, int], beta: float = 1.0,
                 input_crop_ratio: float = 1.0,
                 resize_shape: Optional[int] = None,
                 gradient_trick: str = "straight_through",
                 warp_mode: str = "exact",
                 compute_dtype: Optional[torch.dtype] = None,
                 output_dtype: Optional[str] = None,
                 group_type: str = "rotation", num_rotations: int = 4):
        super().__init__()
        self.canonicalization_network = canonicalization_network
        self.in_shape = tuple(in_shape)
        self.beta = beta
        self.input_crop_ratio = input_crop_ratio
        self.resize_shape = resize_shape
        self.gradient_trick = gradient_trick
        self.warp_mode = warp_mode
        self.compute_dtype = compute_dtype
        self.output_dtype = output_dtype
        self.group_type = group_type
        self.num_rotations = num_rotations

    @property
    def is_grayscale(self) -> bool:
        return self.in_shape[-1] == 1

    @property
    def num_group(self) -> int:
        return self.num_rotations * (2 if self.group_type == "roto-reflection" else 1)

    @property
    def padding_mode(self) -> str:
        # RGB: the reference's edge-pad + crop sandwich == border sampling
        return "zeros" if self.is_grayscale else "border"

    def transformations_before_canonicalization_network_forward(
        self, x: Tensor
    ) -> Tensor:
        """Centre-crop by input_crop_ratio, then resize (NHWC)."""
        return crop_and_resize(x, self.in_shape, self.input_crop_ratio,
                               self.resize_shape)

    def get_group_activations(self, x: Tensor) -> Tensor:
        """Subclass hook: (B, |G|) activations."""
        raise NotImplementedError

    def groupactivations_to_groupelement(
        self, group_activations: Tensor
    ) -> Tuple[DiscreteGroupElement, Tensor]:
        """Hard argmax -> (rotation degrees, reflection indicator)."""
        onehot = select_onehot(
            group_activations, gradient_trick=self.gradient_trick,
            beta=self.beta, training=False,
        )
        angles = group_angles(self.num_rotations, device=onehot.device)
        if self.group_type == "roto-reflection":
            rot_table = torch.cat([angles, angles])
            refl_table = torch.cat(
                [torch.zeros_like(angles), torch.ones_like(angles)]
            )
            rotation = torch.sum(onehot * rot_table, dim=-1)
            reflection = torch.sum(onehot * refl_table, dim=-1)
            return DiscreteGroupElement(rotation, reflection), onehot
        rotation = torch.sum(onehot * angles, dim=-1)
        return DiscreteGroupElement(rotation, None), onehot

    def canonicalize(self, x: Tensor, targets: Optional[Any] = None, *,
                     training: bool = False, **kwargs: Any):
        """Map an NHWC batch to canonical pose: `(x_canon, info)`."""
        if training or self.training:
            raise NotImplementedError(_TRAINING)
        if targets is not None:
            raise NotImplementedError(
                "co-canonicalized targets (boxes, masks) are not ported yet "
                "(ROADMAP.md queue 1, segmentation)"
            )
        in_dtype = x.dtype
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        acts = self.get_group_activations(x).float()  # selection stays fp32
        element, onehot = self.groupactivations_to_groupelement(acts)
        if element.reflection is not None:
            r = element.reflection[:, None, None, None].to(x.dtype)
            x = (1.0 - r) * x + r * hflip(x)
        n = self.num_rotations
        rot_onehot = (
            onehot[:, :n] + onehot[:, n:]
            if self.group_type == "roto-reflection" else onehot
        )
        idx = torch.argmax(rot_onehot, dim=-1)
        x = rotate_select(x, idx, n, -1.0, self.padding_mode, self.warp_mode)
        if self.output_dtype != "compute":
            x = x.to(in_dtype)
        info = DiscreteCanonicalizationInfo(
            group_activations=acts,
            onehot=onehot,
            element=element,
            num_rotations=self.num_rotations,
            group_type=self.group_type,
        )
        return x, info

    def invert_canonicalization(
        self, info: DiscreteCanonicalizationInfo, x_canonicalized_out: Tensor,
        induced_rep_type: str = "regular", training: bool = False,
        **kwargs: Any,
    ) -> Tensor:
        """Apply the stored element to canonical-frame NHWC outputs."""
        if training:
            raise NotImplementedError(_TRAINING)
        return get_action_on_image_features(
            x_canonicalized_out,
            num_rotations=info.num_rotations,
            num_group=info.num_group,
            rotation_deg=info.element.rotation_deg,
            reflection=info.element.reflection,
            induced_rep_type=induced_rep_type,
            mode=self.warp_mode,
        )


class GroupEquivariantImageCanonicalization(DiscreteGroupImageCanonicalization):
    """Energy from a group-equivariant network: its output fiber is the
    activation vector. `group_type` / `num_rotations` must match the
    network's."""

    def get_group_activations(self, x: Tensor) -> Tensor:
        x = self.transformations_before_canonicalization_network_forward(x)
        return self.canonicalization_network(x)
