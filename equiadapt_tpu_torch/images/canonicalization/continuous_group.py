"""Continuous-group (SO(2) / O(2)) image canonicalizers, eval path.

Counterpart of `equiadapt_tpu/images/canonicalization/continuous_group.py`
(`ContinuousGroupImageCanonicalization`, `SteerableImageCanonicalization`).
NHWC in and out. The network emits 2-D vectors; a rotation (or
roto-reflection) matrix is built from them, and the image is warped into
canonical pose by the matrix inverse (the transpose trick: negating the
off-diagonals inverts a rotation). The reference's edge-pad -> warp -> crop
sandwich is one border-sampled warp about (H//2, W//2) of the unpadded
image.

Warps: `warp_mode="exact"` runs kernel K7 (direct 4-tap bilinear; its
plain version `_warp_center_affine` lives beside it in
`ops/kernels/bilinear_warp.py`); `warp_mode="fast"` runs K5 (centered
quarter turn) then K6 (three-shear residual). Each wrapper takes its kernel
for CUDA tensors and its plain version for CPU tensors; the JAX package's
`_exact_warp` dispatch (kernel options, tiling gate) has no counterpart.

`invert_canonicalization` warps "scalar" outputs by the forward element
with zeros fill, then blends the reflection; "vector" raises, as in the JAX
package.

Not ported yet: training (the differentiable warps
`warp_center_rotation_fast_diff` and the exact warp's autodiff through the
sample coordinates), `OptimizedSteerableImageCanonicalization` and
`steerable_optimization_loss`; see ROADMAP.md queue 1.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from equiadapt_tpu_torch.common.base import BaseCanonicalization
from equiadapt_tpu_torch.common.info import (
    ContinuousCanonicalizationInfo,
    ContinuousGroupElement,
)
from equiadapt_tpu_torch.common.math import (
    det_2x2,
    gram_schmidt_2d,
    rotmat_2d_from_vector,
)
from equiadapt_tpu_torch.ops.kernels.bilinear_warp import warp_rotate_center_exact
from equiadapt_tpu_torch.ops.kernels.shear_rotate import warp_rotate_center_fast
from equiadapt_tpu_torch.ops.warp import crop_and_resize, hflip

Tensor = torch.Tensor

__all__ = [
    "ContinuousGroupImageCanonicalization",
    "SteerableImageCanonicalization",
]

_TRAINING = (
    "training is not ported yet (ROADMAP.md queue 1, continuous training); "
    "call .eval() and canonicalize with training=False"
)


def _transpose_trick(R: Tensor) -> Tensor:
    """Negate the off-diagonals: the inverse of a rotation matrix."""
    return torch.stack([torch.stack([R[:, 0, 0], -R[:, 0, 1]], dim=-1),
                        torch.stack([-R[:, 1, 0], R[:, 1, 1]], dim=-1)], dim=-2)


class ContinuousGroupImageCanonicalization(BaseCanonicalization):
    """Base continuous image canonicalizer.

    Args mirror the JAX module: `in_shape` (H, W, C); `input_crop_ratio` /
    `resize_shape` shape the network's input (grayscale inputs skip both
    and warp with zeros fill); `group_type` "rotation" or
    "roto-reflection"; `warp_mode` "exact" (K7) or "fast" (K5 + K6);
    `compute_dtype` for the network and the warp (None keeps the input's);
    `output_dtype` None casts the output back to the input dtype, "compute"
    keeps `compute_dtype`.
    """

    def __init__(self, canonicalization_network: nn.Module,
                 in_shape: Tuple[int, int, int], input_crop_ratio: float = 1.0,
                 resize_shape: Optional[int] = None,
                 group_type: str = "rotation", warp_mode: str = "exact",
                 compute_dtype: Optional[torch.dtype] = None,
                 output_dtype: Optional[str] = None):
        super().__init__()
        if warp_mode not in ("exact", "fast"):
            raise ValueError(f"warp_mode must be exact or fast, got {warp_mode}")
        self.canonicalization_network = canonicalization_network
        self.in_shape = tuple(in_shape)
        self.input_crop_ratio = input_crop_ratio
        self.resize_shape = resize_shape
        self.group_type = group_type
        self.warp_mode = warp_mode
        self.compute_dtype = compute_dtype
        self.output_dtype = output_dtype

    @property
    def is_grayscale(self) -> bool:
        return self.in_shape[-1] == 1

    @property
    def padding_mode(self) -> str:
        return "zeros" if self.is_grayscale else "border"

    def transformations_before_canonicalization_network_forward(
        self, x: Tensor
    ) -> Tensor:
        """Centre-crop by input_crop_ratio, then resize (NHWC)."""
        return crop_and_resize(x, self.in_shape, self.input_crop_ratio,
                               self.resize_shape)

    def get_group_from_out_vectors(
        self, out_vectors: Tensor
    ) -> Tuple[ContinuousGroupElement, Tensor]:
        """(B, k, 2) network vectors -> (element, matrix rep). Rotation: the
        first vector normalized with its 90-degree companion.
        Roto-reflection: a Gram-Schmidt 2-frame; det -1 marks a reflection,
        removed from the rotation by flipping the second column."""
        if self.group_type == "roto-reflection":
            frames = gram_schmidt_2d(out_vectors[:, :2])
            det = det_2x2(frames)
            reflect = (1.0 - det) / 2.0
            # fp32 multipliers, as the JAX package's weakly typed constants
            col_flip = torch.stack(
                [torch.ones(det.shape, device=det.device),
                 1.0 - 2.0 * (det < 0).float()], dim=-1)
            rotation = frames * col_flip[:, None, :]
            return ContinuousGroupElement(rotation=rotation, reflection=reflect), frames
        rotation = rotmat_2d_from_vector(out_vectors[:, 0])
        return ContinuousGroupElement(rotation=rotation, reflection=None), rotation

    def get_groupelement(
        self, x: Tensor
    ) -> Tuple[ContinuousGroupElement, Tensor, Dict[str, Tensor]]:
        """Subclass hook: (element, matrix rep, extras)."""
        raise NotImplementedError

    def _warp(self, x: Tensor, R: Tensor, padding_mode: str) -> Tensor:
        if self.warp_mode == "fast":
            return warp_rotate_center_fast(x, R, padding_mode)
        return warp_rotate_center_exact(x, R, padding_mode)

    def canonicalize(self, x: Tensor, targets: Optional[Any] = None, *,
                     training: bool = False, **kwargs: Any):
        """Map an NHWC batch to canonical pose: `(x_canon, info)`, or
        `(x_canon, targets, info)` with targets passed through."""
        if training or self.training:
            raise NotImplementedError(_TRAINING)
        in_dtype = x.dtype
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        element, matrix_rep, extras = self.get_groupelement(x)
        R_inv = _transpose_trick(element.rotation)
        if element.reflection is not None:
            r = element.reflection[:, None, None, None].to(x.dtype)
            x = (1.0 - r) * x + r * hflip(x)
        x = self._warp(x, R_inv, self.padding_mode)
        if self.output_dtype != "compute":
            x = x.to(in_dtype)
        info = ContinuousCanonicalizationInfo(
            matrix_rep=matrix_rep, element=element, extras=extras
        )
        if targets is not None:
            return x, targets, info
        return x, info

    def invert_canonicalization(
        self, info: ContinuousCanonicalizationInfo, x_canonicalized_out: Tensor,
        induced_rep_type: str = "vector", training: bool = False,
        **kwargs: Any,
    ) -> Tensor:
        """Apply the stored element to canonical-frame NHWC outputs: for a
        "scalar" rep, warp by the rotation (zeros fill), then blend the
        reflection, the inverse of canonicalize's reflect-then-warp."""
        if training:
            raise NotImplementedError(_TRAINING)
        if induced_rep_type == "vector":
            raise NotImplementedError(
                "Action for vector representation is not implemented "
                "(matches the reference)"
            )
        if induced_rep_type != "scalar":
            raise ValueError(
                "induced_rep_type must be scalar or vector for continuous groups"
            )
        y = self._warp(x_canonicalized_out, info.element.rotation, "zeros")
        if info.element.reflection is not None:
            r = info.element.reflection[:, None, None, None]
            y = (1.0 - r) * y + r * hflip(y)
        return y


class SteerableImageCanonicalization(ContinuousGroupImageCanonicalization):
    """Vectors from an SO(2)-steerable network: (B, k, 2)."""

    def get_groupelement(self, x: Tensor):
        x = self.transformations_before_canonicalization_network_forward(x)
        out_vectors = self.canonicalization_network(x)
        element, matrix_rep = self.get_group_from_out_vectors(out_vectors)
        return element, matrix_rep, {}
