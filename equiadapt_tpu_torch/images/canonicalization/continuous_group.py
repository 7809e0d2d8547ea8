"""Continuous-group (SO(2) / O(2)) image canonicalizers.

Counterpart of `equiadapt_tpu/images/canonicalization/continuous_group.py`
(`ContinuousGroupImageCanonicalization`, `SteerableImageCanonicalization`,
`OptimizedSteerableImageCanonicalization`, `steerable_optimization_loss`).
NHWC in and out. The network emits 2-D vectors; a rotation (or
roto-reflection) matrix is built from them, and the image is warped into
canonical pose by the matrix inverse (the transpose trick: negating the
off-diagonals inverts a rotation). The reference's edge-pad -> warp -> crop
sandwich is one border-sampled warp about (H//2, W//2) of the unpadded
image.

`training` is an argument, as in the JAX package; the module mode is not
read. The warp routes by `training` and `warp_mode`, the JAX package's own
routes, the same on the CPU and the card:
* eval, "exact": kernel K7 (`warp_rotate_center_exact`; its plain version
  `_warp_center_affine` beside it in `ops/kernels/bilinear_warp.py`);
* eval, "fast": K5 (centred quarter turn) then K6 (three-shear residual),
  `warp_rotate_center_fast`;
* training, "exact": `_warp_center_affine` itself, K7's plain version, a
  bilinear sample that autograd differentiates through the sample
  coordinates (the JAX `_exact_warp` sends training there on every
  backend; K7 stays eval only);
* training, "fast": `ops.warp.warp_center_rotation_fast_diff`, K5 then K6
  forward and the JAX package's closed-form backward (the image's
  cotangent is K5 then K6 again, on the output cotangent).
Each kernel wrapper takes its kernel for CUDA tensors and its plain version
for CPU tensors; the JAX package's `_exact_warp` dispatch (kernel options,
tiling gate) has no counterpart.

`invert_canonicalization` warps "scalar" outputs by the forward element
with zeros fill, then blends the reflection; "vector" raises, as in the JAX
package.

Spans (`utils.profiling.annotate`): `canon` around `canonicalize`, with
`canon/get_groupelement` (the cast to `compute_dtype`, `canon/prep` for the
crop and resize, the network, the element from its vectors) and
`canon/warp` (the reflection blend, the warp, the cast back) under it;
`canon/invert` around the invert.

`OptimizedSteerableImageCanonicalization` augments the batch with random
rotations (and reflections) drawn from the `generator` given to
`canonicalize`, in eval as well as in training, as the JAX module draws
from its "augment" rng.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import math

import torch
from torch import nn

from equiadapt_tpu_torch.common.base import BaseCanonicalization
from equiadapt_tpu_torch.common.info import (
    ContinuousCanonicalizationInfo,
    ContinuousGroupElement,
)
from equiadapt_tpu_torch.common.layers import sharded_draw
from equiadapt_tpu_torch.common.math import (
    det_2x2,
    gram_schmidt_2d,
    rotmat_2d_from_vector,
)
from equiadapt_tpu_torch.ops.kernels.bilinear_warp import (
    _warp_center_affine,
    warp_rotate_center_exact,
)
from equiadapt_tpu_torch.ops.kernels.shear_rotate import warp_rotate_center_fast
from equiadapt_tpu_torch.ops.warp import (
    _dst_grid,
    bilinear_sample,
    crop_and_resize,
    hflip,
    warp_center_rotation_fast_diff,
)
from equiadapt_tpu_torch.utils.profiling import annotate

Tensor = torch.Tensor

__all__ = [
    "ContinuousGroupImageCanonicalization",
    "SteerableImageCanonicalization",
    "OptimizedSteerableImageCanonicalization",
    "steerable_optimization_loss",
]


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
        with annotate("canon/prep"):
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
        self, x: Tensor, training: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[ContinuousGroupElement, Tensor, Dict[str, Tensor]]:
        """Subclass hook: (element, matrix rep, extras)."""
        raise NotImplementedError

    def _warp(self, x: Tensor, R: Tensor, padding_mode: str,
              training: bool) -> Tensor:
        """out(p) = x(R^{-1}(p - c) + c) by the route of `warp_mode` and
        `training` (module docstring)."""
        if self.warp_mode == "fast":
            if training:
                return warp_center_rotation_fast_diff(x, R, padding_mode)
            return warp_rotate_center_fast(x, R, padding_mode)
        if training:
            return _warp_center_affine(x, R, padding_mode)
        return warp_rotate_center_exact(x, R, padding_mode)

    def canonicalize(self, x: Tensor, targets: Optional[Any] = None, *,
                     training: bool = False,
                     generator: Optional[torch.Generator] = None,
                     **kwargs: Any):
        """Map an NHWC batch to canonical pose: `(x_canon, info)`, or
        `(x_canon, targets, info)` with targets passed through.
        training=True runs the network in train mode (batch statistics)
        and warps differentiably in the rotation; `generator` draws the
        optimized variant's augmentation."""
        with annotate("canon"):
            in_dtype = x.dtype
            with annotate("canon/get_groupelement"):
                if self.compute_dtype is not None:
                    x = x.to(self.compute_dtype)
                element, matrix_rep, extras = self.get_groupelement(x, training, generator)
            with annotate("canon/warp"):
                R_inv = _transpose_trick(element.rotation)
                if element.reflection is not None:
                    r = element.reflection[:, None, None, None].to(x.dtype)
                    x = (1.0 - r) * x + r * hflip(x)
                x = self._warp(x, R_inv, self.padding_mode, training)
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
        reflection, the inverse of canonicalize's reflect-then-warp;
        training=True warps differentiably (`_warp`)."""
        if induced_rep_type == "vector":
            raise NotImplementedError(
                "Action for vector representation is not implemented "
                "(matches the reference)"
            )
        if induced_rep_type != "scalar":
            raise ValueError(
                "induced_rep_type must be scalar or vector for continuous groups"
            )
        with annotate("canon/invert"):
            y = self._warp(x_canonicalized_out, info.element.rotation, "zeros",
                           training)
            if info.element.reflection is not None:
                r = info.element.reflection[:, None, None, None]
                y = (1.0 - r) * y + r * hflip(y)
            return y


class SteerableImageCanonicalization(ContinuousGroupImageCanonicalization):
    """Vectors from an SO(2)-steerable network: (B, k, 2)."""

    def get_groupelement(self, x: Tensor, training: bool = False,
                         generator: Optional[torch.Generator] = None):
        x = self.transformations_before_canonicalization_network_forward(x)
        out_vectors = self.canonicalization_network(x, training=training)
        element, matrix_rep = self.get_group_from_out_vectors(out_vectors)
        return element, matrix_rep, {}


class OptimizedSteerableImageCanonicalization(ContinuousGroupImageCanonicalization):
    """Self-supervised steerable canonicalizer: the batch is augmented with
    random rotations (and, for roto-reflection, reflections) whose matrices
    are known, the network scores [x, x_aug] in one pass (a vector network
    such as `ConvNetwork`: (2B, 2 k) -> (2B, k, 2)), and
    `steerable_optimization_loss` regresses the augmented batch's predicted
    matrices onto the known ones.

    `artifact_err_wt` is kept for the registry's signature, as in the JAX
    module, which does not read it either."""

    def __init__(self, canonicalization_network: nn.Module,
                 in_shape: Tuple[int, int, int], *,
                 artifact_err_wt: float = 0.0, **kwargs: Any):
        super().__init__(canonicalization_network, in_shape, **kwargs)
        self.artifact_err_wt = artifact_err_wt

    def _draw_augmentation(self, B: int, generator: Optional[torch.Generator]
                           ) -> Tuple[Tensor, Optional[Tensor]]:
        """(angles (B,) in [0, 2 pi), reflections (B,) of +-1 or None) drawn
        from `generator`, on its device."""
        if generator is None:
            raise ValueError(
                "the optimized steerable canonicalizer draws random "
                "rotations: pass generator= to canonicalize")
        dev = generator.device
        angles = sharded_draw(lambda s: torch.rand(s, generator=generator, device=dev),
                              (B,)) * 2.0 * math.pi
        reflect = None
        if self.group_type == "roto-reflection":
            reflect = sharded_draw(lambda s: torch.randint(
                0, 2, s, generator=generator, device=dev), (B,)).float() * 2.0 - 1.0
        return angles, reflect

    def group_augment(self, x: Tensor, generator: Optional[torch.Generator]
                      ) -> Tuple[Tensor, Tensor]:
        """Random rotation (and reflection) of each sample with its known
        matrix: (x_aug, gt), the draws from `generator`
        (`_draw_augmentation`), the sampling by `_augment_with`."""
        angles, reflect = self._draw_augmentation(x.shape[0], generator)
        return self._augment_with(x, angles, reflect)

    def _augment_with(self, x: Tensor, angles: Tensor,
                      reflect: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
        """`group_augment` for given draws: angles (B,) radians, reflect
        (B,) of +-1 (roto-reflection) or None.

        The reference pads (edge, p = ceil(W / 2)), rotates with
        `F.affine_grid` / `F.grid_sample` (align_corners=False) by theta and
        crops; here that is one sampling pass on the unpadded image,
        border-clamped (zeros for grayscale, which is not padded). The
        ground-truth matrix is theta's transpose trick, the grid_sample ->
        warp_affine convention fix of the reference."""
        B, H, W, _ = x.shape
        angles = angles.to(x.device)
        cos_a = torch.cos(angles).to(x.dtype)
        sin_a = torch.sin(angles).to(x.dtype)
        c00 = cos_a if reflect is None else cos_a * reflect.to(x.device, x.dtype)
        theta = torch.stack([torch.stack([c00, -sin_a], -1),
                             torch.stack([sin_a, cos_a], -1)], dim=-2)
        p = 0 if self.is_grayscale else math.ceil(W * 0.5)
        Hp, Wp = H + 2 * p, W + 2 * p
        dtype = torch.promote_types(x.dtype, torch.float32)
        gx, gy = _dst_grid(B, H, W, dtype, x.device)
        nx = (2.0 * (gx + p) + 1.0) / Wp - 1.0
        ny = (2.0 * (gy + p) + 1.0) / Hp - 1.0
        th = theta.to(dtype)
        sx_n = th[:, 0, 0, None, None] * nx + th[:, 0, 1, None, None] * ny
        sy_n = th[:, 1, 0, None, None] * nx + th[:, 1, 1, None, None] * ny
        src_x = ((sx_n + 1.0) * Wp - 1.0) / 2.0 - p
        src_y = ((sy_n + 1.0) * Hp - 1.0) / 2.0 - p
        x_aug = bilinear_sample(x, src_x, src_y, padding_mode=self.padding_mode)
        return x_aug, _transpose_trick(theta)

    def get_groupelement(self, x: Tensor, training: bool = False,
                         generator: Optional[torch.Generator] = None):
        """The network on [x, x_aug] in one pass: the batch's element and
        matrix rep, and the augmented batch's matrix rep beside its ground
        truth in the extras."""
        x_aug, gt = self.group_augment(x, generator)
        x_all = torch.cat([x, x_aug], dim=0)
        x_all = self.transformations_before_canonicalization_network_forward(x_all)
        out_all = self.canonicalization_network(x_all, training=training,
                                                generator=generator)
        out_all = out_all.reshape(x_all.shape[0], -1, 2)  # (2B, k, 2)
        out, out_aug = torch.chunk(out_all, 2, dim=0)
        element, matrix_rep = self.get_group_from_out_vectors(out)
        _, matrix_rep_aug = self.get_group_from_out_vectors(out_aug)
        extras = {"matrix_rep_augmented": matrix_rep_aug,
                  "matrix_rep_augmented_gt": gt}
        return element, matrix_rep, extras


def steerable_optimization_loss(info: ContinuousCanonicalizationInfo) -> Tensor:
    """MSE between the augmented batch's predicted matrix reps and the
    known augmentation matrices."""
    return torch.mean((info.extras["matrix_rep_augmented"]
                       - info.extras["matrix_rep_augmented_gt"]) ** 2)
