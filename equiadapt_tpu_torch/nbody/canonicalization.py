"""SE(3) canonicalization for n-body dynamics.

Counterpart of `equiadapt_tpu/nbody/canonicalization.py`. Dense (B, n, 3)
tensors: canonicalize projects the positions, less the predicted
translation, and the velocities into the predicted frame; the invert maps
a canonical-frame prediction back, y R + t.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from equiadapt_tpu_torch.common.base import BaseCanonicalization
from equiadapt_tpu_torch.common.info import (
    ContinuousCanonicalizationInfo,
    ContinuousGroupElement,
)
from equiadapt_tpu_torch.common.math import modified_gram_schmidt

Tensor = torch.Tensor

__all__ = ["EuclideanGroupNBody"]


class EuclideanGroupNBody(BaseCanonicalization):
    """SE(3) n-body canonicalizer around a network that returns
    (rotation_vectors (B, 3, 3), translation (B, 3)), such as VNDeepSets."""

    def __init__(self, canonicalization_network: nn.Module):
        super().__init__()
        self.canonicalization_network = canonicalization_network

    def canonicalize(self, x: Any, targets: Optional[Any] = None, *,
                     loc: Tensor = None, vel: Tensor = None,
                     charges: Optional[Tensor] = None,
                     adjacency: Optional[Tensor] = None, training: bool = False,
                     generator: Optional[torch.Generator] = None, **kwargs: Any):
        """x: unused node scalars, kept for the reference's signature;
        loc, vel: (B, n, 3); charges: (B, n, 1), needed by charge-aware
        features; `generator` draws the network's dropout masks in training.

        Returns ((canonical_loc, canonical_vel), info), with
        canonical = (loc - t) R^T and vel R^T."""
        vectors, translation = self.canonicalization_network(
            loc, vel, charges=charges, adjacency=adjacency, training=training,
            generator=generator)
        rotation = modified_gram_schmidt(vectors)  # (B, 3, 3), rows orthonormal
        element = ContinuousGroupElement(rotation=rotation, translation=translation)
        info = ContinuousCanonicalizationInfo(matrix_rep=rotation, element=element)
        centered = loc - translation[:, None, :]
        canonical_loc = torch.einsum("bnd,bkd->bnk", centered, rotation)
        canonical_vel = torch.einsum("bnd,bkd->bnk", vel, rotation)
        return (canonical_loc, canonical_vel), info

    def invert_canonicalization(self, info: ContinuousCanonicalizationInfo,
                                x_canonicalized_out: Tensor, **kwargs: Any) -> Tensor:
        """y -> y R + t."""
        R = info.element.rotation
        t = info.element.translation
        return torch.einsum("bnk,bkd->bnd", x_canonicalized_out, R) + t[:, None, :]
