"""SO(3) / SE(3) point-cloud canonicalization by vector-neuron frame
estimation.

Counterpart of `equiadapt_tpu/pointcloud/canonicalization.py`. Points are
(B, N, 3) rows; the network gives three equivariant vectors per cloud,
Gram-Schmidt makes them the rows of R, and x_canon = (x - t) @ R^T: each
point in the estimated frame. Rotation only by default (SO(3));
`enable_translation=True` removes the centroid t first (SE(3)). Reflections
are not handled: VNSmall's cross-product features flip sign under them.
`training` (train-mode BatchNorm, dropout) and the dropout `generator` go
to the network; the prior loss reads the info
(`common.info.prior_regularization_loss`).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import nn

from equiadapt_tpu_torch.common.base import BaseCanonicalization
from equiadapt_tpu_torch.common.info import (
    ContinuousCanonicalizationInfo,
    ContinuousGroupElement,
)
from equiadapt_tpu_torch.common.math import gram_schmidt

Tensor = torch.Tensor

__all__ = [
    "ContinuousGroupPointcloudCanonicalization",
    "EquivariantPointcloudCanonicalization",
]

class ContinuousGroupPointcloudCanonicalization(BaseCanonicalization):
    """Base continuous point-cloud canonicalizer."""

    def __init__(self, canonicalization_network: nn.Module,
                 enable_translation: bool = False):
        super().__init__()
        self.canonicalization_network = canonicalization_network
        self.enable_translation = enable_translation

    def get_groupelement(self, x: Tensor, training: bool = False,
                         generator: Optional[torch.Generator] = None,
                         ) -> Tuple[ContinuousGroupElement, Tensor]:
        """Subclass hook: (element, matrix rep)."""
        raise NotImplementedError

    def canonicalize(self, x: Tensor, targets: Optional[Any] = None, *,
                     training: bool = False,
                     generator: Optional[torch.Generator] = None, **kwargs: Any):
        """(B, N, 3) clouds -> `(x_canon, info)`, or `(x_canon, targets,
        info)` with targets passed through; x_canon = (x - t) @ R^T."""
        element, matrix_rep = self.get_groupelement(x, training, generator)
        if self.enable_translation:
            x = x - element.translation[:, None, :]
        x_canon = torch.einsum("bnd,bkd->bnk", x, element.rotation)
        info = ContinuousCanonicalizationInfo(matrix_rep=matrix_rep, element=element)
        if targets is not None:
            return x_canon, targets, info
        return x_canon, info

    def invert_canonicalization(self, info: ContinuousCanonicalizationInfo,
                                x_canonicalized_out: Tensor,
                                **kwargs: Any) -> Tensor:
        """Map canonical-frame outputs back: y @ R, plus t in SE(3) mode for
        point-valued outputs. Pass `points=False` for directions (normals,
        offsets), which rotate and do not translate."""
        out = torch.einsum("bnk,bkd->bnd", x_canonicalized_out,
                           info.element.rotation)
        if self.enable_translation and kwargs.get("points", True):
            out = out + info.element.translation[:, None, :]
        return out


class EquivariantPointcloudCanonicalization(ContinuousGroupPointcloudCanonicalization):
    """Frame from a VN network (for example VNSmall) and Gram-Schmidt."""

    def get_groupelement(self, x: Tensor, training: bool = False,
                         generator: Optional[torch.Generator] = None):
        translation = None
        if self.enable_translation:
            # the centroid: the network then sees a centred cloud, so the
            # rotation estimate does not depend on the translation
            translation = torch.mean(x, dim=1)  # (B, 3)
            x = x - translation[:, None, :]
        rotation = gram_schmidt(self.canonicalization_network(
            x, training=training, generator=generator))
        element = ContinuousGroupElement(rotation=rotation, translation=translation)
        return element, rotation
