"""Canonicalization infos: dataclasses of tensors.

Counterpart of `equiadapt_tpu/common/info.py`. Every `canonicalize`
returns its info, and `invert_canonicalization`,
`prior_regularization_loss` and `identity_metric` read it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Union

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

__all__ = [
    "DiscreteGroupElement",
    "DiscreteCanonicalizationInfo",
    "ContinuousGroupElement",
    "ContinuousCanonicalizationInfo",
    "IdentityCanonicalizationInfo",
    "CanonicalizationInfo",
    "prior_regularization_loss",
    "identity_metric",
]


@dataclass
class DiscreteGroupElement:
    """Selected element of C_n or D_n.

    rotation_deg: (B,) angle in degrees.
    reflection: (B,) indicator in [0, 1]; None for rotation groups.
    """

    rotation_deg: Tensor
    reflection: Optional[Tensor] = None


@dataclass
class DiscreteCanonicalizationInfo:
    """Everything one discrete canonicalize produces.

    group_activations: (B, |G|) raw activations (prior loss, identity metric).
    onehot: (B, |G|) selection one-hot.
    element: the selected element.
    extras: auxiliary tensors of variant-specific losses.
    """

    group_activations: Tensor
    onehot: Tensor
    element: DiscreteGroupElement
    num_rotations: int = 4
    group_type: str = "rotation"
    extras: Dict[str, Any] = field(default_factory=dict)

    @property
    def num_group(self) -> int:
        return self.num_rotations * (2 if self.group_type == "roto-reflection" else 1)


@dataclass
class ContinuousGroupElement:
    """Selected element of a continuous group (SO(2), O(2), SO(3), SE(3)).

    rotation: (B, d, d) rotation matrices.
    reflection: (B,) indicator in [0, 1]; None outside O(2).
    translation: (B, d); None outside SE(n) / E(n).
    """

    rotation: Tensor
    reflection: Optional[Tensor] = None
    translation: Optional[Tensor] = None


@dataclass
class ContinuousCanonicalizationInfo:
    """Everything one continuous canonicalize produces.

    matrix_rep: (B, d, d) matrix of the element (prior loss, identity
        metric).
    element: the element applied.
    extras: auxiliary tensors of variant-specific losses.
    """

    matrix_rep: Tensor
    element: ContinuousGroupElement
    extras: Dict[str, Any] = field(default_factory=dict)


@dataclass
class IdentityCanonicalizationInfo:
    """No-op canonicalization."""


# the union of the three concrete infos
CanonicalizationInfo = Union[DiscreteCanonicalizationInfo,
                             ContinuousCanonicalizationInfo,
                             IdentityCanonicalizationInfo]


def _mse_to_identity(matrix_rep: Tensor) -> Tensor:
    eye = torch.eye(matrix_rep.shape[-1], dtype=matrix_rep.dtype,
                    device=matrix_rep.device)
    return torch.mean((matrix_rep - eye) ** 2)


def prior_regularization_loss(info) -> Tensor:
    """Cross-entropy of the raw activations against the identity element
    (class 0) for a discrete info; MSE of the matrix rep against the
    identity matrix for a continuous one; 0 for the identity."""
    if isinstance(info, IdentityCanonicalizationInfo):
        return torch.tensor(0.0)
    if isinstance(info, DiscreteCanonicalizationInfo):
        logp = F.log_softmax(info.group_activations, dim=-1)
        return -torch.mean(logp[..., 0])
    if isinstance(info, ContinuousCanonicalizationInfo):
        return _mse_to_identity(info.matrix_rep)
    raise TypeError(f"Unknown canonicalization info: {type(info)}")


def identity_metric(info) -> Tensor:
    """Fraction of the batch whose argmax is the identity element
    (discrete); 1 - MSE of the matrix rep against the identity matrix
    (continuous); 1 for the identity."""
    if isinstance(info, IdentityCanonicalizationInfo):
        return torch.tensor(1.0)
    if isinstance(info, DiscreteCanonicalizationInfo):
        return torch.mean(
            (torch.argmax(info.group_activations, dim=-1) == 0).float()
        )
    if isinstance(info, ContinuousCanonicalizationInfo):
        return 1.0 - _mse_to_identity(info.matrix_rep)
    raise TypeError(f"Unknown canonicalization info: {type(info)}")
