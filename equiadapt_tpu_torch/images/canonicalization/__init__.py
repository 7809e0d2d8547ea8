"""Discrete-group image canonicalizers."""

from equiadapt_tpu_torch.images.canonicalization.discrete_group import (
    DiscreteGroupImageCanonicalization,
    GroupEquivariantImageCanonicalization,
)

__all__ = [
    "DiscreteGroupImageCanonicalization",
    "GroupEquivariantImageCanonicalization",
]
