"""Image canonicalizers and their canonicalization networks."""

from equiadapt_tpu_torch.images.canonicalization import (
    ContinuousGroupImageCanonicalization,
    DiscreteGroupImageCanonicalization,
    GroupEquivariantImageCanonicalization,
    SteerableImageCanonicalization,
)
from equiadapt_tpu_torch.images.networks import EquivariantNetwork, SteerableNetwork

__all__ = [
    "ContinuousGroupImageCanonicalization",
    "DiscreteGroupImageCanonicalization",
    "GroupEquivariantImageCanonicalization",
    "SteerableImageCanonicalization",
    "EquivariantNetwork",
    "SteerableNetwork",
]
