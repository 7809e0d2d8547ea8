"""Image canonicalizers and their energy networks."""

from equiadapt_tpu_torch.images.canonicalization import (
    DiscreteGroupImageCanonicalization,
    GroupEquivariantImageCanonicalization,
)
from equiadapt_tpu_torch.images.networks import EquivariantNetwork

__all__ = [
    "DiscreteGroupImageCanonicalization",
    "GroupEquivariantImageCanonicalization",
    "EquivariantNetwork",
]
