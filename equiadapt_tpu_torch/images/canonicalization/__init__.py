"""Discrete- and continuous-group image canonicalizers."""

from equiadapt_tpu_torch.images.canonicalization.continuous_group import (
    ContinuousGroupImageCanonicalization,
    OptimizedSteerableImageCanonicalization,
    SteerableImageCanonicalization,
    steerable_optimization_loss,
)
from equiadapt_tpu_torch.images.canonicalization.discrete_group import (
    DiscreteGroupImageCanonicalization,
    GroupEquivariantImageCanonicalization,
    OptimizedGroupEquivariantImageCanonicalization,
    optimization_specific_loss,
)

__all__ = [
    "ContinuousGroupImageCanonicalization",
    "SteerableImageCanonicalization",
    "OptimizedSteerableImageCanonicalization",
    "steerable_optimization_loss",
    "DiscreteGroupImageCanonicalization",
    "GroupEquivariantImageCanonicalization",
    "OptimizedGroupEquivariantImageCanonicalization",
    "optimization_specific_loss",
]
