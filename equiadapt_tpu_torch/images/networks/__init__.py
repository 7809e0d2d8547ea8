"""Group-equivariant energy networks and their layers."""

from equiadapt_tpu_torch.images.networks.equivariant import (
    EquivariantNetwork,
    FiberBatchNorm,
    fiber_mean_activations,
)
from equiadapt_tpu_torch.images.networks.group_conv import (
    RotationEquivariantConv,
    RotationEquivariantConvLift,
    RotoReflectionEquivariantConv,
    RotoReflectionEquivariantConvLift,
)

__all__ = [
    "EquivariantNetwork",
    "FiberBatchNorm",
    "fiber_mean_activations",
    "RotationEquivariantConv",
    "RotationEquivariantConvLift",
    "RotoReflectionEquivariantConv",
    "RotoReflectionEquivariantConvLift",
]
