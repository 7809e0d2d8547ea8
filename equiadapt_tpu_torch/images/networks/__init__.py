"""Group-equivariant and steerable canonicalization networks and their layers."""

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
from equiadapt_tpu_torch.images.networks.steerable import (
    NormBatchNorm,
    NormNonlinearity,
    SteerableConv,
    SteerableNetwork,
)

__all__ = [
    "EquivariantNetwork",
    "FiberBatchNorm",
    "fiber_mean_activations",
    "RotationEquivariantConv",
    "RotationEquivariantConvLift",
    "RotoReflectionEquivariantConv",
    "RotoReflectionEquivariantConvLift",
    "NormBatchNorm",
    "NormNonlinearity",
    "SteerableConv",
    "SteerableNetwork",
]
