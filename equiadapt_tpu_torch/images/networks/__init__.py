"""Group-equivariant, steerable and plain (vector-output) canonicalization
networks and their layers."""

from equiadapt_tpu_torch.images.networks.conv import (
    ConvNetwork,
    ResNet18Network,
    WideResNet50Network,
    WideResNet101Network,
)
from equiadapt_tpu_torch.images.networks.equivariant import (
    CustomEquivariantNetwork,
    EquivariantNetwork,
    EquivariantWideResNet,
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
    "ConvNetwork",
    "ResNet18Network",
    "WideResNet50Network",
    "WideResNet101Network",
    "CustomEquivariantNetwork",
    "EquivariantNetwork",
    "EquivariantWideResNet",
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
