"""Image canonicalizers and their canonicalization networks."""

from equiadapt_tpu_torch.images.canonicalization import (
    ContinuousGroupImageCanonicalization,
    DiscreteGroupImageCanonicalization,
    GroupEquivariantImageCanonicalization,
    OptimizedGroupEquivariantImageCanonicalization,
    OptimizedSteerableImageCanonicalization,
    SteerableImageCanonicalization,
    optimization_specific_loss,
    steerable_optimization_loss,
)
from equiadapt_tpu_torch.images.networks import (
    ConvNetwork,
    CustomEquivariantNetwork,
    EquivariantNetwork,
    EquivariantWideResNet,
    ResNet18Network,
    RotationEquivariantConv,
    RotationEquivariantConvLift,
    RotoReflectionEquivariantConv,
    RotoReflectionEquivariantConvLift,
    SteerableNetwork,
    WideResNet50Network,
    WideResNet101Network,
)

__all__ = [
    "ContinuousGroupImageCanonicalization",
    "DiscreteGroupImageCanonicalization",
    "GroupEquivariantImageCanonicalization",
    "OptimizedGroupEquivariantImageCanonicalization",
    "SteerableImageCanonicalization",
    "OptimizedSteerableImageCanonicalization",
    "optimization_specific_loss",
    "steerable_optimization_loss",
    "ConvNetwork",
    "CustomEquivariantNetwork",
    "EquivariantNetwork",
    "EquivariantWideResNet",
    "ResNet18Network",
    "RotationEquivariantConv",
    "RotationEquivariantConvLift",
    "RotoReflectionEquivariantConv",
    "RotoReflectionEquivariantConvLift",
    "SteerableNetwork",
    "WideResNet50Network",
    "WideResNet101Network",
]
