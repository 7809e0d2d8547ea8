"""Prediction networks."""

from equiadapt_tpu_torch.models.resnet import (
    BasicBlock,
    Bottleneck,
    ResNet,
    ResNet18,
    ResNet50,
    WideResNet50,
    WideResNet101,
)

__all__ = ["BasicBlock", "Bottleneck", "ResNet", "ResNet18", "ResNet50",
           "WideResNet50", "WideResNet101"]
