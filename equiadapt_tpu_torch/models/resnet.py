"""ResNet family (ResNet-18/50, Wide-ResNet-50/101) in plain torch.nn.

Counterpart of `equiadapt_tpu/models/resnet.py`: torchvision architecture
(BasicBlock / Bottleneck, stride-2 downsampling, BN + ReLU), NHWC input
like the JAX module, NCHW inside. Submodules carry the names Flax gives
their counterparts (`Conv_0`, `BatchNorm_0`, `Bottleneck_7`, `Dense_0`), so
`utils.jax_weights.load_flax_variables` carries weights across by path.

Flax's BatchNorm momentum 0.99 is torch's 0.01. `dtype` sets the
parameters' and the computation's dtype (for example torch.bfloat16).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor

__all__ = ["ResNet", "BasicBlock", "Bottleneck", "ResNet18", "ResNet50",
           "WideResNet50", "WideResNet101"]


def _bn(ch: int, device) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(ch, eps=1e-5, momentum=0.01, device=device)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, filters: int, stride: int = 1, device="cuda"):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_ch, filters, 3, stride, 1, bias=False,
                                device=device)
        self.BatchNorm_0 = _bn(filters, device)
        self.Conv_1 = nn.Conv2d(filters, filters, 3, 1, 1, bias=False,
                                device=device)
        self.BatchNorm_1 = _bn(filters, device)
        self.project = stride != 1 or in_ch != filters
        if self.project:
            self.Conv_2 = nn.Conv2d(in_ch, filters, 1, stride, bias=False,
                                    device=device)
            self.BatchNorm_2 = _bn(filters, device)

    def forward(self, x: Tensor) -> Tensor:
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = self.BatchNorm_2(self.Conv_2(x)) if self.project else x
        return torch.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, filters: int, stride: int = 1,
                 width_mult: int = 1, device="cuda"):
        super().__init__()
        width = filters * width_mult
        out_ch = filters * 4
        self.Conv_0 = nn.Conv2d(in_ch, width, 1, bias=False, device=device)
        self.BatchNorm_0 = _bn(width, device)
        self.Conv_1 = nn.Conv2d(width, width, 3, stride, 1, bias=False,
                                device=device)
        self.BatchNorm_1 = _bn(width, device)
        self.Conv_2 = nn.Conv2d(width, out_ch, 1, bias=False, device=device)
        self.BatchNorm_2 = _bn(out_ch, device)
        self.project = stride != 1 or in_ch != out_ch
        if self.project:
            self.Conv_3 = nn.Conv2d(in_ch, out_ch, 1, stride, bias=False,
                                    device=device)
            self.BatchNorm_3 = _bn(out_ch, device)

    def forward(self, x: Tensor) -> Tensor:
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = torch.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = self.BatchNorm_3(self.Conv_3(x)) if self.project else x
        return torch.relu(y + residual)


class ResNet(nn.Module):
    """torchvision-layout ResNet on NHWC images.

    Args:
        stage_sizes: blocks per stage.
        block: BasicBlock or Bottleneck (a partial with width_mult for wide).
        num_classes: head size; None returns the pooled features.
        small_images: CIFAR stem (3x3 conv, no max pool).
        return_stages: return the four stage maps (NCHW) instead.
        dtype: parameter and computation dtype.
    """

    def __init__(self, stage_sizes: Sequence[int], block, num_classes:
                 Optional[int] = 1000, small_images: bool = False,
                 return_stages: bool = False, dtype: torch.dtype = torch.float32,
                 device="cuda"):
        super().__init__()
        self.small_images = small_images
        self.return_stages = return_stages
        self.dtype = dtype
        if small_images:
            self.Conv_0 = nn.Conv2d(3, 64, 3, 1, 1, bias=False, device=device)
        else:
            self.Conv_0 = nn.Conv2d(3, 64, 7, 2, 3, bias=False, device=device)
        self.BatchNorm_0 = _bn(64, device)
        base = block.func if isinstance(block, partial) else block
        self._stages = []
        in_ch, filters, b = 64, 64, 0
        for i, n_blocks in enumerate(stage_sizes):
            names = []
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                name = f"{base.__name__}_{b}"
                self.add_module(name, block(in_ch, filters, stride, device=device))
                names.append(name)
                in_ch = filters * base.expansion
                b += 1
            self._stages.append(names)
            filters *= 2
        self.Dense_0 = (
            nn.Linear(in_ch, num_classes, device=device)
            if num_classes is not None else None
        )
        self.to(dtype)

    def forward(self, x: Tensor):
        x = self.BatchNorm_0(self.Conv_0(x.permute(0, 3, 1, 2).to(self.dtype)))
        x = torch.relu(x)
        if not self.small_images:
            x = F.max_pool2d(x, 3, 2, 1)
        stages = []
        for names in self._stages:
            for name in names:
                x = getattr(self, name)(x)
            stages.append(x)
        if self.return_stages:
            return tuple(stages)
        x = x.mean(dim=(2, 3))
        if self.Dense_0 is not None:
            x = self.Dense_0(x)
        return x


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block=Bottleneck)
WideResNet50 = partial(
    ResNet, stage_sizes=[3, 4, 6, 3], block=partial(Bottleneck, width_mult=2)
)
WideResNet101 = partial(
    ResNet, stage_sizes=[3, 4, 23, 3], block=partial(Bottleneck, width_mult=2)
)
