"""ResNet family (ResNet-18/50, Wide-ResNet-50/101) in plain torch.nn.

Counterpart of `equiadapt_tpu/models/resnet.py`: torchvision architecture
(BasicBlock / Bottleneck, stride-2 downsampling, BN + ReLU), NHWC input
like the JAX module, NCHW inside. Submodules carry the names Flax gives
their counterparts (`Conv_0`, `BatchNorm_0`, `Bottleneck_7`, `Dense_0`), so
`utils.jax_weights.load_flax_variables` carries weights across by path.

`dtype` is the computation's dtype. Parameters are fp32, as Flax's
default `param_dtype`: under dtype=bfloat16 the convolutions and the head
cast their weights to bf16 on every call, and the BatchNorms keep fp32
parameters and statistics with bf16 activations (`common.layers.BatchNorm`,
Flax's momentum 0.99, the running variance updated with the biased batch
variance). `training` is an argument of `forward`, as in Flax; the module
mode is not read. `input_layout` names the memory layout the network runs
fastest on, which `pipelines.classification` hands it.

Each BatchNorm's ReLU, with the residual add before it at a block's end,
is one launch of `ops.kernels.bn_act` (the BatchNorm, the projection's
BatchNorm, the add and the ReLU in one pass) when `bn_act.takes` the call:
eval with grad mode off, on the card, channels-last bf16 or fp32 (serving).
Every other call composes the modules; both compute one function.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from equiadapt_tpu_torch.common.layers import BatchNorm, CastConv2d, CastLinear
from equiadapt_tpu_torch.ops.kernels import bn_act

Tensor = torch.Tensor

__all__ = ["ResNet", "BasicBlock", "Bottleneck", "ResNet18", "ResNet50",
           "WideResNet50", "WideResNet101"]


def _bn(ch: int, device) -> BatchNorm:
    return BatchNorm(ch, momentum=0.99, epsilon=1e-5, device=device)


def _bn_relu(bn: BatchNorm, y: Tensor, training: bool, residual: Optional[Tensor] = None,
             residual_bn: Optional[BatchNorm] = None) -> Tensor:
    """relu(bn(y) [+ residual] [+ residual_bn(residual)]): one `bn_act`
    launch when `bn_act.takes` the call, else the modules composed."""
    if bn_act.takes(y, training, residual):
        return bn_act.bn_act(y, bn, residual, residual_bn)
    y = bn(y, training)
    if residual is not None:
        y = y + (residual if residual_bn is None else residual_bn(residual, training))
    return torch.relu(y)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, filters: int, stride: int = 1, device="cuda"):
        super().__init__()
        self.Conv_0 = CastConv2d(in_ch, filters, 3, stride, 1, bias=False,
                                device=device)
        self.BatchNorm_0 = _bn(filters, device)
        self.Conv_1 = CastConv2d(filters, filters, 3, 1, 1, bias=False,
                                device=device)
        self.BatchNorm_1 = _bn(filters, device)
        self.project = stride != 1 or in_ch != filters
        if self.project:
            self.Conv_2 = CastConv2d(in_ch, filters, 1, stride, bias=False,
                                    device=device)
            self.BatchNorm_2 = _bn(filters, device)

    def forward(self, x: Tensor, training: bool = False) -> Tensor:
        t = training
        y = _bn_relu(self.BatchNorm_0, self.Conv_0(x), t)
        y = self.Conv_1(y)
        if self.project:
            return _bn_relu(self.BatchNorm_1, y, t, self.Conv_2(x), self.BatchNorm_2)
        return _bn_relu(self.BatchNorm_1, y, t, x)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, filters: int, stride: int = 1,
                 width_mult: int = 1, device="cuda"):
        super().__init__()
        width = filters * width_mult
        out_ch = filters * 4
        self.Conv_0 = CastConv2d(in_ch, width, 1, bias=False, device=device)
        self.BatchNorm_0 = _bn(width, device)
        self.Conv_1 = CastConv2d(width, width, 3, stride, 1, bias=False,
                                device=device)
        self.BatchNorm_1 = _bn(width, device)
        self.Conv_2 = CastConv2d(width, out_ch, 1, bias=False, device=device)
        self.BatchNorm_2 = _bn(out_ch, device)
        self.project = stride != 1 or in_ch != out_ch
        if self.project:
            self.Conv_3 = CastConv2d(in_ch, out_ch, 1, stride, bias=False,
                                    device=device)
            self.BatchNorm_3 = _bn(out_ch, device)

    def forward(self, x: Tensor, training: bool = False) -> Tensor:
        t = training
        y = _bn_relu(self.BatchNorm_0, self.Conv_0(x), t)
        y = _bn_relu(self.BatchNorm_1, self.Conv_1(y), t)
        y = self.Conv_2(y)
        if self.project:
            return _bn_relu(self.BatchNorm_2, y, t, self.Conv_3(x), self.BatchNorm_3)
        return _bn_relu(self.BatchNorm_2, y, t, x)


class ResNet(nn.Module):
    """torchvision-layout ResNet on NHWC images.

    Args:
        stage_sizes: blocks per stage.
        block: BasicBlock or Bottleneck (a partial with width_mult for wide).
        num_classes: head size; None returns the pooled features.
        small_images: CIFAR stem (3x3 conv, no max pool).
        return_stages: return the four stage maps (NCHW) instead.
        dtype: computation dtype (parameters stay fp32).
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
            self.Conv_0 = CastConv2d(3, 64, 3, 1, 1, bias=False, device=device)
        else:
            self.Conv_0 = CastConv2d(3, 64, 7, 2, 3, bias=False, device=device)
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
            CastLinear(in_ch, num_classes, device=device)
            if num_classes is not None else None
        )

    @property
    def input_layout(self) -> str:
        """The memory of the NHWC input the convolutions run fastest on:
        "nchw" in fp32, "nhwc" (channels-last) in reduced precision, as
        ResNet-50 measures at batch 256, 224 px on an H100 (PERF.md
        section 5: 71-72 ms on NCHW against 86 on NHWC in fp32, 20 on NHWC
        against 28 on NCHW in bf16)."""
        return "nchw" if self.dtype == torch.float32 else "nhwc"

    def forward(self, x: Tensor, training: bool = False):
        """NHWC images (any strides: an NHWC-contiguous batch runs the
        convolutions channels-last) -> logits, or the pooled features."""
        x = self.Conv_0(x.permute(0, 3, 1, 2).to(self.dtype))
        x = _bn_relu(self.BatchNorm_0, x, training)
        if not self.small_images:
            x = F.max_pool2d(x, 3, 2, 1)
        stages = []
        for names in self._stages:
            for name in names:
                x = getattr(self, name)(x, training)
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
