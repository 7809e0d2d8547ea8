"""Discrete-group equivariant energy networks.

Counterpart of `equiadapt_tpu/images/networks/equivariant.py`:

* `EquivariantNetwork` (the `e2cnn` network type): lift -> [fiber
  BatchNorm -> ReLU -> Dropout -> group conv] x (L-2) -> group conv ->
  mean over (C, H, W), with the `pool_after_lift` and `fused_pool_lift`
  serving options;
* `CustomEquivariantNetwork` (`custom`): lift, then (L-1) x [ReLU -> 1x1
  group conv], mean over (C, H, W);
* `EquivariantWideResNet` (`equivariant_wrn`): a padded lift, residual
  blocks of group convs with pre-activation fiber BatchNorm (`_WideBlock`,
  or the 1x1 -> kxk -> 1x1 `_WideBottleneck`), fiber BatchNorm, ReLU, a
  1x1 group conv and the fiber mean.

They take NHWC like the JAX modules and run NCHW inside. Submodules carry
the names Flax gives their counterparts (a counter per class, in creation
order), so `utils.jax_weights.load_flax_variables` carries weights across
by path, and `flax_variables` back. `training` is an argument, as in Flax:
in training the fiber BatchNorms use batch statistics and update their
running ones (`common.layers.BatchNorm`), and Dropout draws its masks from
the `generator` given.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from equiadapt_tpu_torch.common.layers import BatchNorm, Dropout
from equiadapt_tpu_torch.images.networks.group_conv import (
    RotationEquivariantConv,
    RotationEquivariantConvLift,
    RotoReflectionEquivariantConv,
    RotoReflectionEquivariantConvLift,
)

Tensor = torch.Tensor

__all__ = ["FiberBatchNorm", "EquivariantNetwork", "CustomEquivariantNetwork",
           "EquivariantWideResNet", "fiber_mean_activations"]


def fiber_mean_activations(y: Tensor, num_group: int) -> Tensor:
    """(B, C*G, H, W) NCHW -> (B, G): mean over channels and space."""
    B, CG, H, W = y.shape
    return y.reshape(B, CG // num_group, num_group, H * W).mean(dim=(1, 3))


class FiberBatchNorm(nn.Module):
    """BatchNorm sharing statistics across the group fiber, per field c:
    statistics over (batch, fiber, H, W), so the norm commutes with fiber
    permutations. `momentum` is Flax's (see `common.layers.BatchNorm`).
    """

    def __init__(self, num_channels: int, num_group: int,
                 momentum: float = 0.9, epsilon: float = 1e-5, device="cuda"):
        super().__init__()
        self.num_group = num_group
        self.BatchNorm_0 = BatchNorm(num_channels, momentum, epsilon,
                                     device=device)

    def forward(self, x: Tensor, training: bool = False) -> Tensor:
        B, CG, H, W = x.shape
        G = self.num_group
        y = self.BatchNorm_0(x.reshape(B, CG // G, G * H, W), training)
        return y.reshape(B, CG, H, W)


class EquivariantNetwork(nn.Module):
    """GCNN energy network: NHWC images -> (B, |G|) group activations."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 group_type: str = "rotation", num_rotations: int = 4,
                 num_layers: int = 2, dropout_rate: float = 0.5,
                 pool_after_lift: bool = False, fused_pool_lift: bool = False,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        if pool_after_lift and fused_pool_lift:
            raise ValueError(
                "pool_after_lift and fused_pool_lift are mutually exclusive"
            )
        self.group_type = group_type
        self.num_rotations = num_rotations
        rot = group_type == "rotation"
        lift = RotationEquivariantConvLift if rot else RotoReflectionEquivariantConvLift
        gconv = RotationEquivariantConv if rot else RotoReflectionEquivariantConv
        G = self.num_group
        co = out_channels
        common = dict(kernel_size=kernel_size, num_rotations=num_rotations,
                      device=device, generator=generator)
        self._layers = []  # (name, kind), in Flax's creation order

        def add(name, module, kind):
            self.add_module(name, module)
            self._layers.append((name, kind))

        add(f"{lift.__name__}_0",
            lift(in_channels, co, fused_pool=fused_pool_lift, **common), "conv")
        add("FiberBatchNorm_0", FiberBatchNorm(co, G, device=device), "bn")
        add("Dropout_0", Dropout(dropout_rate), "drop")
        if pool_after_lift:
            self._layers.append(("", "pool"))
        for i in range(num_layers - 2):
            add(f"{gconv.__name__}_{i}", gconv(co, co, **common), "conv")
            add(f"FiberBatchNorm_{i + 1}", FiberBatchNorm(co, G, device=device), "bn")
            add(f"Dropout_{i + 1}", Dropout(dropout_rate), "drop")
        add(f"{gconv.__name__}_{max(num_layers - 2, 0)}", gconv(co, co, **common), "conv")

    @property
    def num_group(self) -> int:
        return self.num_rotations * (2 if self.group_type == "roto-reflection" else 1)

    def forward(self, x: Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """NHWC images -> (B, |G|); `generator` draws the dropout masks in
        training (on x's device)."""
        y = x.permute(0, 3, 1, 2).contiguous()
        for name, kind in self._layers:
            layer = getattr(self, name, None)
            if kind == "pool":
                y = F.avg_pool2d(y, 2, 2)
            elif kind == "conv":
                y = layer(y)
            elif kind == "bn":
                y = torch.relu(layer(y, training))
            else:
                y = layer(y, training, generator)
        return fiber_mean_activations(y, self.num_group)


def _group_layers(group_type: str):
    """(lift class, group-conv class) of `group_type`."""
    if group_type == "rotation":
        return RotationEquivariantConvLift, RotationEquivariantConv
    return RotoReflectionEquivariantConvLift, RotoReflectionEquivariantConv


def _num_group(group_type: str, num_rotations: int) -> int:
    return num_rotations * (2 if group_type == "roto-reflection" else 1)


class CustomEquivariantNetwork(nn.Module):
    """Lift, then (L-1) x [ReLU -> 1x1 group conv]: NHWC images -> (B, |G|)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 group_type: str = "rotation", num_rotations: int = 4,
                 num_layers: int = 1, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.group_type = group_type
        self.num_rotations = num_rotations
        self.num_layers = num_layers
        lift, gconv = _group_layers(group_type)
        self._lift = f"{lift.__name__}_0"
        self._gconv = gconv.__name__
        self.add_module(self._lift, lift(in_channels, out_channels, kernel_size,
                                         num_rotations=num_rotations,
                                         device=device, generator=generator))
        for i in range(num_layers - 1):
            self.add_module(f"{self._gconv}_{i}",
                            gconv(out_channels, out_channels, 1,
                                  num_rotations=num_rotations, device=device,
                                  generator=generator))

    @property
    def num_group(self) -> int:
        return _num_group(self.group_type, self.num_rotations)

    def forward(self, x: Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        y = getattr(self, self._lift)(x.permute(0, 3, 1, 2).contiguous())
        for i in range(self.num_layers - 1):
            y = getattr(self, f"{self._gconv}_{i}")(torch.relu(y))
        return fiber_mean_activations(y, self.num_group)


class _WideBlock(nn.Module):
    """Residual block: x + conv(relu(bn(conv(relu(bn(x)))))), k x k group
    convs padded to keep the size."""

    def __init__(self, channels: int, kernel_size: int, group_type: str,
                 num_rotations: int, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _, gconv = _group_layers(group_type)
        G = _num_group(group_type, num_rotations)
        self._gconv = gconv.__name__
        for i in range(2):
            self.add_module(f"FiberBatchNorm_{i}", FiberBatchNorm(channels, G,
                                                                  device=device))
            self.add_module(f"{self._gconv}_{i}", gconv(
                channels, channels, kernel_size, num_rotations=num_rotations,
                padding=kernel_size // 2, device=device, generator=generator))

    def forward(self, x: Tensor, training: bool = False) -> Tensor:
        h = x
        for i in range(2):
            h = torch.relu(getattr(self, f"FiberBatchNorm_{i}")(h, training))
            h = getattr(self, f"{self._gconv}_{i}")(h)
        return x + h


class _WideBottleneck(nn.Module):
    """Bottleneck residual block: 1x1 (C -> C/2), k x k (padded), 1x1
    (C/2 -> C) group convs, each after fiber BatchNorm and ReLU."""

    def __init__(self, channels: int, kernel_size: int, group_type: str,
                 num_rotations: int, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _, gconv = _group_layers(group_type)
        G = _num_group(group_type, num_rotations)
        self._gconv = gconv.__name__
        mid = max(channels // 2, 1)
        convs = ((channels, mid, 1, 0), (mid, mid, kernel_size, kernel_size // 2),
                 (mid, channels, 1, 0))
        for i, (ci, co, k, pad) in enumerate(convs):
            self.add_module(f"FiberBatchNorm_{i}", FiberBatchNorm(ci, G, device=device))
            self.add_module(f"{self._gconv}_{i}", gconv(
                ci, co, k, num_rotations=num_rotations, padding=pad,
                device=device, generator=generator))

    def forward(self, x: Tensor, training: bool = False) -> Tensor:
        h = x
        for i in range(3):
            h = torch.relu(getattr(self, f"FiberBatchNorm_{i}")(h, training))
            h = getattr(self, f"{self._gconv}_{i}")(h)
        return x + h


class EquivariantWideResNet(nn.Module):
    """Wide-ResNet GCNN energy network: padded lift, `num_blocks` residual
    blocks (`block_type` "basic" or "bottleneck"), fiber BatchNorm, ReLU,
    a 1x1 group conv and the fiber mean: NHWC images -> (B, |G|)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 group_type: str = "rotation", num_rotations: int = 4,
                 num_blocks: int = 2, block_type: str = "basic", device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.group_type = group_type
        self.num_rotations = num_rotations
        lift, gconv = _group_layers(group_type)
        block = _WideBlock if block_type == "basic" else _WideBottleneck
        self._lift = f"{lift.__name__}_0"
        self._head = f"{gconv.__name__}_0"
        self._blocks = [f"{block.__name__}_{i}" for i in range(num_blocks)]
        self.add_module(self._lift, lift(
            in_channels, out_channels, kernel_size, num_rotations=num_rotations,
            padding=kernel_size // 2, device=device, generator=generator))
        for name in self._blocks:
            self.add_module(name, block(out_channels, kernel_size, group_type,
                                        num_rotations, device=device,
                                        generator=generator))
        self.FiberBatchNorm_0 = FiberBatchNorm(out_channels, self.num_group,
                                               device=device)
        self.add_module(self._head, gconv(out_channels, out_channels, 1,
                                          num_rotations=num_rotations,
                                          device=device, generator=generator))

    @property
    def num_group(self) -> int:
        return _num_group(self.group_type, self.num_rotations)

    def forward(self, x: Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        y = getattr(self, self._lift)(x.permute(0, 3, 1, 2).contiguous())
        for name in self._blocks:
            y = getattr(self, name)(y, training)
        y = torch.relu(self.FiberBatchNorm_0(y, training))
        y = getattr(self, self._head)(y)
        return fiber_mean_activations(y, self.num_group)
