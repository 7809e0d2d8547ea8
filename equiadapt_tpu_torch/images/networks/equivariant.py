"""Discrete-group equivariant energy network.

Counterpart of `equiadapt_tpu/images/networks/equivariant.py`:
`EquivariantNetwork` (lift -> [fiber BatchNorm -> ReLU -> Dropout ->
group conv] x (L-2) -> group conv -> mean over (C, H, W)) with the
`pool_after_lift` and `fused_pool_lift` serving options. Takes NHWC like the
JAX module and runs NCHW inside. Submodules carry the names Flax gives
their counterparts, so `utils.jax_weights.load_flax_variables` carries
weights across by path. `training` is an argument, as in Flax: in training
the fiber BatchNorms use batch statistics and update their running ones
(`common.layers.BatchNorm`), and Dropout draws its masks from the
`generator` given.

`CustomEquivariantNetwork` and `EquivariantWideResNet` are not ported yet.
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

__all__ = ["FiberBatchNorm", "EquivariantNetwork", "fiber_mean_activations"]


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
        add(f"{gconv.__name__}_{num_layers - 2}", gconv(co, co, **common), "conv")

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
