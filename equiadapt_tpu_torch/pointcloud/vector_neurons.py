"""Vector-neuron (VN) layers: SO(3)-equivariant point features.

Counterpart of `equiadapt_tpu/pointcloud/vector_neurons.py`. Features are
channels-last, (B, N[, k], 3, C): C 3-vectors per point, as in the JAX
package, so every channel mix is an `nn.Linear` on the last axis and every
dot product over the vector axis is a sum over dim -2. Every layer commutes
with a global right-rotation x -> x @ Q.

Torch modules need their input width at construction, so the constructors
take `in_channels` where the Flax modules infer it. Submodules carry the
Flax names (`map_to_feat`, `batchnorm`, `map_to_dir`, `BatchNorm_0`,
`vn1`, `vn2`, `vn_lin`), so `utils.jax_weights.load_flax_variables` carries
weights across by path.

`training` is an argument, as in the JAX package, and the torch module
mode is not read: in training `BatchNormLastAxis` normalizes with batch
statistics and updates its running ones (Flax's semantics,
`common.layers.BatchNorm`).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from equiadapt_tpu_torch.common.layers import BatchNorm

Tensor = torch.Tensor

EPS = 1e-6

__all__ = [
    "BatchNormLastAxis",
    "VNLinear",
    "VNBilinear",
    "VNSoftplus",
    "VNLeakyReLU",
    "VNLinearLeakyReLU",
    "VNBatchNorm",
    "VNMaxPool",
    "mean_pool",
    "VNStdFeature",
]


def _linear(in_features: int, out_features: int, device) -> nn.Linear:
    """Channel mix with no bias (a VN requirement)."""
    return nn.Linear(in_features, out_features, bias=False, device=device)


class BatchNormLastAxis(BatchNorm):
    """Flax `nn.BatchNorm` on (..., C): statistics per channel of the last
    axis, over the input flattened to (-1, C); eps 1e-5. `momentum` is
    Flax's (0.99 by default; `VNBatchNorm` takes 0.9)."""

    def __init__(self, num_features: int, momentum: float = 0.99, device="cuda"):
        super().__init__(num_features, momentum=momentum, device=device)

    def forward(self, x: Tensor, training: bool = False) -> Tensor:
        flat = x.reshape(-1, x.shape[-1])
        return super().forward(flat, training=training).reshape(x.shape)


class VNLinear(nn.Module):
    """Channel-mixing linear map."""

    def __init__(self, in_channels: int, out_channels: int, device="cuda"):
        super().__init__()
        self.map_to_feat = _linear(in_channels, out_channels, device)

    def forward(self, x: Tensor) -> Tensor:
        return self.map_to_feat(x)


class VNBilinear(nn.Module):
    """Bilinear (features x labels) map: `bilinear` (C1, C2, out)."""

    def __init__(self, in_channels: int, label_channels: int, out_channels: int,
                 device="cuda"):
        super().__init__()
        self.bilinear = nn.Parameter(torch.empty(
            in_channels, label_channels, out_channels, device=device))
        nn.init.normal_(self.bilinear, std=(in_channels * label_channels) ** -0.5)

    def forward(self, x: Tensor, labels: Tensor) -> Tensor:
        # x: (..., 3, C1); labels (..., C2) broadcast over the vector axis
        return torch.einsum("...vc,...d,cde->...ve", x, labels, self.bilinear)


def _leaky_project(p: Tensor, d: Tensor, negative_slope: float) -> Tensor:
    """Keep p where <p, d> >= 0, else remove its d-component; blend with p
    by `negative_slope`."""
    dot = torch.sum(p * d, dim=-2, keepdim=True)
    mask = (dot >= 0).to(p.dtype)
    d_norm_sq = torch.sum(d * d, dim=-2, keepdim=True)
    proj = p - (dot / (d_norm_sq + EPS)) * d
    return negative_slope * p + (1 - negative_slope) * (mask * p + (1 - mask) * proj)


class VNLeakyReLU(nn.Module):
    """Direction-gated leaky ReLU."""

    def __init__(self, in_channels: int, share_nonlinearity: bool = False,
                 negative_slope: float = 0.2, device="cuda"):
        super().__init__()
        self.negative_slope = negative_slope
        self.map_to_dir = _linear(
            in_channels, 1 if share_nonlinearity else in_channels, device)

    def forward(self, x: Tensor) -> Tensor:
        return _leaky_project(x, self.map_to_dir(x), self.negative_slope)


class VNSoftplus(nn.Module):
    """Angle-based soft nonlinearity."""

    def __init__(self, in_channels: int, share_nonlinearity: bool = False,
                 negative_slope: float = 0.0, device="cuda"):
        super().__init__()
        self.negative_slope = negative_slope
        self.map_to_dir = _linear(
            in_channels, 1 if share_nonlinearity else in_channels, device)

    def forward(self, x: Tensor) -> Tensor:
        d = self.map_to_dir(x)
        dot = torch.sum(x * d, dim=-2, keepdim=True)
        xn = torch.linalg.vector_norm(x, dim=-2, keepdim=True)
        dn = torch.linalg.vector_norm(d, dim=-2, keepdim=True)
        angle = torch.arccos(torch.clamp(dot / (xn * dn + EPS), -1.0, 1.0))
        mask = torch.cos(angle / 2.0) ** 2
        d_norm_sq = torch.sum(d * d, dim=-2, keepdim=True)
        proj = x - (dot / (d_norm_sq + EPS)) * d
        return self.negative_slope * x + (1 - self.negative_slope) * (
            mask * x + (1 - mask) * proj
        )


class VNBatchNorm(nn.Module):
    """Batch-normalized vector norms, directions kept: norm + EPS over the
    vector axis, `BatchNorm_0` (Flax `momentum`, default 0.9) over the
    channels, x / norm * norm_bn."""

    def __init__(self, num_channels: int, momentum: float = 0.9, device="cuda"):
        super().__init__()
        self.BatchNorm_0 = BatchNormLastAxis(num_channels, momentum=momentum,
                                             device=device)

    def forward(self, x: Tensor, training: bool = False) -> Tensor:
        norm = torch.linalg.vector_norm(x, dim=-2) + EPS  # (..., C)
        norm_bn = self.BatchNorm_0(norm, training=training)
        return x / norm[..., None, :] * norm_bn[..., None, :]


class VNLinearLeakyReLU(nn.Module):
    """Linear map, VN BatchNorm, then the direction-gated leaky ReLU with
    directions from the layer's input."""

    def __init__(self, in_channels: int, out_channels: int,
                 share_nonlinearity: bool = False, negative_slope: float = 0.2,
                 use_batchnorm: bool = True, device="cuda"):
        super().__init__()
        self.negative_slope = negative_slope
        self.map_to_feat = _linear(in_channels, out_channels, device)
        self.batchnorm = (VNBatchNorm(out_channels, device=device)
                          if use_batchnorm else None)
        self.map_to_dir = _linear(
            in_channels, 1 if share_nonlinearity else out_channels, device)

    def forward(self, x: Tensor, training: bool = False) -> Tensor:
        p = self.map_to_feat(x)
        if self.batchnorm is not None:
            p = self.batchnorm(p, training=training)
        return _leaky_project(p, self.map_to_dir(x), self.negative_slope)


class VNMaxPool(nn.Module):
    """Max pool over the points axis by direction-projected score:
    (B, N, 3, C) -> (B, 3, C), per channel the point whose feature has the
    largest <x, d> (the first such point on ties)."""

    def __init__(self, in_channels: int, device="cuda"):
        super().__init__()
        self.map_to_dir = _linear(in_channels, in_channels, device)

    def forward(self, x: Tensor) -> Tensor:
        dot = torch.sum(x * self.map_to_dir(x), dim=-2)  # (B, N, C)
        idx = torch.argmax(dot, dim=-2)  # (B, C)
        B, _, three, C = x.shape
        return torch.gather(x, 1, idx[:, None, None, :].expand(B, 1, three, C))[:, 0]


def mean_pool(x: Tensor, axis: int = 1, keepdims: bool = False) -> Tensor:
    """Mean over the points axis."""
    return torch.mean(x, dim=axis, keepdim=keepdims)


class VNStdFeature(nn.Module):
    """Invariant features from a learned frame: returns (x_std, frame),
    x_std[..., k, c] = <frame[..., k, :], x[..., :, c]>."""

    def __init__(self, in_channels: int, normalize_frame: bool = False,
                 share_nonlinearity: bool = False, negative_slope: float = 0.2,
                 device="cuda"):
        super().__init__()
        self.normalize_frame = normalize_frame
        C = in_channels
        common = dict(share_nonlinearity=share_nonlinearity,
                      negative_slope=negative_slope, device=device)
        self.vn1 = VNLinearLeakyReLU(C, C // 2, **common)
        self.vn2 = VNLinearLeakyReLU(C // 2, C // 4, **common)
        self.vn_lin = _linear(C // 4, 2 if normalize_frame else 3, device)

    def forward(self, x: Tensor, training: bool = False) -> Tuple[Tensor, Tensor]:
        z = self.vn2(self.vn1(x, training=training), training=training)
        z = self.vn_lin(z)  # (..., 3, out_ch)
        z0 = z.transpose(-1, -2)  # (..., out_ch, 3): frame vectors as rows
        if self.normalize_frame:
            v1 = z0[..., 0, :]
            u1 = v1 / (torch.linalg.vector_norm(v1, dim=-1, keepdim=True) + EPS)
            v2 = z0[..., 1, :]
            v2 = v2 - torch.sum(v2 * u1, dim=-1, keepdim=True) * u1
            u2 = v2 / (torch.linalg.vector_norm(v2, dim=-1, keepdim=True) + EPS)
            u3 = torch.linalg.cross(u1, u2, dim=-1)
            frame = torch.stack([u1, u2, u3], dim=-2)
        else:
            frame = z0
        return torch.einsum("...vc,...kv->...kc", x, frame), frame
