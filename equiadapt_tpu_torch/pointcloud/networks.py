"""VN-Small frame estimator and kNN graph features for point clouds.

Counterpart of `equiadapt_tpu/pointcloud/networks.py`.

`knn_indices` takes the JAX package's three modes, "exact", "approx" and
"fused", and all three compute one function here: exact kNN by negative
squared distance with first-occurrence ties. On a CUDA tensor each launches
kernel K8 (`ops/kernels/knn.py`); on a CPU tensor each takes K8's plain
version. The JAX modes differ only in how a TPU computes the function
(`lax.top_k`, `lax.approx_max_k`, the Pallas kernel); off a TPU,
`approx_max_k` is exact too, and the port has no backend switch. The JAX
fallback for shapes the TPU tile cannot take has no counterpart: K8 takes
every shape within its stated limits and raises beyond them. The indices
carry no gradient, in either package: `knn_indices` reads a detached input,
so training builds no autograd graph of the plain version's (B, N, N)
distances.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from equiadapt_tpu_torch.common.layers import Dropout
from equiadapt_tpu_torch.ops.kernels import knn as knn_kernel
from equiadapt_tpu_torch.pointcloud.vector_neurons import (
    VNBatchNorm,
    VNLinearLeakyReLU,
    VNMaxPool,
    mean_pool,
)

Tensor = torch.Tensor

__all__ = ["knn_indices", "graph_feature_cross", "gather_neighbors", "VNSmall"]

KNN_MODES = ("exact", "approx", "fused")


def knn_indices(points: Tensor, k: int, mode: str = "exact") -> Tensor:
    """(B, N, D) points -> (B, N, k) int32 indices of the k nearest points by
    negative squared distance, nearest first, self included. Every mode runs
    K8 on the detached points (module docstring)."""
    if mode not in KNN_MODES:
        raise ValueError(f"knn mode must be one of {KNN_MODES}, got {mode!r}")
    return knn_kernel.knn_indices(points.detach().contiguous(), k)


def gather_neighbors(x: Tensor, idx: Tensor) -> Tensor:
    """x (B, N, ...) and idx (B, N, k) -> (B, N, k, ...): out[b, n, j] =
    x[b, idx[b, n, j]]."""
    B, N = x.shape[:2]
    flat = idx.long() + N * torch.arange(B, device=idx.device)[:, None, None]
    return x.reshape(B * N, *x.shape[2:])[flat.reshape(-1)].reshape(
        *idx.shape, *x.shape[2:])


def graph_feature_cross(
    x: Tensor, k: int, idx: Optional[Tensor] = None, knn_mode: str = "exact"
) -> Tensor:
    """Cross-product edge features of VN features x (B, N, 3, C):
    (B, N, k, 3, 3C), per edge concat(neighbor - x, x, neighbor x x) on the
    channel axis. The graph is kNN on the flattened 3C coordinates."""
    B, N, three, C = x.shape
    if idx is None:
        idx = knn_indices(x.reshape(B, N, three * C), k, mode=knn_mode)
    feat = gather_neighbors(x, idx)  # (B, N, k, 3, C)
    center = x[:, :, None].expand_as(feat)
    cross = torch.linalg.cross(feat, center, dim=-2)
    return torch.cat([feat - center, center, cross], dim=-1)


class VNSmall(nn.Module):
    """Small VN frame estimator: (B, N, 3) clouds -> (B, 3, 3), rows three
    equivariant vectors. conv_pos on kNN cross features, pool over the
    neighbours (mean, or VNMaxPool `pool`), conv1, bn1, conv2 (4 channels),
    dropout (in training, its mask from `generator`), mean over points, the
    first 3 channels."""

    def __init__(self, n_knn: int = 20, pooling: str = "mean",
                 knn_mode: str = "exact", dropout_rate: float = 0.5,
                 device="cuda"):
        super().__init__()
        if pooling not in ("mean", "max"):
            raise ValueError(f"Pooling type {pooling} not supported")
        if knn_mode not in KNN_MODES:
            raise ValueError(f"knn mode must be one of {KNN_MODES}, got {knn_mode!r}")
        self.n_knn = n_knn
        self.pooling = pooling
        self.knn_mode = knn_mode
        width = 64 // 3
        self.conv_pos = VNLinearLeakyReLU(3, width, negative_slope=0.0,
                                          device=device)
        if pooling == "max":
            self.pool = VNMaxPool(width, device=device)
        self.conv1 = VNLinearLeakyReLU(width, width, negative_slope=0.0,
                                       device=device)
        self.bn1 = VNBatchNorm(width, device=device)
        self.conv2 = VNLinearLeakyReLU(width, 12 // 3, negative_slope=0.0,
                                       device=device)
        self.dropout = Dropout(dropout_rate)

    def forward(self, point_cloud: Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        x = point_cloud[..., None]  # (B, N, 3, 1)
        feat = graph_feature_cross(x, k=self.n_knn, knn_mode=self.knn_mode)
        out = self.conv_pos(feat, training=training)  # (B, N, k, 3, C)
        if self.pooling == "max":
            B, N, k, three, C = out.shape
            pooled = self.pool(out.reshape(B * N, k, three, C)).reshape(
                B, N, three, C)
        else:
            pooled = mean_pool(out, axis=2)
        h = self.bn1(self.conv1(pooled, training=training), training=training)
        h = self.conv2(h, training=training)
        h = self.dropout(h, training=training, generator=generator)
        v = torch.mean(h, dim=1)  # (B, 3, 4)
        return v.transpose(-1, -2)[:, :3]
