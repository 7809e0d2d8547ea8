"""PointNet, DGCNN and the DGCNN part segmenter on channels-last points.

Counterpart of `equiadapt_tpu/models/pointnet.py` (`get_graph_feature`,
`PointNet`, `DGCNN`, `TransformNet`, `DGCNNPartSeg`). Points are (B, N, C),
so every 1x1 "conv" is an `nn.Linear` on the last axis, and each DGCNN
stage builds its kNN graph with `pointcloud.networks.knn_indices` (kernel
K8 on the card) and gathers the neighbours by index. Submodules carry the
names Flax gives their counterparts (`TransformNet_0`, `Dense_0` ...,
`BatchNorm_0` ..., numbered in Flax's call order), so
`utils.jax_weights.load_flax_variables` carries weights across by path.
Leaky ReLU slope 0.2, BatchNorm eps 1e-5 and momentum 0.99, as in Flax.
`training` (train-mode BatchNorm, dropout) and the dropout `generator`
are arguments; the torch module mode is not read.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from equiadapt_tpu_torch.common.layers import Dropout
from equiadapt_tpu_torch.pointcloud.networks import gather_neighbors, knn_indices
from equiadapt_tpu_torch.pointcloud.vector_neurons import BatchNormLastAxis

Tensor = torch.Tensor

__all__ = ["PointNet", "DGCNN", "TransformNet", "DGCNNPartSeg", "get_graph_feature"]


def get_graph_feature(x: Tensor, k: int, idx: Optional[Tensor] = None,
                      knn_mode: str = "exact") -> Tensor:
    """DGCNN edge features of x (B, N, C): (B, N, k, 2C), per kNN edge
    concat(neighbor - x, x)."""
    if idx is None:
        idx = knn_indices(x, k, mode=knn_mode)
    feat = gather_neighbors(x, idx)  # (B, N, k, C)
    center = x[:, :, None].expand_as(feat)
    return torch.cat([feat - center, center], dim=-1)


class _Dense(nn.Module):
    """Numbered `Dense_i` / `BatchNorm_i` layers, added in Flax's order."""

    def _dense(self, i: int, in_f: int, out_f: int, bias: bool, device) -> None:
        self.add_module(f"Dense_{i}", nn.Linear(in_f, out_f, bias=bias, device=device))

    def _bn(self, i: int, features: int, device) -> None:
        self.add_module(f"BatchNorm_{i}", BatchNormLastAxis(features, device=device))

    def _layer(self, i: int, x: Tensor, slope: float, training: bool) -> Tensor:
        """Dense_i, BatchNorm_i, then ReLU (slope 0) or leaky ReLU."""
        x = getattr(self, f"BatchNorm_{i}")(getattr(self, f"Dense_{i}")(x),
                                            training=training)
        return F.leaky_relu(x, slope) if slope else torch.relu(x)


class PointNet(_Dense):
    """PointNet classifier: five shared MLPs, global max pool, FC head.
    (B, N, 3) -> (B, num_classes)."""

    def __init__(self, num_classes: int = 40, emb_dims: int = 1024, device="cuda"):
        super().__init__()
        widths = (3, 64, 64, 64, 128, emb_dims)
        for i in range(5):
            self._dense(i, widths[i], widths[i + 1], False, device)
            self._bn(i, widths[i + 1], device)
        self._dense(5, emb_dims, 512, False, device)
        self._bn(5, 512, device)
        self.dropout = Dropout(0.5)
        self._dense(6, 512, num_classes, True, device)

    def forward(self, x: Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        for i in range(5):
            x = self._layer(i, x, 0.0, training)
        x = torch.amax(x, dim=1)  # global max pool over points
        x = self.dropout(self._layer(5, x, 0.0, training), training, generator)
        return self.Dense_6(x)


class DGCNN(_Dense):
    """Dynamic graph CNN classifier: four EdgeConv stages (64, 64, 128, 256)
    on kNN graphs rebuilt from each stage's input, the concatenation to
    `emb_dims`, global max and mean pools, a 512 -> 256 -> num_classes head.
    (B, N, 3) -> (B, num_classes)."""

    def __init__(self, num_classes: int = 40, k: int = 20, emb_dims: int = 1024,
                 knn_mode: str = "exact", dropout: float = 0.5, device="cuda"):
        super().__init__()
        self.k = k
        self.knn_mode = knn_mode
        self.dropout = Dropout(dropout)
        c = 3
        for i, width in enumerate((64, 64, 128, 256)):
            self._dense(i, 2 * c, width, False, device)
            self._bn(i, width, device)
            c = width
        self._dense(4, 512, emb_dims, False, device)
        self._bn(4, emb_dims, device)
        self._dense(5, 2 * emb_dims, 512, False, device)
        self._bn(5, 512, device)
        self._dense(6, 512, 256, True, device)
        self._bn(6, 256, device)
        self._dense(7, 256, num_classes, True, device)

    def forward(self, x: Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        stages = []
        h = x
        for i in range(4):
            e = get_graph_feature(h, self.k, knn_mode=self.knn_mode)
            # max over neighbours
            h = torch.amax(self._layer(i, e, 0.2, training), dim=2)
            stages.append(h)
        h = self._layer(4, torch.cat(stages, dim=-1), 0.2, training)  # (B, N, emb)
        g = torch.cat([torch.amax(h, dim=1), torch.mean(h, dim=1)], dim=-1)
        g = self.dropout(self._layer(5, g, 0.2, training), training, generator)
        g = self.dropout(self._layer(6, g, 0.2, training), training, generator)
        return self.Dense_7(g)


class TransformNet(_Dense):
    """Input-alignment 3x3 transform regressor on DGCNN edge features
    (B, N, k, 6) -> (B, 3, 3): 64 per edge, max over the neighbours, 128,
    1024, max over the points, 512, 256, then `Dense_5` to 9 numbers, which
    starts at a zero kernel and the bias eye(3): fresh weights give the
    identity transform."""

    def __init__(self, device="cuda"):
        super().__init__()
        widths = (6, 64, 128, 1024, 512, 256)
        for i in range(5):
            self._dense(i, widths[i], widths[i + 1], False, device)
            self._bn(i, widths[i + 1], device)
        self._dense(5, 256, 9, True, device)
        with torch.no_grad():
            self.Dense_5.weight.zero_()
            self.Dense_5.bias.copy_(torch.eye(3).reshape(9))

    def forward(self, edge_feat: Tensor, training: bool = False) -> Tensor:
        h = torch.amax(self._layer(0, edge_feat, 0.2, training), dim=2)
        h = self._layer(2, self._layer(1, h, 0.2, training), 0.2, training)
        h = torch.amax(h, dim=1)
        h = self._layer(4, self._layer(3, h, 0.2, training), 0.2, training)
        return self.Dense_5(h).reshape(-1, 3, 3)


class DGCNNPartSeg(_Dense):
    """DGCNN for ShapeNet part segmentation: per-point part logits
    conditioned on a one-hot object category. (B, N, 3) points and
    (B, num_categories) one-hots -> (B, N, num_parts).

    `TransformNet_0` aligns the input; three EdgeConv stages of width 64
    (two layers in stages 0 and 1, one in stage 2: `Dense_0`-`Dense_4`)
    on kNN graphs of each stage's input; `Dense_5` to `emb_dims` and a max
    over the points; the category through `Dense_6` (64); then per point
    the global feature, the category feature and the three stages through
    `Dense_7` (256), `Dense_8` (256), `Dense_9` (128) and `Dense_10`, with
    dropout after the first two."""

    def __init__(self, num_parts: int = 50, num_categories: int = 16, k: int = 20,
                 emb_dims: int = 1024, dropout: float = 0.5,
                 knn_mode: str = "exact", device="cuda"):
        super().__init__()
        self.k = k
        self.knn_mode = knn_mode
        self.TransformNet_0 = TransformNet(device=device)
        # (input, output) width of each Dense_i with a BatchNorm_i
        widths = [(6, 64), (64, 64), (128, 64), (64, 64), (128, 64),
                  (192, emb_dims), (num_categories, 64),
                  (emb_dims + 64 + 192, 256), (256, 256), (256, 128)]
        for i, (w_in, w_out) in enumerate(widths):
            self._dense(i, w_in, w_out, False, device)
            self._bn(i, w_out, device)
        self._dense(10, 128, num_parts, True, device)
        self.dropout = Dropout(dropout)

    def forward(self, x: Tensor, category_onehot: Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        N = x.shape[1]
        e0 = get_graph_feature(x, self.k, knn_mode=self.knn_mode)
        t = self.TransformNet_0(e0, training=training)
        h = torch.einsum("bnd,bde->bne", x, t)
        stages = []
        for layers in ((0, 1), (2, 3), (4,)):
            e = get_graph_feature(h, self.k, knn_mode=self.knn_mode)
            for i in layers:
                e = self._layer(i, e, 0.2, training)
            h = torch.amax(e, dim=2)
            stages.append(h)
        h = torch.cat(stages, dim=-1)  # (B, N, 192)
        g = torch.amax(self._layer(5, h, 0.2, training), dim=1)  # (B, emb)
        lab = self._layer(6, category_onehot, 0.2, training)
        g = torch.cat([g, lab], dim=-1)[:, None, :].expand(-1, N, -1)
        h = torch.cat([g, h], dim=-1)
        h = self.dropout(self._layer(7, h, 0.2, training), training, generator)
        h = self.dropout(self._layer(8, h, 0.2, training), training, generator)
        return self.Dense_10(self._layer(9, h, 0.2, training))
