"""PointNet and DGCNN classifiers on channels-last points, eval path.

Counterpart of `equiadapt_tpu/models/pointnet.py` (`get_graph_feature`,
`PointNet`, `DGCNN`). Points are (B, N, C), so every 1x1 "conv" is an
`nn.Linear` on the last axis, and each DGCNN stage builds its kNN graph with
`pointcloud.networks.knn_indices` (kernel K8 on the card) and gathers the
neighbours by index. Submodules carry the names Flax gives their
counterparts (`Dense_0` ..., `BatchNorm_0` ...), so
`utils.jax_weights.load_flax_variables` carries weights across by path.
Leaky ReLU slope 0.2 and BatchNorm eps 1e-5, as in Flax. Eval only:
dropout is the identity there, and BatchNorm raises in train mode.

Not ported yet: `TransformNet` and `DGCNNPartSeg` (the part-segmentation
path, ROADMAP.md item 12).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from equiadapt_tpu_torch.pointcloud.networks import gather_neighbors, knn_indices
from equiadapt_tpu_torch.pointcloud.vector_neurons import BatchNormLastAxis

Tensor = torch.Tensor

__all__ = ["PointNet", "DGCNN", "get_graph_feature"]


def get_graph_feature(x: Tensor, k: int, idx: Optional[Tensor] = None,
                      knn_mode: str = "exact") -> Tensor:
    """DGCNN edge features of x (B, N, C): (B, N, k, 2C), per kNN edge
    concat(neighbor - x, x)."""
    if idx is None:
        idx = knn_indices(x, k, mode=knn_mode)
    feat = gather_neighbors(x, idx)  # (B, N, k, C)
    center = x[:, :, None].expand_as(feat)
    return torch.cat([feat - center, center], dim=-1)


def _bn_act(bn: nn.Module, x: Tensor, slope: float = 0.0) -> Tensor:
    x = bn(x)
    return F.leaky_relu(x, slope) if slope else torch.relu(x)


class _Classifier(nn.Module):
    """Numbered `Dense_i` / `BatchNorm_i` layers, added in Flax's order."""

    def _dense(self, i: int, in_f: int, out_f: int, bias: bool, device) -> None:
        self.add_module(f"Dense_{i}", nn.Linear(in_f, out_f, bias=bias, device=device))

    def _bn(self, i: int, features: int, device) -> None:
        self.add_module(f"BatchNorm_{i}", BatchNormLastAxis(features, device=device))

    def _layer(self, i: int, x: Tensor, slope: float) -> Tensor:
        """Dense_i, BatchNorm_i, then ReLU (slope 0) or leaky ReLU."""
        return _bn_act(getattr(self, f"BatchNorm_{i}"),
                       getattr(self, f"Dense_{i}")(x), slope)

    def _check_eval(self) -> None:
        if self.training:
            raise NotImplementedError(
                "training is not ported yet (ROADMAP.md item 12); call .eval()")


class PointNet(_Classifier):
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
        self._dense(6, 512, num_classes, True, device)

    def forward(self, x: Tensor) -> Tensor:
        self._check_eval()
        for i in range(5):
            x = self._layer(i, x, 0.0)
        x = torch.amax(x, dim=1)  # global max pool over points
        return self.Dense_6(self._layer(5, x, 0.0))


class DGCNN(_Classifier):
    """Dynamic graph CNN classifier: four EdgeConv stages (64, 64, 128, 256)
    on kNN graphs rebuilt from each stage's input, the concatenation to
    `emb_dims`, global max and mean pools, a 512 -> 256 -> num_classes head.
    (B, N, 3) -> (B, num_classes)."""

    def __init__(self, num_classes: int = 40, k: int = 20, emb_dims: int = 1024,
                 knn_mode: str = "exact", device="cuda"):
        super().__init__()
        self.k = k
        self.knn_mode = knn_mode
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

    def forward(self, x: Tensor) -> Tensor:
        self._check_eval()
        stages = []
        h = x
        for i in range(4):
            e = get_graph_feature(h, self.k, knn_mode=self.knn_mode)
            h = torch.amax(self._layer(i, e, 0.2), dim=2)  # max over neighbours
            stages.append(h)
        h = self._layer(4, torch.cat(stages, dim=-1), 0.2)  # (B, N, emb_dims)
        g = torch.cat([torch.amax(h, dim=1), torch.mean(h, dim=1)], dim=-1)
        g = self._layer(6, self._layer(5, g, 0.2), 0.2)
        return self.Dense_7(g)
