"""VN-DeepSets: the frame and translation estimator of n-body graphs.

Counterpart of `equiadapt_tpu/nbody/vn_deepsets.py`. Graphs are dense
(B, n, ...) tensors and features channels-last, (B, n, 3, C): C 3-vectors
per node, so every channel mix is an `nn.Linear` on the last axis. The two
equivariance fixes of the JAX package are kept: the VN linears have no
bias, and the frame vectors are the output *channel* vectors.

Torch modules need their input width at construction: `VNDeepSetLayer`
takes `in_channels`, and `VNDeepSets` derives the first layer's from
`canon_feature`. Submodules carry the Flax names (`first_set_layer`,
`set_layer_{i}`, `identity_linear`, `pooling_linear`, `nl/map_to_dir`,
`output_layer`), so `utils.jax_weights.load_flax_variables` places the
weights. `training` and the dropout `generator` are arguments; the module
mode is not read.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from equiadapt_tpu_torch.common.layers import Dropout
from equiadapt_tpu_torch.pointcloud.vector_neurons import VNLeakyReLU, VNSoftplus

Tensor = torch.Tensor

__all__ = ["VNDeepSetLayer", "VNDeepSets", "complete_adjacency"]


def complete_adjacency(n_nodes: int, device="cuda", dtype=torch.float32) -> Tensor:
    """Dense adjacency of the complete digraph without self-loops."""
    return (torch.ones((n_nodes, n_nodes), device=device, dtype=dtype)
            - torch.eye(n_nodes, device=device, dtype=dtype))


def _pool_nodes(x: Tensor, how: str, axis: int = 1) -> Tensor:
    if how == "mean":
        return torch.mean(x, dim=axis)
    if how == "sum":
        return torch.sum(x, dim=axis)
    if how == "max":
        return torch.amax(x, dim=axis)  # per component
    raise ValueError(f"Unknown pooling {how}")


class VNDeepSetLayer(nn.Module):
    """One DeepSet message layer:
    nonlinearity(identity_linear(x) + pooling_linear(aggregate(x))), then
    dropout and, when the shapes match, the residual. aggregate sums (or,
    with "mean" pooling, averages) over each node's in-neighbours:
    a[u, v] = 1 is an edge u -> v."""

    def __init__(self, in_channels: int, out_channels: int,
                 nonlinearity: str = "relu", pooling: str = "sum",
                 residual: bool = True, dropout: float = 0.0, device="cuda"):
        super().__init__()
        self.pooling = pooling
        self.residual = residual
        self.identity_linear = nn.Linear(in_channels, out_channels, bias=False,
                                         device=device)
        self.pooling_linear = nn.Linear(in_channels, out_channels, bias=False,
                                        device=device)
        if nonlinearity == "softplus":
            self.nl = VNSoftplus(out_channels, share_nonlinearity=False, device=device)
        elif nonlinearity == "relu":
            self.nl = VNLeakyReLU(out_channels, share_nonlinearity=False,
                                  negative_slope=0.0, device=device)
        elif nonlinearity == "leakyrelu":
            self.nl = VNLeakyReLU(out_channels, share_nonlinearity=False, device=device)
        else:
            raise ValueError(f"Unknown nonlinearity {nonlinearity}")
        self.dropout = Dropout(dropout)

    def forward(self, x: Tensor, adjacency: Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """x: (B, n, 3, C), adjacency: (n, n)."""
        identity = self.identity_linear(x)
        agg = torch.einsum("uv,bu...->bv...", adjacency, x)
        if self.pooling == "mean":
            deg = torch.sum(adjacency, dim=0)  # in-degree per node v
            agg = agg / torch.clamp(deg, min=1.0)[None, :, None, None]
        h = self.nl(identity + self.pooling_linear(agg))
        h = self.dropout(h, training=training, generator=generator)
        if self.residual and h.shape == x.shape:
            h = h + x
        return h


class VNDeepSets(nn.Module):
    """Frame + translation estimator for SE(3) n-body canonicalization.

    Canonical features from the centred positions (canon_feature in {p, pv,
    pva, pvc, pvac}: positions, velocities, their cross product, positions
    times charges), DeepSet layers, a pool over the graph and the output
    channel vectors: (rotation_vectors (B, 3, 3), translation (B, 3)). The
    centre pools with `layer_pooling` (a per-component max with "max").

    out_dim == 1 is the prediction mode: per-node 3-vectors (B, n, 3).
    """

    def __init__(self, hidden_dim: int = 16, num_layers: int = 4,
                 layer_pooling: str = "mean", final_pooling: str = "mean",
                 nonlinearity: str = "relu", canon_feature: str = "p",
                 canon_translation: bool = False, dropout: float = 0.0,
                 out_dim: int = 4, device="cuda"):
        super().__init__()
        self.layer_pooling = layer_pooling
        self.final_pooling = final_pooling
        self.canon_feature = canon_feature
        self.canon_translation = canon_translation
        self.out_dim = out_dim
        in_features = 1 + sum(c in canon_feature for c in "vac")
        common = dict(nonlinearity=nonlinearity, pooling=layer_pooling,
                      dropout=dropout, device=device)
        self.first_set_layer = VNDeepSetLayer(in_features, hidden_dim,
                                              residual=False, **common)
        for i in range(num_layers - 1):
            setattr(self, f"set_layer_{i}",
                    VNDeepSetLayer(hidden_dim, hidden_dim, residual=True, **common))
        self.num_layers = num_layers
        self.output_layer = nn.Linear(hidden_dim, out_dim, bias=False, device=device)

    def forward(self, loc: Tensor, vel: Tensor, charges: Optional[Tensor] = None,
                adjacency: Optional[Tensor] = None, training: bool = False,
                generator: Optional[torch.Generator] = None):
        """loc, vel: (B, n, 3); charges: (B, n, 1)."""
        n = loc.shape[1]
        if adjacency is None:
            adjacency = complete_adjacency(n, device=loc.device, dtype=loc.dtype)
        center = _pool_nodes(loc, self.layer_pooling, axis=1)  # (B, 3)
        canonical_loc = loc - center[:, None, :]

        feats = [canonical_loc]
        if "v" in self.canon_feature:
            feats.append(vel)
        if "a" in self.canon_feature:
            feats.append(torch.linalg.cross(canonical_loc, vel, dim=-1))
        if "c" in self.canon_feature:
            if charges is None:
                raise ValueError("canon_feature with 'c' requires charges")
            feats.append(canonical_loc * charges)
        x = torch.stack(feats, dim=-1)  # (B, n, 3, F)

        kw = dict(training=training, generator=generator)
        x = self.first_set_layer(x, adjacency, **kw)
        for i in range(self.num_layers - 1):
            x = getattr(self, f"set_layer_{i}")(x, adjacency, **kw)

        if self.out_dim == 1:
            return self.output_layer(x)[..., 0]  # (B, n, 3) per-node vectors

        g = _pool_nodes(x, self.final_pooling, axis=1)  # (B, 3, hidden)
        out = self.output_layer(g).transpose(-1, -2)  # channel vectors as rows
        rotation_vectors = out[:, :3]  # (B, 3, 3)
        translation = out[:, 3] + center if self.canon_translation else center
        return rotation_vectors, translation
