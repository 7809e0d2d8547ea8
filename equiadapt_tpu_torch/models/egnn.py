"""N-body prediction networks: an EGNN-style GNN, a per-node MLP, a
radial-field layer and a Transformer over particle tokens.

Counterpart of `equiadapt_tpu/models/egnn.py`. Graphs are dense (B, n, ...):
message passing is an MLP over all pairs and an adjacency einsum, where
node u sums over v (`einsum("uv,buvd->bud")`).

Torch modules need their input widths at construction, so they are derived
from the configuration. Submodules carry the names Flax gives their
counterparts (`Dense_{i}`, `GCL_{i}`, `Embed_0`, `LayerNorm_{i}`,
`MultiHeadDotProductAttention_{i}` with `query` / `key` / `value` / `out`),
so `utils.jax_weights.load_flax_variables` places the weights. The
Transformer keeps Flax's defaults where torch's differ: LayerNorm eps 1e-6,
and attention scales the queries by 1 / sqrt(head_dim) before the product.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from equiadapt_tpu_torch.nbody.vn_deepsets import complete_adjacency

Tensor = torch.Tensor

__all__ = [
    "GCL",
    "GNN",
    "NBodyTransformer",
    "NBodyMLP",
    "GCLRF",
    "DenseGeneral",
    "MultiHeadDotProductAttention",
    "positional_encoding",
    "edge_attributes",
]


def edge_attributes(loc: Tensor, charges: Tensor) -> Tensor:
    """Dense (B, n, n, 2) edge features: [q_u q_v, |x_u - x_v|^2]."""
    qq = charges[..., 0][:, :, None] * charges[..., 0][:, None, :]
    diff = loc[:, :, None, :] - loc[:, None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    return torch.stack([qq, d2], dim=-1)


def _dense(module: nn.Module, index: int, in_features: int, out_features: int,
           device) -> int:
    """Add `Dense_{index}` (a Linear with bias, as Flax's Dense) to module;
    returns the next index."""
    setattr(module, f"Dense_{index}",
            nn.Linear(in_features, out_features, device=device))
    return index + 1


class GCL(nn.Module):
    """EGNN-style graph conv layer: edge m_uv = MLP([h_u, h_v, e_uv]) (times
    a sigmoid gate of |h_u - h_v| with `attention`); node
    h_u' = MLP([h_u, sum_v a[u, v] m_uv]) (+ h_u when `recurrent`).
    `in_dim` (default `hidden_dim`) is h's width, `edge_dim` e's."""

    def __init__(self, hidden_dim: int, attention: bool = False,
                 recurrent: bool = True, in_dim: Optional[int] = None,
                 edge_dim: int = 2, device="cuda"):
        super().__init__()
        d = hidden_dim if in_dim is None else in_dim
        self.attention = attention
        self.recurrent = recurrent
        i = _dense(self, 0, 2 * d + edge_dim, hidden_dim, device)
        i = _dense(self, i, hidden_dim, hidden_dim, device)
        self._edge = ("Dense_0", "Dense_1")
        if attention:
            self._att = (f"Dense_{i}", f"Dense_{i + 1}")
            i = _dense(self, i, d, hidden_dim, device)
            i = _dense(self, i, hidden_dim, 1, device)
        self._node = (f"Dense_{i}", f"Dense_{i + 1}")
        i = _dense(self, i, d + hidden_dim, hidden_dim, device)
        _dense(self, i, hidden_dim, hidden_dim, device)

    def forward(self, h: Tensor, adjacency: Tensor, edge_attr: Tensor) -> Tensor:
        """h: (B, n, d); adjacency: (n, n); edge_attr: (B, n, n, e)."""
        B, n, d = h.shape
        hu = h[:, :, None, :].expand(B, n, n, d)
        hv = h[:, None, :, :].expand(B, n, n, d)
        e1, e2 = (getattr(self, k) for k in self._edge)
        m = F.silu(e2(F.silu(e1(torch.cat([hu, hv, edge_attr], dim=-1)))))
        if self.attention:
            a1, a2 = (getattr(self, k) for k in self._att)
            m = m * torch.sigmoid(a2(F.silu(a1(torch.abs(hu - hv)))))
        agg = torch.einsum("uv,buvd->bud", adjacency, m)
        n1, n2 = (getattr(self, k) for k in self._node)
        out = n2(F.silu(n1(torch.cat([h, agg], dim=-1))))
        if self.recurrent:
            out = out + h
        return out


class GNN(nn.Module):
    """Message-passing predictor of future locations: embeds [loc, vel],
    `num_layers` GCLs over the edge features of `loc`, decodes a 3-vector
    per node."""

    def __init__(self, hidden_dim: int = 64, num_layers: int = 4,
                 attention: bool = False, device="cuda"):
        super().__init__()
        self.num_layers = num_layers
        self.Dense_0 = nn.Linear(6, hidden_dim, device=device)
        for i in range(num_layers):
            setattr(self, f"GCL_{i}", GCL(hidden_dim, attention=attention,
                                          device=device))
        self.Dense_1 = nn.Linear(hidden_dim, hidden_dim, device=device)
        self.Dense_2 = nn.Linear(hidden_dim, 3, device=device)

    def forward(self, loc: Tensor, vel: Tensor, charges: Tensor,
                adjacency: Optional[Tensor] = None, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """(B, n, 3) x2 + (B, n, 1) -> (B, n, 3)."""
        if adjacency is None:
            adjacency = complete_adjacency(loc.shape[1], device=loc.device,
                                           dtype=loc.dtype)
        edge_attr = edge_attributes(loc, charges)
        h = self.Dense_0(torch.cat([loc, vel], dim=-1))
        for i in range(self.num_layers):
            h = getattr(self, f"GCL_{i}")(h, adjacency, edge_attr)
        return self.Dense_2(F.silu(self.Dense_1(h)))


class NBodyMLP(nn.Module):
    """Per-node MLP baseline on [loc, vel, charge]: no message passing."""

    def __init__(self, hidden_dim: int = 64, num_layers: int = 4, device="cuda"):
        super().__init__()
        self.num_layers = num_layers
        width = 7
        for i in range(num_layers - 1):
            _dense(self, i, width, hidden_dim, device)
            width = hidden_dim
        _dense(self, num_layers - 1, width, 3, device)

    def forward(self, loc: Tensor, vel: Tensor, charges: Tensor,
                adjacency: Optional[Tensor] = None, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        h = torch.cat([loc, vel, charges], dim=-1)
        for i in range(self.num_layers - 1):
            h = F.silu(getattr(self, f"Dense_{i}")(h))
        return getattr(self, f"Dense_{self.num_layers - 1}")(h)


class GCLRF(nn.Module):
    """Radial-field layer: x_u + sum_v a[u, v] phi(|x_u - x_v|^2) (x_u - x_v),
    an E(n)-equivariant coordinate update."""

    def __init__(self, hidden_dim: int = 64, device="cuda"):
        super().__init__()
        self.Dense_0 = nn.Linear(1, hidden_dim, device=device)
        self.Dense_1 = nn.Linear(hidden_dim, 1, device=device)

    def forward(self, loc: Tensor, adjacency: Tensor) -> Tensor:
        diff = loc[:, :, None, :] - loc[:, None, :, :]
        d2 = torch.sum(diff * diff, dim=-1, keepdim=True)
        m = self.Dense_1(F.silu(self.Dense_0(d2)))
        return loc + torch.einsum("uv,buvd->bud", adjacency, m * diff)


def positional_encoding(x: Tensor, hidden_dim: int) -> Tensor:
    """Sinusoidal encoding of coordinate *values*: x (..., k) ->
    (..., k, hidden_dim), sin in the even features and cos in the odd ones.
    `hidden_dim` must be even."""
    if hidden_dim % 2:
        raise ValueError(f"positional_encoding needs an even hidden_dim, got {hidden_dim}")
    half = hidden_dim // 2
    div = torch.exp(torch.arange(half, dtype=torch.float32, device=x.device)
                    * (-math.log(10000.0) / hidden_dim))
    ang = x[..., None] * div  # (..., k, half), float32 at least
    pe = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)
    return pe.reshape(x.shape + (hidden_dim,)).to(x.dtype)


class DenseGeneral(nn.Linear):
    """Flax's `DenseGeneral` over flattened axes: a Linear whose Flax kernel
    is `kernel_shape` and bias `bias_shape` (the loader reshapes)."""

    def __init__(self, kernel_shape: Sequence[int], bias_shape: Sequence[int],
                 n_in_axes: int = 1, device="cuda"):
        self.kernel_shape, self.bias_shape = tuple(kernel_shape), tuple(bias_shape)
        super().__init__(math.prod(kernel_shape[:n_in_axes]),
                         math.prod(kernel_shape[n_in_axes:]), device=device)


class MultiHeadDotProductAttention(nn.Module):
    """Flax's `nn.MultiHeadDotProductAttention` without a mask:
    query / key / value projections to (heads, head_dim), queries scaled by
    1 / sqrt(head_dim), a softmax over the keys, `out` back to `features`.
    Keys and values come from `kv` where it is given (cross-attention, Flax's
    `inputs_k`), else from the queries' input. With `dropout_rate` > 0 and
    training=True the attention weights are dropped as Flax drops them (one
    (queries, keys) mask broadcast over batch and heads, drawn from
    `generator`)."""

    def __init__(self, features: int, num_heads: int,
                 qkv_features: Optional[int] = None, dropout_rate: float = 0.0,
                 device="cuda"):
        super().__init__()
        qkv = qkv_features or features
        if qkv % num_heads:
            raise ValueError(f"qkv_features {qkv} is not divisible by {num_heads} heads")
        self.num_heads, self.head_dim = num_heads, qkv // num_heads
        self.dropout_rate = dropout_rate
        heads = (num_heads, self.head_dim)
        for name in ("query", "key", "value"):
            setattr(self, name, DenseGeneral((features,) + heads, heads, device=device))
        self.out = DenseGeneral(heads + (features,), (features,), n_in_axes=2,
                                device=device)

    def forward(self, x: Tensor, kv: Optional[Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """Attention of (B, n, features) queries over `kv` (B, m, features),
        or over x itself."""
        return self.out(self._attend(x, kv, training, generator))

    def _attend(self, x: Tensor, kv: Optional[Tensor], training: bool,
                generator: Optional[torch.Generator]) -> Tensor:
        """The heads' outputs before `out`, (B, n, heads * head_dim)."""
        B, n, _ = x.shape
        kv = x if kv is None else kv
        heads = (self.num_heads, self.head_dim)
        q = self.query(x).reshape(B, n, *heads) / math.sqrt(self.head_dim)
        k = self.key(kv).reshape(B, kv.shape[1], *heads)
        v = self.value(kv).reshape(B, kv.shape[1], *heads)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        if training and self.dropout_rate > 0.0:
            keep_prob = 1.0 - self.dropout_rate
            keep = torch.bernoulli(torch.full(w.shape[-2:], keep_prob, device=w.device),
                                   generator=generator)
            w = w * (keep / keep_prob).to(w.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return o.reshape(B, n, -1)


class NBodyTransformer(nn.Module):
    """Transformer over particle tokens: each token is the positional
    encodings of the 6 coordinates and a charge embedding, width
    7 * hidden_dim; `num_layers` post-norm blocks (attention, then a ReLU
    feed-forward of `ff_hidden`), then a ReLU head to 3-vectors."""

    def __init__(self, hidden_dim: int = 32, num_layers: int = 2, nheads: int = 2,
                 ff_hidden: int = 128, device="cuda"):
        super().__init__()
        self.hidden_dim, self.num_layers = hidden_dim, num_layers
        d_model = 7 * hidden_dim
        self.Embed_0 = nn.Embedding(2, hidden_dim, device=device)
        for i in range(num_layers):
            setattr(self, f"MultiHeadDotProductAttention_{i}",
                    MultiHeadDotProductAttention(d_model, nheads, d_model, device=device))
            for j in (2 * i, 2 * i + 1):
                setattr(self, f"LayerNorm_{j}",
                        nn.LayerNorm(d_model, eps=1e-6, device=device))
            _dense(self, 2 * i, d_model, ff_hidden, device)
            _dense(self, 2 * i + 1, ff_hidden, d_model, device)
        _dense(self, 2 * num_layers, d_model, d_model, device)
        _dense(self, 2 * num_layers + 1, d_model, 3, device)

    def forward(self, loc: Tensor, vel: Tensor, charges: Tensor,
                adjacency: Optional[Tensor] = None, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        B, n, _ = loc.shape
        pe = positional_encoding(torch.cat([loc, vel], dim=-1), self.hidden_dim)
        ce = self.Embed_0((charges[..., 0] > 0).long())  # {-1, 1} -> {0, 1}
        h = torch.cat([pe.reshape(B, n, 6 * self.hidden_dim), ce], dim=-1)
        for i in range(self.num_layers):
            attn = getattr(self, f"MultiHeadDotProductAttention_{i}")(h)
            h = getattr(self, f"LayerNorm_{2 * i}")(h + attn)
            ff = getattr(self, f"Dense_{2 * i + 1}")(
                F.relu(getattr(self, f"Dense_{2 * i}")(h)))
            h = getattr(self, f"LayerNorm_{2 * i + 1}")(h + ff)
        L = 2 * self.num_layers
        return getattr(self, f"Dense_{L + 1}")(F.relu(getattr(self, f"Dense_{L}")(h)))
