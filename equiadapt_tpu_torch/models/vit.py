"""Vision Transformer (ViT-B/16 style) prediction network, NHWC in.

Counterpart of `equiadapt_tpu/models/vit.py`: conv patch embedding, a CLS
token, learned position embeddings, pre-LN encoder blocks (attention, then
an MLP with the exact erf GELU), a final LayerNorm and a linear head.
Flax's defaults are kept where torch's differ: LayerNorm eps 1e-6, queries
scaled by 1 / sqrt(head_dim). Submodules carry the names Flax gives their
counterparts (`Conv_0`, `EncoderBlock_{i}`, `LayerNorm_{i}`, `Dense_{i}`,
`MultiHeadDotProductAttention_0`), and the raw parameters `cls_token` and
`pos_embedding` keep theirs, so `utils.jax_weights` places the weights.

Torch modules are built at their input widths: `ViT` takes the image size
(the position embeddings' length follows from it). It computes in fp32
(the Flax `dtype` option has no counterpart). Dropout masks come from the
`generator` given in training.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from equiadapt_tpu_torch.common.layers import Dropout
from equiadapt_tpu_torch.models.egnn import MultiHeadDotProductAttention

Tensor = torch.Tensor

__all__ = ["EncoderBlock", "ViT", "ViTB16"]


class EncoderBlock(nn.Module):
    """Pre-LN transformer block over (B, n, width) tokens."""

    def __init__(self, width: int, num_heads: int, mlp_dim: int,
                 dropout: float = 0.0, device="cuda"):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(width, eps=1e-6, device=device)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            width, num_heads, dropout_rate=dropout, device=device)
        self.LayerNorm_1 = nn.LayerNorm(width, eps=1e-6, device=device)
        self.Dense_0 = nn.Linear(width, mlp_dim, device=device)
        self.Dense_1 = nn.Linear(mlp_dim, width, device=device)
        self.dropout = Dropout(dropout)

    def forward(self, x: Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        h = self.LayerNorm_0(x)
        x = x + self.MultiHeadDotProductAttention_0(h, training=training,
                                                    generator=generator)
        h = F.gelu(self.Dense_0(self.LayerNorm_1(x)))  # exact (erf) GELU
        h = self.dropout(h, training, generator)
        return x + self.Dense_1(h)


class ViT(nn.Module):
    """Vision Transformer classifier of (B, image_size, image_size, 3)."""

    def __init__(self, num_classes: int = 1000, patch_size: int = 16,
                 hidden_dim: int = 768, num_layers: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, dropout: float = 0.0, image_size: int = 224,
                 in_channels: int = 3, device="cuda"):
        super().__init__()
        self.num_layers = num_layers
        p = patch_size
        tokens = (image_size // p) ** 2 + 1
        self.Conv_0 = nn.Conv2d(in_channels, hidden_dim, p, stride=p, device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden_dim, device=device))
        self.pos_embedding = nn.Parameter(
            0.02 * torch.randn(1, tokens, hidden_dim, device=device))
        self.dropout = Dropout(dropout)
        for i in range(num_layers):
            setattr(self, f"EncoderBlock_{i}", EncoderBlock(
                hidden_dim, num_heads, mlp_dim, dropout, device=device))
        self.LayerNorm_0 = nn.LayerNorm(hidden_dim, eps=1e-6, device=device)
        self.Dense_0 = nn.Linear(hidden_dim, num_classes, device=device)

    def forward(self, x: Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        B = x.shape[0]
        t = self.Conv_0(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        t = torch.cat([self.cls_token.expand(B, -1, -1), t], dim=1)
        t = self.dropout(t + self.pos_embedding, training, generator)
        for i in range(self.num_layers):
            t = getattr(self, f"EncoderBlock_{i}")(t, training, generator)
        return self.Dense_0(self.LayerNorm_0(t)[:, 0])


def ViTB16(num_classes: int = 1000, **kw) -> ViT:
    return ViT(num_classes=num_classes, **kw)
