"""Segment Anything (Kirillov et al. 2023) at its published widths, box
prompts only, NHWC.

`SamModel` composes SAM's three parts as `segment_anything/build_sam.py`
builds them, with their module and parameter names, so a SAM checkpoint's
state dict (`image_encoder.*`, `prompt_encoder.*`, `mask_decoder.*`) loads
with `strict=True`:

* `image_encoder`: `SamVitEncoder` (ViT-B: 768 channels, 12 blocks of 12
  heads of 64, MLP 3,072, windows of 14, global attention in blocks
  2, 5, 8 and 11, decomposed relative positions; the 256-channel neck);
* `prompt_encoder`: SAM's `PromptEncoder`. A box's corners, `box + 0.5`
  over (W, H), are Fourier-encoded (`2c - 1`, `@ G`, `2 pi`, `[sin, cos]`)
  and take `point_embeddings.2` / `.3`; the dense embedding is
  `no_mask_embed` over the grid; `dense_pe()` encodes the grid's cell
  centres. `point_embeddings.0` / `.1`, `not_a_point_embed` and
  `mask_downscaling` are held for the checkpoint and never read: point and
  mask prompts are not supported.
* `mask_decoder`: SAM's `MaskDecoder` and `TwoWayTransformer` (depth 2, 256
  wide, 8 heads, MLP 2,048 with ReLU, the cross-attentions at half width,
  LayerNorm eps 1e-5), the output upscaling (two transposed convolutions,
  LayerNorm2d eps 1e-6, exact GELU), four hypernetwork MLPs and the IoU
  head. `multimask_output=False`, as equiadapt's SAM wrapper calls it: mask
  token 0 and its IoU.

    images (B, H, W, 3), boxes (B, N, 4) xyxy
        -> mask logits (B, N, H, W) fp32, predicted IoU (B, N) fp32

The low-resolution masks are upsampled to (H, W) bilinearly with
half-pixel centres (`F.interpolate`, as equiadapt's wrapper does). The
image embedding is shared by the N prompts of an image.

`dtype` is the computation's dtype. Parameters are fp32; under
dtype=bfloat16 they are cast per call, the matrix products and
convolutions run in bf16 with fp32 accumulation, and LayerNorm and softmax
statistics stay fp32. The prompt
encoding is computed in fp32 and handed on in `dtype`.

Spans (`utils.profiling.annotate`): the encoder's (`models.sam_encoder`),
`sam/prompt`, `sam/decoder` (the two-way transformer, the upscaling and the
heads) and `sam/upsample`. The counter `sam/prompts` adds B x N a call.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from equiadapt_tpu_torch.common.layers import CastConvTranspose2d, CastLayerNorm, CastLinear
from equiadapt_tpu_torch.models.sam_encoder import SamVitEncoder, sam_vit_b_encoder_kwargs
from equiadapt_tpu_torch.utils.profiling import annotate, count

Tensor = torch.Tensor

__all__ = ["SamModel", "SamPromptEncoder", "SamMaskDecoder", "TwoWayTransformer",
           "sam_vit_b_kwargs"]


def sam_vit_b_kwargs(image_size: int = 1024) -> dict:
    """`SamModel` kwargs of SAM ViT-B (`build_sam_vit_b`) at `image_size`."""
    enc = sam_vit_b_encoder_kwargs()
    enc.pop("img_size")
    enc.pop("out_chans")
    return dict(image_size=image_size, encoder=enc, prompt_dim=256,
                decoder_depth=2, decoder_heads=8, decoder_mlp=2048,
                num_mask_tokens=4, iou_hidden=256)


class LayerNorm2d(nn.Module):
    """SAM's LayerNorm over the channels of NCHW maps."""

    def __init__(self, channels: int, eps: float = 1e-6, device="cuda"):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.eps = eps

    def forward(self, x: Tensor) -> Tensor:
        y = F.layer_norm(x.permute(0, 2, 3, 1), x.shape[1:2], self.weight.to(x.dtype),
                         self.bias.to(x.dtype), self.eps)
        return y.permute(0, 3, 1, 2)


class _PositionEmbeddingRandom(nn.Module):
    """SAM's random-Fourier position encoding of coordinates in [0, 1]."""

    def __init__(self, num_pos_feats: int, device="cuda"):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.randn(2, num_pos_feats, device=device))

    def encode(self, coords: Tensor) -> Tensor:
        """(..., 2) xy in [0, 1] -> (..., 2 * num_pos_feats)."""
        proj = (2.0 * coords - 1.0) @ self.positional_encoding_gaussian_matrix
        proj = 2.0 * math.pi * proj
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class SamPromptEncoder(nn.Module):
    """SAM's `PromptEncoder`, box path: boxes -> (B, N, 2, C) corner tokens;
    `no_mask_embed` is the dense embedding, `dense_pe()` the grid's."""

    def __init__(self, embed_dim: int, grid: int, device="cuda"):
        super().__init__()
        self.grid = grid
        self.pe_layer = _PositionEmbeddingRandom(embed_dim // 2, device=device)
        self.point_embeddings = nn.ModuleList(
            [nn.Embedding(1, embed_dim, device=device) for _ in range(4)])
        self.not_a_point_embed = nn.Embedding(1, embed_dim, device=device)
        mid = 16
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mid // 4, 2, stride=2, device=device),
            LayerNorm2d(mid // 4, device=device), nn.GELU(),
            nn.Conv2d(mid // 4, mid, 2, stride=2, device=device),
            LayerNorm2d(mid, device=device), nn.GELU(),
            nn.Conv2d(mid, embed_dim, 1, device=device))
        self.no_mask_embed = nn.Embedding(1, embed_dim, device=device)

    def forward(self, boxes: Tensor, image_hw: Tuple[int, int]) -> Tensor:
        H, W = image_hw
        corners = (boxes.float() + 0.5).reshape(*boxes.shape[:-1], 2, 2)
        emb = self.pe_layer.encode(torch.stack([corners[..., 0] / W, corners[..., 1] / H], -1))
        return torch.stack([emb[..., 0, :] + self.point_embeddings[2].weight[0],
                            emb[..., 1, :] + self.point_embeddings[3].weight[0]], dim=-2)

    def dense_pe(self) -> Tensor:
        """(grid, grid, C): the encoding of the grid's cell centres."""
        c = (torch.arange(self.grid, dtype=torch.float32,
                          device=self.no_mask_embed.weight.device) + 0.5) / self.grid
        xy = torch.stack([c[None, :].expand(self.grid, -1),
                          c[:, None].expand(-1, self.grid)], dim=-1)
        return self.pe_layer.encode(xy)


class _Attention(nn.Module):
    """SAM's decoder attention: q, k, v projected to `dim / downsample`,
    split into heads, scaled dot products, a softmax, `out_proj`."""

    def __init__(self, dim: int, heads: int, downsample: int = 1, device="cuda"):
        super().__init__()
        inner = dim // downsample
        self.heads = heads
        self.q_proj = CastLinear(dim, inner, device=device)
        self.k_proj = CastLinear(dim, inner, device=device)
        self.v_proj = CastLinear(dim, inner, device=device)
        self.out_proj = CastLinear(inner, dim, device=device)

    def _split(self, x: Tensor) -> Tensor:
        b, n, c = x.shape
        return x.reshape(b, n, self.heads, c // self.heads).transpose(1, 2)

    def forward(self, q: Tensor, k: Tensor, v: Tensor) -> Tensor:
        q, k, v = (self._split(f(t)) for f, t in
                   ((self.q_proj, q), (self.k_proj, k), (self.v_proj, v)))
        b, h, nq, d = q.shape
        count("sam/attn_score_elems", b * h * nq * k.shape[2])
        attn = torch.softmax((q @ k.transpose(-2, -1)) * d ** -0.5, dim=-1)
        return self.out_proj((attn @ v).transpose(1, 2).reshape(b, nq, h * d))


class _MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, device="cuda"):
        super().__init__()
        self.lin1 = CastLinear(dim, hidden, device=device)
        self.lin2 = CastLinear(hidden, dim, device=device)

    def forward(self, x: Tensor) -> Tensor:
        return self.lin2(torch.relu(self.lin1(x)))


class _TwoWayAttentionBlock(nn.Module):
    """Token self-attention, tokens -> image, the MLP, image -> tokens,
    each with a residual and a LayerNorm (the first layer's self-attention
    without position encodings or residual)."""

    def __init__(self, dim: int, heads: int, mlp: int, skip_first_layer_pe: bool,
                 downsample: int = 2, device="cuda"):
        super().__init__()
        self.self_attn = _Attention(dim, heads, device=device)
        self.norm1 = CastLayerNorm(dim, device=device)
        self.cross_attn_token_to_image = _Attention(dim, heads, downsample, device=device)
        self.norm2 = CastLayerNorm(dim, device=device)
        self.mlp = _MLPBlock(dim, mlp, device=device)
        self.norm3 = CastLayerNorm(dim, device=device)
        self.norm4 = CastLayerNorm(dim, device=device)
        self.cross_attn_image_to_token = _Attention(dim, heads, downsample, device=device)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries: Tensor, keys: Tensor, query_pe: Tensor,
                key_pe: Tensor) -> Tuple[Tensor, Tensor]:
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        k = keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(
            queries + query_pe, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        keys = self.norm4(keys + self.cross_attn_image_to_token(
            k, queries + query_pe, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    """SAM's `TwoWayTransformer`: (tokens (b, T, C), image (b, HW, C), its
    position encoding (b, HW, C)) -> (tokens, image)."""

    def __init__(self, depth: int, dim: int, heads: int, mlp: int, downsample: int = 2,
                 device="cuda"):
        super().__init__()
        self.layers = nn.ModuleList([
            _TwoWayAttentionBlock(dim, heads, mlp, i == 0, downsample, device=device)
            for i in range(depth)])
        self.final_attn_token_to_image = _Attention(dim, heads, downsample, device=device)
        self.norm_final_attn = CastLayerNorm(dim, device=device)

    def forward(self, tokens: Tensor, image: Tensor, image_pe: Tensor
                ) -> Tuple[Tensor, Tensor]:
        queries, keys = tokens, image
        for layer in self.layers:
            queries, keys = layer(queries, keys, tokens, image_pe)
        out = self.final_attn_token_to_image(queries + tokens, keys + image_pe, keys)
        return self.norm_final_attn(queries + out), keys


def _mlp(dims: Sequence[int], device) -> nn.Module:
    """SAM's `MLP`: linears with ReLU between, as `layers.{i}`."""
    m = nn.Module()
    m.layers = nn.ModuleList([CastLinear(a, b, device=device)
                              for a, b in zip(dims[:-1], dims[1:])])
    return m


def _run_mlp(m: nn.Module, x: Tensor) -> Tensor:
    for i, layer in enumerate(m.layers):
        x = layer(x)
        if i < len(m.layers) - 1:
            x = torch.relu(x)
    return x


class SamMaskDecoder(nn.Module):
    """SAM's `MaskDecoder` with `multimask_output=False`."""

    def __init__(self, dim: int = 256, depth: int = 2, heads: int = 8, mlp: int = 2048,
                 num_mask_tokens: int = 4, iou_hidden: int = 256, device="cuda"):
        super().__init__()
        self.num_mask_tokens = T = num_mask_tokens
        self.transformer = TwoWayTransformer(depth, dim, heads, mlp, device=device)
        self.iou_token = nn.Embedding(1, dim, device=device)
        self.mask_tokens = nn.Embedding(T, dim, device=device)
        self.output_upscaling = nn.Sequential(
            CastConvTranspose2d(dim, dim // 4, 2, stride=2, device=device),
            LayerNorm2d(dim // 4, device=device), nn.GELU(),
            CastConvTranspose2d(dim // 4, dim // 8, 2, stride=2, device=device),
            nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            [_mlp((dim, dim, dim, dim // 8), device) for _ in range(T)])
        self.iou_prediction_head = _mlp((dim, iou_hidden, iou_hidden, T), device)

    def forward(self, image: Tensor, image_pe: Tensor, sparse: Tensor, dense: Tensor
                ) -> Tuple[Tensor, Tensor]:
        """image (B, h, w, C), image_pe (h, w, C), sparse (B, N, S, C),
        dense (C,) -> low-resolution mask logits (B, N, 4h, 4w) and IoU
        (B, N), both in the computation's dtype."""
        B, h, w, C = image.shape
        N, dt = sparse.shape[1], image.dtype
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], dim=0)
        tokens = torch.cat([out_tokens.to(dt)[None].expand(B * N, -1, -1),
                            sparse.reshape(B * N, -1, C).to(dt)], dim=1)
        src = (image + dense.to(dt)).reshape(B, 1, h * w, C).expand(B, N, h * w, C)
        pos = image_pe.to(dt).reshape(1, h * w, C).expand(B * N, h * w, C)
        hs, src = self.transformer(tokens, src.reshape(B * N, h * w, C), pos)
        up = self.output_upscaling(src.transpose(1, 2).reshape(B * N, C, h, w))
        hyper = _run_mlp(self.output_hypernetworks_mlps[0], hs[:, 1])  # mask token 0
        masks = torch.einsum("bc,bchw->bhw", hyper, up)
        iou = _run_mlp(self.iou_prediction_head, hs[:, 0])[:, 0]
        return masks.reshape(B, N, 4 * h, 4 * w), iou.reshape(B, N)


class SamModel(nn.Module):
    """Segment Anything at the widths given (`sam_vit_b_kwargs` for ViT-B),
    box prompts only (module docstring).

    Args:
        image_size: the square input's side.
        encoder: `SamVitEncoder` kwargs other than `img_size`, `out_chans`
            and `dtype` (`out_chans` is `prompt_dim`).
        prompt_dim: the prompt encoder's and mask decoder's width.
        decoder_depth, decoder_heads, decoder_mlp: the two-way transformer's.
        num_mask_tokens: SAM's 4 (mask token 0 is the one read).
        iou_hidden: the IoU head's hidden width.
        dtype: the computation's dtype; parameters stay fp32.
    """

    def __init__(self, image_size: int = 1024, encoder: Optional[dict] = None,
                 prompt_dim: int = 256, decoder_depth: int = 2, decoder_heads: int = 8,
                 decoder_mlp: int = 2048, num_mask_tokens: int = 4, iou_hidden: int = 256,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        enc = dict(sam_vit_b_encoder_kwargs(), **(encoder or {}))
        enc.update(img_size=image_size, out_chans=prompt_dim, dtype=dtype)
        self.dtype = dtype
        self.image_encoder = SamVitEncoder(**enc, device=device)
        self.prompt_encoder = SamPromptEncoder(
            prompt_dim, image_size // enc["patch_size"], device=device)
        self.mask_decoder = SamMaskDecoder(prompt_dim, decoder_depth, decoder_heads,
                                           decoder_mlp, num_mask_tokens, iou_hidden,
                                           device=device)

    def forward(self, images: Tensor, boxes: Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Tuple[Tensor, Tensor]:
        """images (B, H, W, 3), boxes (B, N, 4) xyxy -> (mask logits
        (B, N, H, W), IoU predictions (B, N)), fp32. Eval only: `training`
        and `generator` are taken for the pipelines' calling convention."""
        B, H, W = images.shape[:3]
        count("sam/prompts", B * boxes.shape[1])
        emb = self.image_encoder(images)
        with annotate("sam/prompt"):
            sparse = self.prompt_encoder(boxes, (H, W))
            dense = self.prompt_encoder.no_mask_embed.weight[0]
            pe = self.prompt_encoder.dense_pe()
        with annotate("sam/decoder"):
            low, iou = self.mask_decoder(emb, pe, sparse, dense)
        with annotate("sam/upsample"):
            masks = F.interpolate(low.float(), size=(H, W), mode="bilinear",
                                  align_corners=False)
        return masks, iou.float()
