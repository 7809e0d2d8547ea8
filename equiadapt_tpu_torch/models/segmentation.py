"""Promptable instance segmentation: a SAM-style model and its losses, NHWC.

Counterpart of `equiadapt_tpu/models/segmentation.py`. `SAMLite` is an
image encoder (the light ViT `ImageEncoderLite`, or SAM's own
`SamVitEncoder` with encoder="sam_vit"), a box prompt encoder and a
two-way mask decoder, batched over (B, N) prompts:

    images (B, H, W, 3), boxes (B, N, 4) xyxy
        -> mask logits (B, N, H, W), predicted IoU (B, N)

The losses are the reference's: `focal_loss` (BCE reduced first, then
focal-modulated), `dice_loss` and `calc_iou` of thresholded logits.

Flax's defaults are kept where torch's differ: LayerNorm eps 1e-6;
attention queries scaled by 1 / sqrt(head_dim); the decoder's GELUs are the
tanh form (`nn.gelu`'s default), the encoders' the exact one; a Flax
`ConvTranspose` (kernel 2, stride 2, "SAME") is `conv_transpose2d` with the
kernel flipped in space (`utils.jax_weights` flips it). Submodules carry
the names Flax gives their counterparts, raw parameters theirs
(`pos_embedding`, `pe_gaussian`, `corner_embed`, `mask_tokens`,
`iou_token`). Modules are built at their input widths, so `SAMLite` and
`ImageEncoderLite` take the image size. Attention is written out as
products and a softmax in fp32, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from equiadapt_tpu_torch.models.egnn import MultiHeadDotProductAttention
from equiadapt_tpu_torch.models.sam_encoder import SamVitEncoder
from equiadapt_tpu_torch.models.vit import EncoderBlock
from equiadapt_tpu_torch.ops.warp import resize

Tensor = torch.Tensor

ALPHA = 0.8
GAMMA = 2.0

__all__ = [
    "focal_loss",
    "dice_loss",
    "calc_iou",
    "ImageEncoderLite",
    "PromptEncoderLite",
    "MaskDecoderLite",
    "SAMLite",
    "segmentation_forward_outputs",
]


def focal_loss(logits: Tensor, targets: Tensor, alpha: float = ALPHA,
               gamma: float = GAMMA) -> Tensor:
    """BCE of the flattened sigmoid probabilities, reduced to its mean
    first, then focal-modulated: alpha (1 - exp(-bce))^gamma bce."""
    p = torch.sigmoid(logits).reshape(-1)
    t = targets.reshape(-1)
    eps = 1e-7
    bce = -torch.mean(t * torch.log(p + eps) + (1 - t) * torch.log(1 - p + eps))
    return alpha * (1 - torch.exp(-bce)) ** gamma * bce


def dice_loss(logits: Tensor, targets: Tensor, smooth: float = 1.0) -> Tensor:
    """1 - (2 sum(p t) + smooth) / (sum(p) + sum(t) + smooth), p the sigmoid."""
    p = torch.sigmoid(logits).reshape(-1)
    t = targets.reshape(-1)
    inter = torch.sum(p * t)
    return 1.0 - (2.0 * inter + smooth) / (torch.sum(p) + torch.sum(t) + smooth)


def calc_iou(pred_mask: Tensor, gt_mask: Tensor, eps: float = 1e-7) -> Tensor:
    """IoU of (..., H, W) logits thresholded at 0 against {0, 1} masks."""
    pred = (pred_mask > 0).float()
    inter = torch.sum(pred * gt_mask, dim=(-2, -1))
    union = torch.sum(pred, dim=(-2, -1)) + torch.sum(gt_mask, dim=(-2, -1)) - inter
    return inter / (union + eps)


def _conv_nhwc(conv: nn.Module, x: Tensor) -> Tensor:
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ImageEncoderLite(nn.Module):
    """Light ViT image encoder with SAM's neck:
    (B, S, S, 3) -> (B, S / p, S / p, embed_dim)."""

    def __init__(self, image_size: int, embed_dim: int = 256, patch_size: int = 16,
                 depth: int = 4, num_heads: int = 4, width: int = 256,
                 device="cuda"):
        super().__init__()
        p = patch_size
        self.depth, self.width = depth, width
        self.Conv_0 = nn.Conv2d(3, width, p, stride=p, device=device)
        self.pos_embedding = nn.Parameter(
            0.02 * torch.randn(1, (image_size // p) ** 2, width, device=device))
        for i in range(depth):
            setattr(self, f"EncoderBlock_{i}",
                    EncoderBlock(width, num_heads, width * 4, device=device))
        self.LayerNorm_0 = nn.LayerNorm(width, eps=1e-6, device=device)
        self.Conv_1 = nn.Conv2d(width, embed_dim, 1, bias=False, device=device)
        self.LayerNorm_1 = nn.LayerNorm(embed_dim, eps=1e-6, device=device)
        self.Conv_2 = nn.Conv2d(embed_dim, embed_dim, 3, padding=1, bias=False,
                                device=device)
        self.LayerNorm_2 = nn.LayerNorm(embed_dim, eps=1e-6, device=device)

    def forward(self, x: Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        t = self.Conv_0(x.permute(0, 3, 1, 2))  # (B, width, h, w)
        B, _, h, w = t.shape
        t = t.flatten(2).transpose(1, 2) + self.pos_embedding
        for i in range(self.depth):
            t = getattr(self, f"EncoderBlock_{i}")(t, training, generator)
        t = self.LayerNorm_0(t).reshape(B, h, w, self.width)
        t = self.LayerNorm_1(_conv_nhwc(self.Conv_1, t))
        return self.LayerNorm_2(_conv_nhwc(self.Conv_2, t))


class PromptEncoderLite(nn.Module):
    """Box prompts -> (B, N, 2, embed_dim) corner tokens: random-Fourier
    encodings of the normalized corners plus learned corner-type
    embeddings (SAM's scheme)."""

    def __init__(self, embed_dim: int = 256, device="cuda"):
        super().__init__()
        self.pe_gaussian = nn.Parameter(torch.randn(2, embed_dim // 2, device=device))
        self.corner_embed = nn.Parameter(
            0.02 * torch.randn(2, embed_dim, device=device))

    def forward(self, boxes: Tensor, image_hw: Tuple[int, int]) -> Tensor:
        H, W = image_hw
        corners = torch.stack([boxes[..., :2], boxes[..., 2:]], dim=-2)  # xy
        norm = corners / torch.tensor([W, H], dtype=corners.dtype,
                                      device=corners.device)
        proj = (2.0 * norm - 1.0) @ self.pe_gaussian
        enc = torch.cat([torch.sin(2 * torch.pi * proj),
                         torch.cos(2 * torch.pi * proj)], dim=-1)
        return enc + self.corner_embed


class MaskDecoderLite(nn.Module):
    """Two-way-attention mask decoder: the IoU and mask tokens attend to the
    prompts and the image grid and the grid to them; a hypernetwork head
    makes a mask per mask token from the upscaled grid. With several mask
    tokens (SAM's multimask heads) the mask of the best predicted IoU is
    returned."""

    def __init__(self, embed_dim: int = 256, depth: int = 2, num_heads: int = 4,
                 num_mask_tokens: int = 1, device="cuda"):
        super().__init__()
        C, T = embed_dim, num_mask_tokens
        self.depth, self.num_mask_tokens = depth, T
        self.mask_tokens = nn.Parameter(0.02 * torch.randn(T, C, device=device))
        self.iou_token = nn.Parameter(0.02 * torch.randn(1, C, device=device))
        for i in range(3 * depth):
            setattr(self, f"MultiHeadDotProductAttention_{i}",
                    MultiHeadDotProductAttention(C, num_heads, device=device))
        for i in range(4 * depth):
            setattr(self, f"LayerNorm_{i}", nn.LayerNorm(C, eps=1e-6, device=device))
        for i in range(depth):
            setattr(self, f"Dense_{2 * i}", nn.Linear(C, 2 * C, device=device))
            setattr(self, f"Dense_{2 * i + 1}", nn.Linear(2 * C, C, device=device))
        self.upscale_conv1 = nn.ConvTranspose2d(C, C // 4, 2, stride=2, device=device)
        self.upscale_ln = nn.LayerNorm(C // 4, eps=1e-6, device=device)
        self.upscale_conv2 = nn.ConvTranspose2d(C // 4, C // 8, 2, stride=2,
                                                device=device)
        for j in range(T):
            self._mlp3(f"hyper{j}", C, (C, C, C // 8), device)
        self._mlp3("iou_head", C, (C, C, T), device)

    def _mlp3(self, name: str, d_in: int, dims: Sequence[int], device) -> None:
        for li, d in enumerate(dims):
            setattr(self, f"{name}_{li}", nn.Linear(d_in, d, device=device))
            d_in = d

    def _run_mlp3(self, name: str, t: Tensor) -> Tensor:
        for li in range(3):
            t = getattr(self, f"{name}_{li}")(t)
            if li < 2:
                t = F.relu(t)
        return t

    def forward(self, image_embed: Tensor, prompt_embed: Tensor,
                training: bool = False) -> Tuple[Tensor, Tensor]:
        """image_embed: (B, h, w, C); prompt_embed: (B, N, 2, C) -> mask
        logits (B, N, 4h, 4w) and predicted IoU (B, N)."""
        B, h, w, C = image_embed.shape
        N = prompt_embed.shape[1]
        T = self.num_mask_tokens
        img = image_embed.reshape(B, 1, h * w, C).expand(B, N, h * w, C)
        img = img.reshape(B * N, h * w, C)
        # token layout of SAM: [iou_token, mask_tokens..., prompts]
        toks = torch.cat([
            self.iou_token[None].expand(B * N, 1, C),
            self.mask_tokens[None].expand(B * N, T, C),
            prompt_embed.reshape(B * N, 2, C),
        ], dim=1)
        for i in range(self.depth):
            attn = [getattr(self, f"MultiHeadDotProductAttention_{3 * i + j}")
                    for j in range(3)]
            ln = [getattr(self, f"LayerNorm_{4 * i + j}") for j in range(4)]
            toks = ln[0](toks + attn[0](toks))  # tokens self-attend
            toks = ln[1](toks + attn[1](toks, img))  # tokens -> image
            mlp = F.gelu(getattr(self, f"Dense_{2 * i}")(toks), approximate="tanh")
            toks = ln[2](toks + getattr(self, f"Dense_{2 * i + 1}")(mlp))
            img = ln[3](img + attn[2](img, toks))  # image -> tokens
        grid = img.reshape(B * N, h, w, C).permute(0, 3, 1, 2)
        up = self.upscale_conv1(grid).permute(0, 2, 3, 1)
        up = F.gelu(self.upscale_ln(up), approximate="tanh")
        up = self.upscale_conv2(up.permute(0, 3, 1, 2))
        up = F.gelu(up, approximate="tanh")  # (B * N, C / 8, 4h, 4w)
        hypers = torch.stack([self._run_mlp3(f"hyper{j}", toks[:, 1 + j])
                              for j in range(T)], dim=1)  # (B * N, T, C / 8)
        masks = torch.einsum("bchw,btc->bthw", up, hypers)
        iou = self._run_mlp3("iou_head", toks[:, 0])  # (B * N, T)
        if T > 1:  # SAM's multimask output: the best mask by predicted IoU
            best = torch.argmax(iou, dim=-1)
            masks = masks[torch.arange(B * N, device=masks.device), best]
            iou = torch.gather(iou, 1, best[:, None])[:, 0]
        else:
            masks, iou = masks[:, 0], iou[:, 0]
        return masks.reshape(B, N, 4 * h, 4 * w), iou.reshape(B, N)


class SAMLite(nn.Module):
    """Promptable segmentation model with the reference SAMModel's
    interface, batched over prompts.

    encoder="lite" is `ImageEncoderLite` (width 256); "sam_vit" is
    `SamVitEncoder` at embed 64 * encoder_depth (ViT-B: 12 blocks, 768),
    window 14, global attention in blocks (2, 5, 8, 11), with `num_heads`
    shared with the decoder, as in the JAX package."""

    def __init__(self, image_size: int, embed_dim: int = 256, encoder_depth: int = 4,
                 decoder_depth: int = 2, num_heads: int = 4, patch_size: int = 16,
                 encoder: str = "lite", num_mask_tokens: int = 1, device="cuda"):
        super().__init__()
        self.encoder = encoder
        if encoder == "sam_vit":
            self.SamVitEncoder_0 = SamVitEncoder(
                img_size=image_size, patch_size=patch_size,
                embed_dim=encoder_depth * 64, depth=encoder_depth,
                num_heads=num_heads, out_chans=embed_dim, device=device)
        elif encoder == "lite":
            self.ImageEncoderLite_0 = ImageEncoderLite(
                image_size, embed_dim=embed_dim, patch_size=patch_size,
                depth=encoder_depth, num_heads=num_heads, device=device)
        else:
            raise ValueError(f"unknown SAMLite encoder {encoder!r}")
        self.PromptEncoderLite_0 = PromptEncoderLite(embed_dim, device=device)
        self.MaskDecoderLite_0 = MaskDecoderLite(
            embed_dim, decoder_depth, num_heads, num_mask_tokens, device=device)

    def image_encoder(self) -> nn.Module:
        return (self.SamVitEncoder_0 if self.encoder == "sam_vit"
                else self.ImageEncoderLite_0)

    def forward(self, images: Tensor, boxes: Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Tuple[Tensor, Tensor]:
        """images: (B, H, W, 3); boxes: (B, N, 4) xyxy -> (mask logits
        (B, N, H, W), IoU predictions (B, N))."""
        H, W = images.shape[1:3]
        emb = self.image_encoder()(images, training, generator)
        sparse = self.PromptEncoderLite_0(boxes, (H, W))
        low_res, iou = self.MaskDecoderLite_0(emb, sparse, training)
        # bilinear upsample, half-pixel centres (jax.image.resize "linear")
        masks = resize(low_res.movedim(1, -1), (H, W)).movedim(-1, 1)
        return masks, iou


def segmentation_forward_outputs(pred_masks: Tensor, ious: Tensor,
                                 targets: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """The reference's thresholded prediction dict."""
    return {
        "masks": (pred_masks > 0.5).to(torch.uint8),
        "scores": ious,
        "labels": targets["labels"],
        "boxes": targets["boxes"],
    }
