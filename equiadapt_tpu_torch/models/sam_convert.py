"""Load a torch Segment-Anything checkpoint into the port's SAM modules.

Counterpart of `equiadapt_tpu/models/sam_convert.py`, with the same
mappings:

* `convert_sam_vit_encoder(state_dict, encoder)`: a SAM image-encoder state
  dict into `SamVitEncoder`, whose parameters carry SAM's names and
  layouts, so every leaf loads as it is (strict: a missing or extra leaf
  raises).
* `convert_sam_checkpoint(state_dict, model)`: the leaves a lite `SAMLite`
  can take: the patch embedding, position embedding, transformer blocks
  (SAM's fused qkv split into query / key / value) and neck convs of the
  image encoder, the prompt encoder's box-corner embeddings and Fourier
  matrix, and the mask decoder's tokens, hypernetwork MLPs, IoU head (its
  last layer cut to the model's mask tokens) and output upscaling. A
  partial mapping: a warm start for the prior-regularized finetuning
  flow, not a SAM replica. The upscaling's transposed-conv kernels are
  flipped in space on the way in: the JAX converter puts SAM's kernels
  into Flax `ConvTranspose` leaves as they are, which computes the flipped
  kernel's transposed conv, and the port keeps the JAX package's numbers.

Both copy in place under `torch.no_grad()` and return the module.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch
from torch import nn

__all__ = ["convert_sam_checkpoint", "convert_sam_vit_encoder", "sam_vit_b_config"]


def sam_vit_b_config() -> Dict[str, Any]:
    """SAMLite constructor kwargs matching SAM ViT-B's dimensions."""
    return dict(embed_dim=256, encoder_depth=12, decoder_depth=2,
                num_heads=12, patch_size=16)


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x.detach().cpu() if hasattr(x, "detach") else x)


def _copy(param: torch.Tensor, value: torch.Tensor) -> None:
    if tuple(param.shape) != tuple(value.shape):
        raise ValueError(f"shape {tuple(value.shape)} for a tensor of "
                         f"{tuple(param.shape)}")
    param.copy_(value)


def convert_sam_vit_encoder(state_dict: Mapping[str, Any], encoder: nn.Module,
                            prefix: str = "image_encoder.") -> nn.Module:
    """Fill a `SamVitEncoder` from the `prefix` leaves of a SAM state dict;
    every leaf of the encoder must be there and every such leaf used."""
    sd = {k[len(prefix):]: _t(v) for k, v in state_dict.items()
          if k.startswith(prefix)}
    encoder.load_state_dict(sd, strict=True)
    return encoder


@torch.no_grad()
def convert_sam_checkpoint(state_dict: Mapping[str, Any], model: nn.Module) -> nn.Module:
    """Copy every mappable leaf of a SAM state dict into a lite `SAMLite`
    (keys like `image_encoder.blocks.0.attn.qkv.weight`); leaves SAM lacks
    keep their values."""
    sd = {k: _t(v) for k, v in state_dict.items()}
    enc = model.ImageEncoderLite_0

    if "image_encoder.patch_embed.proj.weight" in sd:
        _copy(enc.Conv_0.weight, sd["image_encoder.patch_embed.proj.weight"])
        _copy(enc.Conv_0.bias, sd["image_encoder.patch_embed.proj.bias"])
    if "image_encoder.pos_embed" in sd:
        pe = sd["image_encoder.pos_embed"]  # (1, h, w, C)
        _copy(enc.pos_embedding, pe.reshape(1, -1, pe.shape[-1]))

    i = 0
    while f"image_encoder.blocks.{i}.attn.qkv.weight" in sd and i < enc.depth:
        pre = f"image_encoder.blocks.{i}."
        blk = getattr(enc, f"EncoderBlock_{i}")
        mha = blk.MultiHeadDotProductAttention_0
        qkv_w, qkv_b = sd[pre + "attn.qkv.weight"], sd[pre + "attn.qkv.bias"]
        C = qkv_w.shape[1]
        for j, name in enumerate(("query", "key", "value")):
            _copy(getattr(mha, name).weight, qkv_w[j * C:(j + 1) * C])
            _copy(getattr(mha, name).bias, qkv_b[j * C:(j + 1) * C])
        _copy(mha.out.weight, sd[pre + "attn.proj.weight"])
        _copy(mha.out.bias, sd[pre + "attn.proj.bias"])
        for ln_t, ln in (("norm1", blk.LayerNorm_0), ("norm2", blk.LayerNorm_1)):
            _copy(ln.weight, sd[pre + f"{ln_t}.weight"])
            _copy(ln.bias, sd[pre + f"{ln_t}.bias"])
        for lin_t, dense in (("lin1", blk.Dense_0), ("lin2", blk.Dense_1)):
            _copy(dense.weight, sd[pre + f"mlp.{lin_t}.weight"])
            _copy(dense.bias, sd[pre + f"mlp.{lin_t}.bias"])
        i += 1

    if "image_encoder.neck.0.weight" in sd:
        _copy(enc.Conv_1.weight, sd["image_encoder.neck.0.weight"])
        _copy(enc.Conv_2.weight, sd["image_encoder.neck.2.weight"])

    # point_embeddings 2 and 3 are SAM's box corners
    pe = model.PromptEncoderLite_0
    if "prompt_encoder.point_embeddings.2.weight" in sd:
        _copy(pe.corner_embed, torch.stack([
            sd["prompt_encoder.point_embeddings.2.weight"][0],
            sd["prompt_encoder.point_embeddings.3.weight"][0]]))
        gauss = "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"
        if gauss in sd:
            _copy(pe.pe_gaussian, sd[gauss])

    dec = model.MaskDecoderLite_0
    if "mask_decoder.iou_token.weight" in sd:
        T = dec.num_mask_tokens
        _copy(dec.iou_token, sd["mask_decoder.iou_token.weight"])
        _copy(dec.mask_tokens, sd["mask_decoder.mask_tokens.weight"][:T])
        for j in range(T):
            pre = f"mask_decoder.output_hypernetworks_mlps.{j}.layers"
            for li in range(3):
                if f"{pre}.{li}.weight" not in sd:
                    break
                _copy(getattr(dec, f"hyper{j}_{li}").weight, sd[f"{pre}.{li}.weight"])
                _copy(getattr(dec, f"hyper{j}_{li}").bias, sd[f"{pre}.{li}.bias"])
        for li in range(3):
            key = f"mask_decoder.iou_prediction_head.layers.{li}"
            if f"{key}.weight" not in sd:
                break
            w, b = sd[f"{key}.weight"], sd[f"{key}.bias"]
            if li == 2:  # the last layer: the first T mask scores
                w, b = w[:T], b[:T]
            _copy(getattr(dec, f"iou_head_{li}").weight, w)
            _copy(getattr(dec, f"iou_head_{li}").bias, b)
        if "mask_decoder.output_upscaling.0.weight" in sd:
            up = "mask_decoder.output_upscaling"
            _copy(dec.upscale_conv1.weight, sd[f"{up}.0.weight"].flip(-2, -1))
            _copy(dec.upscale_conv1.bias, sd[f"{up}.0.bias"])
            _copy(dec.upscale_ln.weight, sd[f"{up}.1.weight"])
            _copy(dec.upscale_ln.bias, sd[f"{up}.1.bias"])
            _copy(dec.upscale_conv2.weight, sd[f"{up}.3.weight"].flip(-2, -1))
            _copy(dec.upscale_conv2.bias, sd[f"{up}.3.bias"])
    return model
