"""SAM's ViT image encoder (Segment-Anything `image_encoder.py` semantics),
NHWC, for running converted pretrained SAM checkpoints.

Counterpart of `equiadapt_tpu/models/sam_encoder.py`:

* patch embedding: a patch-size conv with bias;
* a learned 2-D absolute position embedding (1, h, w, C);
* pre-LN blocks (eps 1e-6): fused qkv, scaled dot-product attention with
  SAM's decomposed relative position biases (attn += q . R_h + q . R_w),
  an MLP lin1 -> exact GELU -> lin2;
* windowed attention (bottom / right zero pad to whole windows, then
  unpad) in every block but `global_attn_indexes`;
* the neck: 1x1 conv (no bias) -> LayerNorm2d -> 3x3 conv (no bias) ->
  LayerNorm2d (over channels, eps 1e-6; here the last axis).

Parameters are named after SAM's torch tree (`patch_embed.proj`,
`pos_embed`, `blocks.{i}.norm1` / `attn.qkv` / `attn.proj` /
`attn.rel_pos_h` / `attn.rel_pos_w` / `norm2` / `mlp.lin1` / `mlp.lin2`,
`neck.{0,1,2,3}`), so a SAM image-encoder state dict loads as it is
(`models.sam_convert.convert_sam_vit_encoder`). `flax_aliases` maps the
JAX package's Flax names (`patch_embed`, `block{i}`, `lin1`, `neck_conv1`,
...) onto them for `utils.jax_weights`.

Attention takes one of two paths (`ops.kernels.sam_attention.
attention_path`). A bf16 call on a card that needs no gradient (serving),
at a head width and grid the kernel takes, runs the fused CUDA kernel of
`ops.kernels.sam_attention`: scores, bias, softmax and the product with v
in one launch, reading q, k and v from the qkv output by strides and
writing the (B, HW, C) layout `proj` reads; no score reaches memory. Every
other call (fp32, the CPU, training, a shape the kernel has no plan for)
writes the attention out as products and a softmax, as the JAX package
does: a global block at 1024 px holds (B, heads, 4096, 4096) scores, the
bias added to them in place. Both take the bias tables from the same two
einsums of the unscaled q.

`dtype` is the computation's dtype (fp32 by default, as in the JAX
package). Parameters stay fp32: under dtype=bfloat16 the linears,
convolutions, LayerNorms, position embedding and relative-position tables
are cast per call, the products accumulate in fp32, and the LayerNorms and
the softmax keep their statistics in fp32 over bf16 activations.

Spans (`utils.profiling.annotate`): `sam/encoder` around the forward, with
`sam/attn/window` (a windowed block's attention, from partition to
unpartition), `sam/attn/global` (a global block's attention, its bias
included) and `sam/neck` inside it. The counter `sam/attn_score_elems`
adds the score elements each written-out attention call materializes, from
the shapes (0 on the fused path, whose launches `counters()` gives as
`paths/sam_attention/<dtype>/{global,window}`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from equiadapt_tpu_torch.common.layers import CastConv2d, CastLayerNorm, CastLinear
from equiadapt_tpu_torch.ops.kernels import sam_attention
from equiadapt_tpu_torch.ops.warp import resize
from equiadapt_tpu_torch.utils.profiling import annotate, count

Tensor = torch.Tensor

__all__ = ["SamVitEncoder", "sam_vit_b_encoder_kwargs"]


def sam_vit_b_encoder_kwargs() -> dict:
    """Constructor kwargs matching the sam_vit_b checkpoint."""
    return dict(
        img_size=1024, patch_size=16, embed_dim=768, depth=12, num_heads=12,
        out_chans=256, window_size=14, global_attn_indexes=(2, 5, 8, 11),
    )


def _window_partition(x: Tensor, ws: int) -> Tuple[Tensor, Tuple[int, int]]:
    """(B, H, W, C) -> (B * windows, ws, ws, C), zero-padding the bottom and
    right to whole windows."""
    B, H, W, C = x.shape
    pad_h = (ws - H % ws) % ws
    pad_w = (ws - W % ws) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C), (Hp, Wp)


def _window_unpartition(win: Tensor, ws: int, pad_hw: Tuple[int, int],
                        hw: Tuple[int, int]) -> Tensor:
    Hp, Wp = pad_hw
    H, W = hw
    B = win.shape[0] // (Hp * Wp // ws // ws)
    x = win.reshape(B, Hp // ws, Wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W, :]


def _rel_pos_table(q_size: int, k_size: int, rel_pos: Tensor) -> Tensor:
    """SAM's get_rel_pos: a (2 max(q, k) - 1, hd) table -> the (q, k, hd)
    biases, table[i - j + k - 1] at equal sizes. A table of another length
    is first resized along its length (linear, antialiased when it
    shrinks: `jax.image.resize`'s "linear")."""
    max_rel = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel:
        rel_pos = resize(rel_pos[None, :, :, None],
                         (max_rel, rel_pos.shape[1]))[0, :, :, 0]
    qi = torch.arange(q_size, device=rel_pos.device)[:, None] * max(k_size / q_size, 1.0)
    ki = torch.arange(k_size, device=rel_pos.device)[None, :] * max(q_size / k_size, 1.0)
    coords = (qi - ki + (k_size - 1) * max(q_size / k_size, 1.0)).long()
    return rel_pos[coords]


class SamAttention(nn.Module):
    """Multi-head attention with decomposed relative position biases over a
    (B, H, W, C) token grid (a window, or the whole grid). With
    use_rel_pos=False it has no `rel_pos_*` tables and adds no bias."""

    def __init__(self, dim: int, num_heads: int, input_size: Tuple[int, int],
                 use_rel_pos: bool = True, device="cuda"):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = hd = dim // num_heads
        self.use_rel_pos = use_rel_pos
        self.qkv = CastLinear(dim, 3 * dim, device=device)
        self.proj = CastLinear(dim, dim, device=device)
        if use_rel_pos:
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd,
                                                      device=device))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd,
                                                      device=device))

    def forward(self, x: Tensor) -> Tensor:
        B, H, W, C = x.shape
        return self.proj(self._attend(x)).reshape(B, H, W, C)

    def _rel_pos(self) -> Tuple[Tensor, Tensor]:
        return self.rel_pos_h, self.rel_pos_w

    def _attend(self, x: Tensor) -> Tensor:
        """The heads' outputs before `proj`, (B, H * W, heads * head_dim):
        the fused kernel or the scores written out (`attention_path`)."""
        B, H, W, C = x.shape
        nh, hd = self.num_heads, self.head_dim
        qkv = self.qkv(x.reshape(B, H * W, C)).reshape(B, H * W, 3, nh, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # (B, nh, HW, hd) views
        bias_h = bias_w = None
        if self.use_rel_pos:
            rel_h, rel_w = self._rel_pos()
            Rh = _rel_pos_table(H, H, rel_h).to(q.dtype)  # (H, H, hd)
            Rw = _rel_pos_table(W, W, rel_w).to(q.dtype)  # (W, W, hd)
            r_q = q.reshape(B, nh, H, W, hd)
            bias_h = torch.einsum("bnhwc,hkc->bnhwk", r_q, Rh)
            bias_w = torch.einsum("bnhwc,wkc->bnhwk", r_q, Rw)
        path = sam_attention.attention_path(
            qkv.device, qkv.dtype, sam_attention.needs_grad(qkv, bias_h, bias_w), hd, H, W)
        if path == "fused":
            tables = (None, None) if bias_h is None else (
                bias_h.reshape(B, nh, H * W, H), bias_w.reshape(B, nh, H * W, W))
            return sam_attention.sam_attention(*qkv.unbind(2), *tables, H, W)
        count("sam/attn_score_elems", B * nh * (H * W) ** 2)
        attn = (q * hd ** -0.5) @ k.transpose(-2, -1)  # (B, nh, HW, HW)
        if bias_h is not None:
            # in place, in the JAX package's order: no backward reads the
            # product, and a global block's scores are the largest tensor here
            attn.view(B, nh, H, W, H, W).add_(bias_h[..., :, None]).add_(
                bias_w[..., None, :])
        attn = torch.softmax(attn, dim=-1)
        return (attn @ v).transpose(1, 2).reshape(B, H * W, nh * hd)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device="cuda"):
        super().__init__()
        self.lin1 = CastLinear(dim, hidden, device=device)
        self.lin2 = CastLinear(hidden, dim, device=device)

    def forward(self, x: Tensor) -> Tensor:
        return self.lin2(F.gelu(self.lin1(x)))  # exact (erf) GELU


class SamBlock(nn.Module):
    """Pre-LN block; window_size 0 attends globally over `input_size`."""

    flax_aliases = {"lin1": "mlp.lin1", "lin2": "mlp.lin2"}

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 window_size: int = 0, input_size: Tuple[int, int] = (64, 64),
                 device="cuda"):
        super().__init__()
        self.window_size = window_size
        self.norm1 = CastLayerNorm(dim, eps=1e-6, device=device)
        self.attn = SamAttention(
            dim, num_heads,
            (window_size, window_size) if window_size > 0 else input_size,
            device=device)
        self.norm2 = CastLayerNorm(dim, eps=1e-6, device=device)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio), device=device)

    def forward(self, x: Tensor) -> Tensor:
        shortcut = x
        x = self.norm1(x)
        ws = self.window_size
        if ws > 0:
            with annotate("sam/attn/window"):
                hw = (x.shape[1], x.shape[2])
                x, pad_hw = _window_partition(x, ws)
                x = _window_unpartition(self.attn(x), ws, pad_hw, hw)
        else:
            with annotate("sam/attn/global"):
                x = self.attn(x)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class SamVitEncoder(nn.Module):
    """SAM's ViT image encoder: (B, S, S, 3) -> (B, S / p, S / p, out_chans),
    computing in `dtype` (module docstring)."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 out_chans: int = 256, window_size: int = 14,
                 global_attn_indexes: Sequence[int] = (2, 5, 8, 11),
                 mlp_ratio: float = 4.0, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        p = patch_size
        h = img_size // p
        self.dtype = dtype
        self.patch_embed = nn.Module()
        self.patch_embed.proj = CastConv2d(3, embed_dim, p, stride=p, device=device)
        self.pos_embed = nn.Parameter(0.02 * torch.randn(1, h, h, embed_dim,
                                                         device=device))
        self.blocks = nn.ModuleList([
            SamBlock(embed_dim, num_heads, mlp_ratio,
                     0 if i in tuple(global_attn_indexes) else window_size,
                     (h, h), device=device)
            for i in range(depth)])
        self.neck = nn.Sequential(
            CastConv2d(embed_dim, out_chans, 1, bias=False, device=device),
            CastLayerNorm(out_chans, eps=1e-6, device=device),
            CastConv2d(out_chans, out_chans, 3, padding=1, bias=False, device=device),
            CastLayerNorm(out_chans, eps=1e-6, device=device))
        self.flax_aliases = {
            "patch_embed": "patch_embed.proj", "neck_conv1": "neck.0",
            "neck_ln1": "neck.1", "neck_conv2": "neck.2", "neck_ln2": "neck.3",
            **{f"block{i}": f"blocks.{i}" for i in range(depth)}}

    def forward(self, x: Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        with annotate("sam/encoder"):
            x = x.to(self.dtype).permute(0, 3, 1, 2)
            x = self.patch_embed.proj(x).permute(0, 2, 3, 1)
            x = x + self.pos_embed.to(x.dtype)
            for block in self.blocks:
                x = block(x)
            with annotate("sam/neck"):
                conv1, ln1, conv2, ln2 = self.neck
                x = ln1(conv1(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
                return ln2(conv2(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
