"""Plain reference of the `sam-vitb-c4` configuration.

A C4 group-equivariant energy network (equiadapt's published segmentation
canonicalizer: a lifting convolution whose filter is turned to the four
quarter turns, then `num_layers - 1` group convolutions whose filters are
turned and whose fiber is rolled by the element, fiber BatchNorm and ReLU
between, no padding; the mean over channels and space) on the
centre-cropped, resized image picks an element of C4 by argmax. The image
is turned back by it (an exact quarter turn), and so are the box prompts
(their corners turned about the image centre, then re-aligned). Segment
Anything (Kirillov et al. 2023, `segment_anything/build_sam.py`,
`build_sam_vit_b`) segments the canonical image from the canonical boxes:

* the ViT image encoder: a patch convolution, an absolute position
  embedding, pre-LN blocks (eps 1e-6) whose attention adds SAM's
  decomposed relative-position bias to the scores (`attn += q R_h + q R_w`,
  q unscaled), windowed (zero-padded bottom and right to whole windows)
  except in the global blocks, an exact-GELU MLP; the neck (1 x 1 and 3 x 3
  convolutions, each with a channel LayerNorm);
* the prompt encoder's box path: corners `box + 0.5` over (W, H), `2c - 1`,
  `@ G`, `2 pi`, `[sin, cos]`, plus the corner embeddings; the dense
  embedding `no_mask_embed`; the grid's position encoding at its cell
  centres;
* the mask decoder with `multimask_output=False`: the two-way transformer
  (token self-attention, tokens to image, a ReLU MLP, image to tokens;
  the cross-attentions at half width; LayerNorm eps 1e-5), the final token
  to image attention, the output upscaling (two transposed convolutions, a
  channel LayerNorm eps 1e-6, exact GELU), the first mask token's
  hypernetwork and the IoU head.

The low-resolution masks are upsampled bilinearly (half-pixel centres) to
the image and turned back to the input frame by the element. SAM runs one
image at a time, so that a global block's fp32 scores fit.

`follow` makes the reference take the program's element (degrees);
`element_gaps` holds the program's energies to the reference's. `faults`
plants a defect in the reference: "no_rel_pos" drops the relative-position
bias, "windowed_global" windows the global blocks.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.common import (
    FP32,
    Precision,
    Weights,
    batch_norm,
    bn_spec,
    crop_and_resize,
    rotation_tap_matrix,
)

Tensor = torch.Tensor

NET = "canonicalizer.canonicalization_network"
PRED = "prediction_network"
LIFT = f"{NET}.RotationEquivariantConvLift_0"
ENC = f"{PRED}.image_encoder"
PROMPT = f"{PRED}.prompt_encoder"
DEC = f"{PRED}.mask_decoder"
REL_POS_STD = 0.1  # q R's spread about 0.8 against the scores' 1.0: the bias moves the softmax


def _hp(settings: dict) -> dict:
    return settings["canonicalization"]["network_hyperparams"]


def _sam(settings: dict) -> dict:
    return settings["sam"]


def _normal(std: float) -> str:
    return f"normal:{std!r}"


def _linear_spec(prefix: str, d_out: int, d_in: int) -> List[Tuple[str, tuple, str]]:
    return [(f"{prefix}.weight", (d_out, d_in), "fan_in"), (f"{prefix}.bias", (d_out,), "small")]


def _ln_spec(prefix: str, ch: int) -> List[Tuple[str, tuple, str]]:
    return [(f"{prefix}.weight", (ch,), "bn_weight"), (f"{prefix}.bias", (ch,), "bn_bias")]


def _gcnn_spec(settings: dict) -> List[Tuple[str, tuple, str]]:
    h = _hp(settings)
    K, C, G, L = h["kernel_size"], h["out_channels"], h["num_rotations"], h["num_layers"]
    if h["group_type"] != "rotation" or L < 2:
        raise ValueError("the reference is written for two or more layers of C_n")
    ci = settings["dataset"]["in_channels"]
    spec = [(f"{LIFT}.weights", (K, K, ci, C), _normal(math.sqrt(2.0 / (K * K * ci)))),
            (f"{LIFT}.bias", (C,), "small")]
    for i in range(L - 1):
        spec += bn_spec(f"{NET}.FiberBatchNorm_{i}.BatchNorm_0", C)
        spec += [(f"{NET}.RotationEquivariantConv_{i}.weights", (K, K, C, G, C),
                  _normal(math.sqrt(2.0 / (K * K * C * G)))),
                 (f"{NET}.RotationEquivariantConv_{i}.bias", (C,), "small")]
    return spec


def _attention_spec(prefix: str, dim: int, inner: int) -> List[Tuple[str, tuple, str]]:
    spec = []
    for name in ("q_proj", "k_proj", "v_proj"):
        spec += _linear_spec(f"{prefix}.{name}", inner, dim)
    return spec + _linear_spec(f"{prefix}.out_proj", dim, inner)


def _mlp_spec(prefix: str, dims: Sequence[int]) -> List[Tuple[str, tuple, str]]:
    spec = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        spec += _linear_spec(f"{prefix}.layers.{i}", b, a)
    return spec


def _sam_spec(settings: dict) -> List[Tuple[str, tuple, str]]:
    s, size = _sam(settings), settings["dataset"]["image_size"]
    e = s["encoder"]
    p, D, nh, ws = e["patch_size"], e["embed_dim"], e["num_heads"], e["window_size"]
    g, hd, P = size // p, e["embed_dim"] // e["num_heads"], s["prompt_dim"]
    mlp = int(D * e["mlp_ratio"])
    spec = [(f"{ENC}.pos_embed", (1, g, g, D), "normal:0.02"),
            (f"{ENC}.patch_embed.proj.weight", (D, 3, p, p), "he"),
            (f"{ENC}.patch_embed.proj.bias", (D,), "small")]
    for i in range(e["depth"]):
        b = f"{ENC}.blocks.{i}"
        side = g if i in e["global_attn_indexes"] else ws
        spec += _ln_spec(f"{b}.norm1", D)
        spec += _linear_spec(f"{b}.attn.qkv", 3 * D, D) + _linear_spec(f"{b}.attn.proj", D, D)
        spec += [(f"{b}.attn.rel_pos_h", (2 * side - 1, hd), _normal(REL_POS_STD)),
                 (f"{b}.attn.rel_pos_w", (2 * side - 1, hd), _normal(REL_POS_STD))]
        spec += _ln_spec(f"{b}.norm2", D)
        spec += _linear_spec(f"{b}.mlp.lin1", mlp, D) + _linear_spec(f"{b}.mlp.lin2", D, mlp)
    spec += [(f"{ENC}.neck.0.weight", (P, D, 1, 1), "he")] + _ln_spec(f"{ENC}.neck.1", P)
    spec += [(f"{ENC}.neck.2.weight", (P, P, 3, 3), "he")] + _ln_spec(f"{ENC}.neck.3", P)
    # the prompt encoder (point and mask leaves held for the checkpoint, unread)
    spec += [(f"{PROMPT}.pe_layer.positional_encoding_gaussian_matrix", (2, P // 2),
              "normal:1.0")]
    spec += [(f"{PROMPT}.point_embeddings.{j}.weight", (1, P), "normal:1.0") for j in range(4)]
    spec += [(f"{PROMPT}.not_a_point_embed.weight", (1, P), "normal:1.0")]
    md = f"{PROMPT}.mask_downscaling"
    spec += [(f"{md}.0.weight", (4, 1, 2, 2), "he"), (f"{md}.0.bias", (4,), "small")]
    spec += _ln_spec(f"{md}.1", 4)
    spec += [(f"{md}.3.weight", (16, 4, 2, 2), "he"), (f"{md}.3.bias", (16,), "small")]
    spec += _ln_spec(f"{md}.4", 16)
    spec += [(f"{md}.6.weight", (P, 16, 1, 1), "he"), (f"{md}.6.bias", (P,), "small")]
    spec += [(f"{PROMPT}.no_mask_embed.weight", (1, P), "normal:1.0")]
    # the mask decoder
    inner, M, T = P // 2, s["decoder_mlp"], s["num_mask_tokens"]
    tr = f"{DEC}.transformer"
    for i in range(s["decoder_depth"]):
        lp = f"{tr}.layers.{i}"
        spec += _attention_spec(f"{lp}.self_attn", P, P) + _ln_spec(f"{lp}.norm1", P)
        spec += _attention_spec(f"{lp}.cross_attn_token_to_image", P, inner)
        spec += _ln_spec(f"{lp}.norm2", P)
        spec += _linear_spec(f"{lp}.mlp.lin1", M, P) + _linear_spec(f"{lp}.mlp.lin2", P, M)
        spec += _ln_spec(f"{lp}.norm3", P) + _ln_spec(f"{lp}.norm4", P)
        spec += _attention_spec(f"{lp}.cross_attn_image_to_token", P, inner)
    spec += _attention_spec(f"{tr}.final_attn_token_to_image", P, inner)
    spec += _ln_spec(f"{tr}.norm_final_attn", P)
    spec += [(f"{DEC}.iou_token.weight", (1, P), "normal:1.0"),
             (f"{DEC}.mask_tokens.weight", (T, P), "normal:1.0")]
    up = f"{DEC}.output_upscaling"
    spec += [(f"{up}.0.weight", (P, P // 4, 2, 2), _normal(math.sqrt(1.0 / P))),
             (f"{up}.0.bias", (P // 4,), "small")]
    spec += _ln_spec(f"{up}.1", P // 4)
    spec += [(f"{up}.3.weight", (P // 4, P // 8, 2, 2), _normal(math.sqrt(4.0 / P))),
             (f"{up}.3.bias", (P // 8,), "small")]
    for t in range(T):
        spec += _mlp_spec(f"{DEC}.output_hypernetworks_mlps.{t}", (P, P, P, P // 8))
    spec += _mlp_spec(f"{DEC}.iou_prediction_head",
                      (P, s["iou_hidden"], s["iou_hidden"], T))
    return spec


def param_spec(settings: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every weight and statistic, in order: the
    GCNN's, then SAM's under the names of its torch tree."""
    return _gcnn_spec(settings) + _sam_spec(settings)


# ---------------------------------------------------------------- the GCNN

def _taps(K: int, G: int, device) -> Tensor:
    return torch.from_numpy(rotation_tap_matrix(K, [360.0 * g / G for g in range(G)])
                            ).to(device)


def _lift_bank(w: Weights, K: int, G: int, device) -> Tensor:
    """Out channel c * G + g is the lifting filter c turned by g."""
    wl = w[f"{LIFT}.weights"]  # (K, K, Ci, C)
    ci, C = wl.shape[2], wl.shape[3]
    rot = torch.einsum("gpq,qf->gpf", _taps(K, G, device), wl.reshape(K * K, ci * C))
    return rot.reshape(G, K, K, ci, C).permute(4, 0, 3, 1, 2).reshape(C * G, ci, K, K)


def _group_bank(wg: Tensor, K: int, G: int, device) -> Tensor:
    """Output element j reads input fiber k through the filter of fiber
    (k - j) mod G, turned by j."""
    C = wg.shape[2]
    j = torch.arange(G, device=device)
    perm = (j[None, :] - j[:, None]) % G  # [j, k]
    wp = wg[:, :, :, perm, :].permute(3, 0, 1, 2, 4, 5).reshape(G, K * K, C * G * C)
    rot = torch.einsum("gpq,gqf->gpf", _taps(K, G, device), wp).reshape(G, K, K, C, G, C)
    return rot.permute(5, 0, 3, 4, 1, 2).reshape(C * G, C * G, K, K)


def energy_map(w: Weights, x: Tensor, settings: dict, prec: Precision = FP32) -> Tensor:
    """(B, C * G, H', W') output of the last group convolution, whose mean
    over channels and space is the energies, of NHWC images."""
    h = _hp(settings)
    K, C, G, L = h["kernel_size"], h["out_channels"], h["num_rotations"], h["num_layers"]
    cfg = settings["canonicalization"]
    z = crop_and_resize(x, cfg["input_crop_ratio"], cfg["resize_shape"]).permute(0, 3, 1, 2)
    y = prec.conv(z, _lift_bank(w, K, G, x.device))
    y = y + w[f"{LIFT}.bias"].repeat_interleave(G)[None, :, None, None]
    for i in range(L - 1):
        B, _, Hh, Ww = y.shape
        bn = batch_norm(y.reshape(B, C, G * Hh, Ww), w, f"{NET}.FiberBatchNorm_{i}.BatchNorm_0",
                        False)
        y = torch.relu(prec(bn.reshape(B, C * G, Hh, Ww)))
        gc = f"{NET}.RotationEquivariantConv_{i}"
        y = prec.conv(y, _group_bank(w[f"{gc}.weights"], K, G, x.device))
        y = y + w[f"{gc}.bias"].repeat_interleave(G)[None, :, None, None]
    return y


def _fiber_mean(y: Tensor, G: int) -> Tensor:
    return y.reshape(y.shape[0], -1, G, y.shape[2] * y.shape[3]).mean(dim=(1, 3))


def turn_boxes(boxes: Tensor, quarter_turns: Tensor, width: int) -> Tensor:
    """(B, N, 4) xyxy boxes turned by quarter_turns[b] x 90 degrees about
    the image centre (x, y) -> (c - (y - c), c + (x - c)) per turn, the two
    corners re-aligned by min and max: the boxes of an image turned back by
    `torch.rot90(x, -quarter_turns, dims=(1, 2))`."""
    c = width / 2.0
    x1, y1, x2, y2 = boxes.unbind(-1)
    pts = [(x1 - c, y1 - c), (x2 - c, y2 - c)]
    out = []
    for b in range(boxes.shape[0]):
        (ax, ay), (bx, by) = [(px[b], py[b]) for px, py in pts]
        for _ in range(int(quarter_turns[b]) % 4):
            ax, ay, bx, by = -ay, ax, -by, bx
        out.append(torch.stack([torch.minimum(ax, bx) + c, torch.minimum(ay, by) + c,
                                torch.maximum(ax, bx) + c, torch.maximum(ay, by) + c], -1))
    return torch.stack(out)


# ---------------------------------------------------------------- SAM

def _ln(x: Tensor, w: Weights, prefix: str, eps: float) -> Tensor:
    return F.layer_norm(x, x.shape[-1:], w[f"{prefix}.weight"], w[f"{prefix}.bias"], eps)


def _lin(prec: Precision, x: Tensor, w: Weights, prefix: str) -> Tensor:
    return prec.linear(x, w[f"{prefix}.weight"], w[f"{prefix}.bias"])


def rel_pos_table(q_size: int, k_size: int, table: Tensor) -> Tensor:
    """SAM's `get_rel_pos`: the (q, k, hd) biases of a (L, hd) table, a table
    of another length first resized along it (linear)."""
    max_rel = 2 * max(q_size, k_size) - 1
    if table.shape[0] != max_rel:
        table = F.interpolate(table.t()[None], size=max_rel, mode="linear")[0].t()
    qc = torch.arange(q_size, device=table.device)[:, None] * max(k_size / q_size, 1.0)
    kc = torch.arange(k_size, device=table.device)[None, :] * max(q_size / k_size, 1.0)
    return table[(qc - kc + (k_size - 1) * max(q_size / k_size, 1.0)).long()]


def attend(q: Tensor, k: Tensor, v: Tensor, Rh: Optional[Tensor], Rw: Optional[Tensor],
           H: int, W: int, prec: Precision = FP32) -> Tensor:
    """One attention call over an H x W grid: the scores q k^T / sqrt(hd),
    SAM's decomposed bias (q R_h, q R_w; none where Rh is None), the
    softmax, the product with v. q, k, v: (b, heads, HW, hd)."""
    b, nh, n, hd = q.shape
    attn = prec(torch.matmul(prec(q * hd ** -0.5), prec(k).transpose(-2, -1)))
    if Rh is not None:
        rq = prec(q).reshape(b, nh, H, W, hd)
        bias_h = prec(torch.einsum("bnhwc,hkc->bnhwk", rq, prec(Rh)))
        bias_w = prec(torch.einsum("bnhwc,wkc->bnhwk", rq, prec(Rw)))
        attn = prec((attn.reshape(b, nh, H, W, H, W) + bias_h[..., :, None]
                     + bias_w[..., None, :]).reshape(b, nh, n, n))
    attn = prec(torch.softmax(attn, dim=-1))
    return prec(torch.matmul(attn, prec(v)))


def _encoder_attention(w: Weights, x: Tensor, prefix: str, heads: int, rel_pos: bool,
                       prec: Precision) -> Tensor:
    b, H, W, C = x.shape
    qkv = _lin(prec, x.reshape(b, H * W, C), w, f"{prefix}.qkv")
    qkv = qkv.reshape(b, H * W, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
    Rh = rel_pos_table(H, H, w[f"{prefix}.rel_pos_h"]) if rel_pos else None
    Rw = rel_pos_table(W, W, w[f"{prefix}.rel_pos_w"]) if rel_pos else None
    out = attend(qkv[0], qkv[1], qkv[2], Rh, Rw, H, W, prec)
    out = out.transpose(1, 2).reshape(b, H * W, C)
    return _lin(prec, out, w, f"{prefix}.proj").reshape(b, H, W, C)


def _windows(x: Tensor, ws: int) -> Tuple[Tensor, Tuple[int, int]]:
    B, H, W, C = x.shape
    ph, pw = (ws - H % ws) % ws, (ws - W % ws) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, C), (Hp, Wp)


def _unwindows(x: Tensor, ws: int, pad_hw: Tuple[int, int], hw: Tuple[int, int]) -> Tensor:
    Hp, Wp = pad_hw
    B = x.shape[0] // (Hp * Wp // ws // ws)
    x = x.reshape(B, Hp // ws, Wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hp, Wp, -1)[:, :hw[0], :hw[1], :]


def _conv_nhwc(prec: Precision, x: Tensor, weight: Tensor, padding: int = 0) -> Tensor:
    return prec.conv(x.permute(0, 3, 1, 2), weight, 1, padding).permute(0, 2, 3, 1)


def block(w: Weights, h: Tensor, i: int, settings: dict, prec: Precision = FP32,
          faults: Sequence[str] = ()) -> Tensor:
    """Encoder block i of the (b, g, g, D) token grid: windowed attention
    (global in the global blocks) and the MLP, each pre-LN and residual."""
    e = _sam(settings)["encoder"]
    b = f"{ENC}.blocks.{i}"
    ws = e["window_size"]
    if i in e["global_attn_indexes"] and "windowed_global" not in faults:
        ws = 0
    t = prec(_ln(h, w, f"{b}.norm1", 1e-6))
    if ws:
        hw = t.shape[1:3]
        t, pad_hw = _windows(t, ws)
    t = _encoder_attention(w, t, f"{b}.attn", e["num_heads"], "no_rel_pos" not in faults, prec)
    if ws:
        t = _unwindows(t, ws, pad_hw, hw)
    h = prec(h + t)
    m = F.gelu(_lin(prec, prec(_ln(h, w, f"{b}.norm2", 1e-6)), w, f"{b}.mlp.lin1"))
    return prec(h + _lin(prec, prec(m), w, f"{b}.mlp.lin2"))


def encode(w: Weights, x: Tensor, settings: dict, prec: Precision = FP32,
           faults: Sequence[str] = ()) -> Tensor:
    """SAM's image embedding (b, g, g, prompt_dim) of NHWC images."""
    e = _sam(settings)["encoder"]
    p = e["patch_size"]
    h = prec(F.conv2d(prec(x.permute(0, 3, 1, 2)), prec(w[f"{ENC}.patch_embed.proj.weight"]),
                      w[f"{ENC}.patch_embed.proj.bias"], stride=p)).permute(0, 2, 3, 1)
    h = prec(h + w[f"{ENC}.pos_embed"])
    for i in range(e["depth"]):
        h = block(w, h, i, settings, prec, faults)
    h = prec(_ln(_conv_nhwc(prec, h, w[f"{ENC}.neck.0.weight"]), w, f"{ENC}.neck.1", 1e-6))
    return prec(_ln(_conv_nhwc(prec, h, w[f"{ENC}.neck.2.weight"], 1), w, f"{ENC}.neck.3",
                    1e-6))


def _fourier(w: Weights, xy: Tensor) -> Tensor:
    proj = 2.0 * math.pi * ((2.0 * xy - 1.0)
                            @ w[f"{PROMPT}.pe_layer.positional_encoding_gaussian_matrix"])
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def prompt_tokens(w: Weights, boxes: Tensor, size: int) -> Tensor:
    """(N, 2, C) corner tokens of (N, 4) boxes in a size x size image."""
    corners = (boxes + 0.5).reshape(-1, 2, 2) / size
    emb = _fourier(w, corners)
    return torch.stack([emb[:, 0] + w[f"{PROMPT}.point_embeddings.2.weight"][0],
                        emb[:, 1] + w[f"{PROMPT}.point_embeddings.3.weight"][0]], dim=1)


def grid_pe(w: Weights, g: int, device) -> Tensor:
    """(g * g, C): the encoding of the grid's cell centres, row-major."""
    c = (torch.arange(g, dtype=torch.float32, device=device) + 0.5) / g
    yy, xx = torch.meshgrid(c, c, indexing="ij")
    return _fourier(w, torch.stack([xx, yy], dim=-1)).reshape(g * g, -1)


def _dec_attention(w: Weights, prefix: str, q: Tensor, k: Tensor, v: Tensor, heads: int,
                   prec: Precision) -> Tensor:
    def split(t):
        n, L, c = t.shape
        return t.reshape(n, L, heads, c // heads).transpose(1, 2)

    qh = split(_lin(prec, q, w, f"{prefix}.q_proj"))
    kh = split(_lin(prec, k, w, f"{prefix}.k_proj"))
    vh = split(_lin(prec, v, w, f"{prefix}.v_proj"))
    out = attend(qh, kh, vh, None, None, 0, 0, prec)
    n, _, L, d = out.shape
    return _lin(prec, out.transpose(1, 2).reshape(n, L, heads * d), w, f"{prefix}.out_proj")


def _mlp(w: Weights, prefix: str, x: Tensor, layers: int, prec: Precision) -> Tensor:
    for i in range(layers):
        x = _lin(prec, x, w, f"{prefix}.layers.{i}")
        if i < layers - 1:
            x = torch.relu(x)
    return x


def _ln2d(x: Tensor, w: Weights, prefix: str) -> Tensor:
    return _ln(x.permute(0, 2, 3, 1), w, prefix, 1e-6).permute(0, 3, 1, 2)


def two_way(w: Weights, pe_tok: Tensor, src: Tensor, pe_img: Tensor, settings: dict,
            prec: Precision = FP32) -> Tuple[Tensor, Tensor]:
    """SAM's two-way transformer: tokens (N, T, C), which are also their
    position encoding, the image (N, HW, C) and its position encoding
    (N, HW, C) -> (tokens, image)."""
    s = _sam(settings)
    heads, tr = s["decoder_heads"], f"{DEC}.transformer"
    q, k = pe_tok, src
    for i in range(s["decoder_depth"]):
        lp = f"{tr}.layers.{i}"
        if i == 0:
            q = _dec_attention(w, f"{lp}.self_attn", q, q, q, heads, prec)
        else:
            qq = prec(q + pe_tok)
            q = prec(q + _dec_attention(w, f"{lp}.self_attn", qq, qq, q, heads, prec))
        q = prec(_ln(q, w, f"{lp}.norm1", 1e-5))
        kk = prec(k + pe_img)
        a = _dec_attention(w, f"{lp}.cross_attn_token_to_image", prec(q + pe_tok), kk, k,
                           heads, prec)
        q = prec(_ln(prec(q + a), w, f"{lp}.norm2", 1e-5))
        m = _lin(prec, torch.relu(_lin(prec, q, w, f"{lp}.mlp.lin1")), w, f"{lp}.mlp.lin2")
        q = prec(_ln(prec(q + m), w, f"{lp}.norm3", 1e-5))
        a = _dec_attention(w, f"{lp}.cross_attn_image_to_token", kk, prec(q + pe_tok), q,
                           heads, prec)
        k = prec(_ln(prec(k + a), w, f"{lp}.norm4", 1e-5))
    a = _dec_attention(w, f"{tr}.final_attn_token_to_image", prec(q + pe_tok),
                       prec(k + pe_img), k, heads, prec)
    return prec(_ln(prec(q + a), w, f"{tr}.norm_final_attn", 1e-5)), k


def decode(w: Weights, emb: Tensor, tokens: Tensor, settings: dict,
           prec: Precision = FP32) -> Tuple[Tensor, Tensor]:
    """One image's embedding (g, g, C) and its prompts' corner tokens
    (N, 2, C) -> low-resolution mask logits (N, 4g, 4g) and IoU (N,)."""
    g, C, N = emb.shape[0], emb.shape[-1], tokens.shape[0]
    out_tok = torch.cat([w[f"{DEC}.iou_token.weight"], w[f"{DEC}.mask_tokens.weight"]], 0)
    pe_tok = prec(torch.cat([out_tok[None].expand(N, -1, -1), tokens], dim=1))
    src = prec(emb.reshape(1, g * g, C) + w[f"{PROMPT}.no_mask_embed.weight"]).expand(N, -1, -1)
    pe_img = prec(grid_pe(w, g, emb.device))[None].expand(N, -1, -1)
    q, k = two_way(w, pe_tok, src, pe_img, settings, prec)
    up = f"{DEC}.output_upscaling"
    x = k.transpose(1, 2).reshape(N, C, g, g)
    x = prec(F.conv_transpose2d(prec(x), prec(w[f"{up}.0.weight"]), w[f"{up}.0.bias"], 2))
    x = prec(F.gelu(_ln2d(x, w, f"{up}.1")))
    x = prec(F.conv_transpose2d(x, prec(w[f"{up}.3.weight"]), w[f"{up}.3.bias"], 2))
    x = prec(F.gelu(x))
    hyper = prec(_mlp(w, f"{DEC}.output_hypernetworks_mlps.0", q[:, 1], 3, prec))
    masks = prec(torch.einsum("nc,nchw->nhw", hyper, x))
    iou = _mlp(w, f"{DEC}.iou_prediction_head", q[:, 0], 3, prec)[:, 0]
    return masks, iou


def segment(w: Weights, image: Tensor, boxes: Tensor, settings: dict,
            prec: Precision = FP32, faults: Sequence[str] = ()) -> Tuple[Tensor, Tensor]:
    """One canonical NHWC image (1, S, S, 3) and its canonical boxes (N, 4)
    -> mask logits (N, S, S) and IoU (N,)."""
    S = image.shape[1]
    emb = encode(w, image, settings, prec, faults)[0]
    low, iou = decode(w, emb, prompt_tokens(w, boxes.float(), S), settings, prec)
    masks = F.interpolate(low[None].float(), size=(S, S), mode="bilinear",
                          align_corners=False)[0]
    return masks, iou


def serve(w: Weights, x: Tensor, boxes: Tensor, settings: dict,
          follow: Optional[Tensor] = None, prec: Precision = FP32,
          faults: Sequence[str] = ()) -> Dict[str, Tensor]:
    """Eval of one batch of NHWC images (B, S, S, 3) and their box prompts
    (B, N, 4): energies, their scale (the root mean square of the values
    they are means of), the element in degrees (its own argmax, or
    `follow`, the program's), the canonical image, the input-frame mask
    logits (B, N, S, S) and the IoU predictions (B, N). Under a lower
    precision the images are rounded to it first."""
    G = _hp(settings)["num_rotations"]
    S = x.shape[1]
    x = prec(x)
    y = energy_map(w, x, settings, prec)
    scale = y.float().pow(2).mean().sqrt()
    e = prec(_fiber_mean(y, G))
    del y
    if follow is None:
        idx = torch.argmax(e, dim=-1).cpu()
    else:  # on the host, so that meta tensors can follow an element
        idx = torch.round(follow.cpu().float() / (360.0 / G)).long() % G
    if G != 4:
        raise ValueError("the reference is written for C4")
    xc = torch.stack([torch.rot90(x[b], -int(idx[b]), dims=(0, 1))
                      for b in range(x.shape[0])])
    bc = turn_boxes(boxes.to(x.device), idx, S)
    masks, ious = [], []
    for b in range(x.shape[0]):
        m, iou = segment(w, xc[b:b + 1], bc[b], settings, prec, faults)
        masks.append(torch.rot90(m, int(idx[b]), dims=(1, 2)))
        ious.append(iou)
    return {"energies": e, "energy_scale": scale, "element": idx.float() * (360.0 / G),
            "canonical": xc, "masks": torch.stack(masks), "iou": torch.stack(ious)}


def global_attention_inputs(settings: dict, batch: int, device) -> tuple:
    """The arguments of `attend` for one global block of a batch: q, k, v
    (batch, heads, g * g, hd), the two (g, g, hd) bias tables, g, g."""
    e, size = _sam(settings)["encoder"], settings["dataset"]["image_size"]
    g, nh = size // e["patch_size"], e["num_heads"]
    hd = e["embed_dim"] // nh
    q, k, v = (torch.empty(batch, nh, g * g, hd, device=device) for _ in range(3))
    R = torch.empty(g, g, hd, device=device)
    return q, k, v, R, R, g, g


def element_gaps(out: Dict[str, Tensor], follow: Tensor,
                 energies: Optional[Tensor]) -> Dict[str, float]:
    """`energy_err`: the root mean square of the program's energies (B, G)
    less the reference's, over the energies' scale (the root mean square of
    the values they are means of). The element is their argmax; `follow`
    is not read."""
    if energies is None:
        return {"energy_err": math.inf}
    e = out["energies"].float()
    d = energies.to(e.device).float() - e
    return {"energy_err": float(d.pow(2).mean().sqrt()
                                / out["energy_scale"].float().clamp(min=1e-30))}
