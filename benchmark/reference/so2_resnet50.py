"""Plain reference of the `so2-resnet50` configuration.

An SO(2)-steerable energy network (Weiler and Cesa 2019; circular
harmonics): fields of rotation order 0, 1 and 2, kernels rho(r)
e^{i (m_out - m_in) phi} with rho a sum of Gaussian rings, one complex
coefficient per (out field, in field, ring); after each convolution a
norm BatchNorm (each field over the RMS of its norm) and a norm
nonlinearity (GELU on order 0, relu(|z| + b) z / |z| on the others); a last
convolution to two order-1 fields, averaged over space. The first vector
gives the frame R = [v, v rotated by +90 degrees]; the image is warped by
R^{-1} about (W // 2, H // 2) with the configuration's fast warp: a quarter
turn, then three shears (x by -tan(r / 2), y by sin(r), x again), border
clamp. ResNet-50 classifies the result.

`follow` (the program's rotations (B, 2, 2)) makes the reference warp by
the program's frame, so that its canonical image and logits are those of
the element the program chose.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.common import (
    FP32,
    Precision,
    Weights,
    crop_and_resize,
    resnet50,
    resnet50_spec,
)

Tensor = torch.Tensor

NET = "canonicalizer.canonicalization_network"
PRED = "prediction_network"
SIGMA = 0.6


@functools.lru_cache(maxsize=None)
def harmonic_basis(K: int, dm: int) -> np.ndarray:
    """(J, K, K, 2) ring basis of angular order `dm`: [cos, sin](dm phi)
    times exp(-(r - j)^2 / (2 sigma^2)) for rings j = 0 .. K // 2 (j = 0
    left out and the centre zeroed for dm != 0), cut past K // 2 + 0.5,
    each ring L2-normalized; phi measured with y pointing up."""
    c = (K - 1) / 2.0
    ys, xs = np.mgrid[0:K, 0:K].astype(np.float64)
    x, y = xs - c, ys - c
    r = np.sqrt(x * x + y * y)
    phi = np.arctan2(-y, x)
    rings = []
    for j in range(0 if dm == 0 else 1, K // 2 + 1):
        radial = np.exp(-((r - j) ** 2) / (2 * SIGMA ** 2))
        radial[r > K // 2 + 0.5] = 0.0
        if dm != 0:
            radial[r == 0.0] = 0.0
        re, im = radial * np.cos(dm * phi), radial * np.sin(dm * phi)
        norm = np.sqrt((re ** 2 + im ** 2).sum()) + 1e-12
        rings.append(np.stack([re / norm, im / norm], axis=-1))
    return np.asarray(rings, dtype=np.float32)


def _orders(settings: dict) -> Tuple[Tuple[int, ...], Tuple[int, ...], int]:
    h = settings["canonicalization"]["network_hyperparams"]
    C = h["out_channels"]
    return ((0,) * settings["dataset"]["in_channels"],
            (0,) * C + (1,) * C + (2,) * C, h["num_layers"])


def _conv_spec(prefix: str, ins, outs, K: int):
    spec = []
    for fi, mi in enumerate(ins):
        for fo, mo in enumerate(outs):
            J = harmonic_basis(K, mo - mi).shape[0]
            spec.append((f"{prefix}.w_{fo}_{fi}", (J, 2),
                         f"normal:{1.0 / math.sqrt(J * max(1, len(ins)))}"))
    return spec


def param_spec(settings: dict) -> List[Tuple[str, tuple, str]]:
    ins, hidden, L = _orders(settings)
    K = settings["canonicalization"]["network_hyperparams"]["kernel_size"]
    spec, cur = [], ins
    for i in range(L):
        spec += _conv_spec(f"{NET}.SteerableConv_{i}", cur, hidden, K)
        spec += [(f"{NET}.NormBatchNorm_{i}.scale", (len(hidden),), "bn_weight"),
                 (f"{NET}.NormBatchNorm_{i}.norm_sq", (len(hidden),), "bn_var")]
        spec += [(f"{NET}.NormNonlinearity_{i}.bias_{fi}", (1,), "small")
                 for fi, m in enumerate(hidden) if m != 0]
        cur = hidden
    spec += _conv_spec(f"{NET}.SteerableConv_{L}", cur, (1, 1), K)
    size = settings["dataset"]["image_size"]
    return spec + resnet50_spec(PRED, settings["dataset"]["num_classes"], size <= 64)


def _channels(orders) -> List[int]:
    """First channel of each field (order 0: one channel; else re, im)."""
    out, c = [], 0
    for m in orders:
        out.append(c)
        c += 1 if m == 0 else 2
    return out + [c]


def steerable_kernel(w: Weights, prefix: str, ins, outs, K: int,
                     device) -> Tensor:
    """The real OIHW kernel: each (out field, in field) block is the real
    form of k = sum_j (a_j + i b_j) B_j, B_j the ring basis of order
    m_out - m_in, acting on a real (m = 0) or complex (re, im) field."""
    cin, cout = _channels(ins), _channels(outs)
    kern = torch.zeros(cout[-1], cin[-1], K, K, device=device)
    for fi, mi in enumerate(ins):
        for fo, mo in enumerate(outs):
            basis = torch.from_numpy(harmonic_basis(K, mo - mi)).to(device)
            coef = w[f"{prefix}.w_{fo}_{fi}"]  # (J, 2): a_j, b_j
            a, b = coef[:, 0, None, None], coef[:, 1, None, None]
            k_re = (a * basis[..., 0] - b * basis[..., 1]).sum(0)
            k_im = (a * basis[..., 1] + b * basis[..., 0]).sum(0)
            o, i = cout[fo], cin[fi]
            kern[o, i] = k_re
            if mi == 0 and mo != 0:
                kern[o + 1, i] = k_im
            elif mi != 0 and mo == 0:
                kern[o, i + 1] = -k_im
            elif mi != 0:
                kern[o, i + 1] = -k_im
                kern[o + 1, i] = k_im
                kern[o + 1, i + 1] = k_re
    return kern


def _field_norm(h: Tensor, orders, w: Weights, i: int) -> Tensor:
    """Block i's NormBatchNorm in eval, then its norm nonlinearity."""
    ch = _channels(orders)
    scale = w[f"{NET}.NormBatchNorm_{i}.scale"]
    norm_sq = w[f"{NET}.NormBatchNorm_{i}.norm_sq"]
    parts = []
    for f, m in enumerate(orders):
        z = h[:, ch[f]:ch[f + 1]] * (scale[f] / torch.sqrt(norm_sq[f] + 1e-5))
        if m == 0:
            parts.append(F.gelu(z, approximate="tanh"))
        else:
            b = w[f"{NET}.NormNonlinearity_{i}.bias_{f}"]
            norm = torch.sqrt((z * z).sum(1, keepdim=True) + 1e-8)
            parts.append(torch.relu(norm + b) * z / norm)
    return torch.cat(parts, dim=1)


def vectors(w: Weights, x: Tensor, settings: dict, prec: Precision = FP32) -> Tensor:
    """(B, 2, 2) frame vectors of NHWC images at full size (eval)."""
    cfg = settings["canonicalization"]
    K = cfg["network_hyperparams"]["kernel_size"]
    ins, hidden, L = _orders(settings)
    h = crop_and_resize(x, cfg["input_crop_ratio"], cfg["resize_shape"])
    h = h.permute(0, 3, 1, 2)
    cur = ins
    for i in range(L):
        kern = steerable_kernel(w, f"{NET}.SteerableConv_{i}", cur, hidden, K, x.device)
        h = _field_norm(prec.conv(h, kern), hidden, w, i)
        cur = hidden
    kern = steerable_kernel(w, f"{NET}.SteerableConv_{L}", cur, (1, 1), K, x.device)
    v = prec.conv(h, kern).mean(dim=(2, 3))
    return v.reshape(v.shape[0], 2, 2)


def frame(v: Tensor) -> Tensor:
    """Rotation with rows [v / |v|, (-v_y, v_x) / |v|]."""
    u = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return torch.stack([u, torch.stack([-u[..., 1], u[..., 0]], -1)], dim=-2)


def _shear(img: Tensor, slope: Tensor, axis: int, center: float) -> Tensor:
    """x-shear (axis 2): out[h, w] = img at (h, w + slope (h - center));
    y-shear (axis 1): out[h, w] = img at (h + slope (w - center), w);
    linear taps, edge-clamped."""
    B, H, W, _ = img.shape
    hs = torch.arange(H, dtype=torch.float32, device=img.device)
    ws = torch.arange(W, dtype=torch.float32, device=img.device)
    s = slope[:, None, None]
    if axis == 2:
        pos = ws[None, None, :] + s * (hs[None, :, None] - center)
    else:
        pos = hs[None, :, None] + s * (ws[None, None, :] - center)
    lo = torch.floor(pos)
    f = (pos - lo)[..., None]
    size = img.shape[axis]
    i0 = lo.long().clamp(0, size - 1)[..., None].expand(B, H, W, img.shape[3])
    i1 = (lo.long() + 1).clamp(0, size - 1)[..., None].expand(B, H, W, img.shape[3])
    return (1.0 - f) * torch.gather(img, axis, i0) + f * torch.gather(img, axis, i1)


def fast_warp(x: Tensor, R: Tensor) -> Tensor:
    """out(p) = x(R^{-1}(p - c) + c), c = (W // 2, H // 2), square NHWC,
    border clamp: phi = -atan2(R10, R00) split as 90 k + r (k rounded half
    to even), the quarter turn exact, the residual by three shears."""
    B, H, W, C = x.shape
    cx, cy = W // 2, H // 2
    phi = -torch.atan2(R[:, 1, 0], R[:, 0, 0]).float()
    k = torch.round(phi / torch.full_like(phi, math.pi / 2.0))
    r = phi - k * (math.pi / 2.0)
    k = torch.remainder(k.long(), 4)
    # quarter turn: src = Rot(90 k)(p - c) + c
    c90 = torch.tensor([1, 0, -1, 0], device=x.device)[k][:, None, None]
    s90 = torch.tensor([0, 1, 0, -1], device=x.device)[k][:, None, None]
    py = torch.arange(H, device=x.device)[None, :, None]
    px = torch.arange(W, device=x.device)[None, None, :]
    sx = (cx + c90 * (px - cx) - s90 * (py - cy)).clamp(0, W - 1)
    sy = (cy + s90 * (px - cx) + c90 * (py - cy)).clamp(0, H - 1)
    flat = x.reshape(B, H * W, C)
    idx = (sy * W + sx).reshape(B, H * W, 1).expand(B, H * W, C)
    z = torch.gather(flat, 1, idx).reshape(B, H, W, C).float()
    alpha, beta = -torch.tan(r / 2.0), torch.sin(r)
    z = _shear(z, alpha, 2, float(cy))
    z = _shear(z, beta, 1, float(cx))
    return _shear(z, alpha, 2, float(cy))


def serve(w: Weights, x: Tensor, settings: dict, follow: Optional[Tensor] = None,
          prec: Precision = FP32) -> Dict[str, Tensor]:
    """Eval of one batch: the frame vectors, the element (its own frame,
    or `follow`, the program's), the canonical image and the logits. Under
    a lower precision the images are rounded to it first."""
    x = prec(x)
    v = vectors(w, x, settings, prec=prec)
    R = frame(v[:, 0]) if follow is None else follow.to(x.device).float()
    R_inv = torch.stack([torch.stack([R[:, 0, 0], -R[:, 0, 1]], -1),
                         torch.stack([-R[:, 1, 0], R[:, 1, 1]], -1)], dim=-2)
    xc = fast_warp(x, R_inv)
    logits = resnet50(w, xc, PRED, small_images=settings["dataset"]["image_size"] <= 64,
                      prec=prec)
    return {"vectors": v, "element": R, "canonical": xc, "logits": logits}


def element_gaps(out: Dict[str, Tensor], follow: Tensor,
                 energies: Optional[Tensor] = None) -> Dict[str, float]:
    """How far the frame `follow` (B, 2, 2) turns from the reference's:
    the largest | |v| u - v | over the median |v|, v the reference's first
    vector and u the first row of `follow` (`frame_gap`). A continuous
    info carries no energies."""
    v = out["vectors"][:, 0].float()
    n = torch.linalg.vector_norm(v, dim=-1)
    u = follow.to(v.device).float()[:, 0]
    gap = torch.linalg.vector_norm(n[:, None] * u - v, dim=-1)
    return {"frame_gap": float(gap.max() / n.median().clamp(min=1e-30))}
