"""Plain PyTorch pieces shared by the benchmark's references.

Everything here is written from the published definitions of the layers
(ResNet-50, He et al. 2016, torchvision layout; the C_n group convolution
of Cohen and Welling 2016; bilinear sampling; AdamW, Loshchilov and Hutter
2019) and from the configuration's own settings. It imports nothing of the
program under test. Tensors are NHWC at the boundaries, as the program
takes them, and NCHW inside the convolutions.

`Precision` rounds every value a layer hands on (the operands and results
of convolutions and products, the outputs of normalizations and residual
sums) and, on the backward pass, their cotangents: "fp32" leaves them
alone (the reference); "fp8" (float8 e4m3) and "int8" (symmetric) round
each under a per-tensor scale: the controls, one precision step below the
program's bf16, which keeps its activations in bf16 throughout. TF32 must be off for "fp32" to
mean float32: `fp32_only()` turns it off.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

Tensor = torch.Tensor
Weights = Dict[str, Tensor]

F8_MAX = 448.0  # largest finite float8 e4m3fn


def fp32_only() -> None:
    """Matrix products and convolutions in true float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _round_fp8(x: Tensor) -> Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (largest |x| to
    the format's largest finite value)."""
    scale = x.abs().amax().clamp(min=1e-30) / F8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def _round_int8(x: Tensor) -> Tensor:
    """x rounded to symmetric int8 under a per-tensor scale (largest |x| to
    127)."""
    scale = x.abs().amax().clamp(min=1e-30) / 127.0
    return torch.round(x / scale).clamp(-127, 127) * scale


_ROUND = {"fp8": _round_fp8, "int8": _round_int8}


class _Round(torch.autograd.Function):
    """Rounding of a value on the forward pass and of its cotangent on the
    backward pass, as a program computing in that format rounds both."""

    @staticmethod
    def forward(ctx, x, name):
        ctx.name = name
        return _ROUND[name](x)

    @staticmethod
    def backward(ctx, g):
        return _ROUND[ctx.name](g), None


class Precision:
    """Rounding of the operands and results of convolutions and products
    (and of their cotangents), or none."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8", "int8"):
            raise ValueError(f"precision fp32, fp8 or int8, got {name!r}")
        self.name = name

    def __call__(self, x: Tensor) -> Tensor:
        return x if self.name == "fp32" else _Round.apply(x, self.name)

    def conv(self, x: Tensor, w: Tensor, stride: int = 1, padding: int = 0) -> Tensor:
        return self(F.conv2d(self(x), self(w), stride=stride, padding=padding))

    def linear(self, x: Tensor, w: Tensor, b: Optional[Tensor]) -> Tensor:
        return self(F.linear(self(x), self(w), b))


FP32 = Precision("fp32")


# ---------------------------------------------------------------- specs

def bn_spec(prefix: str, ch: int) -> List[Tuple[str, tuple, str]]:
    return [(f"{prefix}.weight", (ch,), "bn_weight"),
            (f"{prefix}.bias", (ch,), "bn_bias"),
            (f"{prefix}.running_mean", (ch,), "bn_mean"),
            (f"{prefix}.running_var", (ch,), "bn_var")]


RESNET50_STAGES = (3, 4, 6, 3)


def resnet50_spec(prefix: str, num_classes: int, small_images: bool
                  ) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter and statistic of ResNet-50:
    the stem, 16 bottlenecks (1x1, 3x3, 1x1 and a projection where the
    shape changes), the head."""
    k = 3 if small_images else 7
    spec = [(f"{prefix}.Conv_0.weight", (64, 3, k, k), "he")]
    spec += bn_spec(f"{prefix}.BatchNorm_0", 64)
    in_ch, filters, b = 64, 64, 0
    for i, n in enumerate(RESNET50_STAGES):
        for j in range(n):
            stride = 2 if (i > 0 and j == 0) else 1
            p = f"{prefix}.Bottleneck_{b}"
            out_ch = filters * 4
            spec += [(f"{p}.Conv_0.weight", (filters, in_ch, 1, 1), "he")]
            spec += bn_spec(f"{p}.BatchNorm_0", filters)
            spec += [(f"{p}.Conv_1.weight", (filters, filters, 3, 3), "he")]
            spec += bn_spec(f"{p}.BatchNorm_1", filters)
            spec += [(f"{p}.Conv_2.weight", (out_ch, filters, 1, 1), "he")]
            spec += bn_spec(f"{p}.BatchNorm_2", out_ch)
            if stride != 1 or in_ch != out_ch:
                spec += [(f"{p}.Conv_3.weight", (out_ch, in_ch, 1, 1), "he")]
                spec += bn_spec(f"{p}.BatchNorm_3", out_ch)
            in_ch = out_ch
            b += 1
        filters *= 2
    spec += [(f"{prefix}.Dense_0.weight", (num_classes, in_ch), "fan_in"),
             (f"{prefix}.Dense_0.bias", (num_classes,), "small")]
    return spec


# ---------------------------------------------------------------- layers

def batch_norm(x: Tensor, w: Weights, prefix: str, training: bool,
               eps: float = 1e-5) -> Tensor:
    """Per-channel BatchNorm of (B, C, ...): the running statistics in
    eval, the batch mean and biased variance in training."""
    shape = [1, -1] + [1] * (x.dim() - 2)
    if training:
        dims = [0] + list(range(2, x.dim()))
        mean = x.mean(dims)
        var = ((x - mean.view(shape)) ** 2).mean(dims)
    else:
        mean, var = w[f"{prefix}.running_mean"], w[f"{prefix}.running_var"]
    y = (x - mean.view(shape)) / torch.sqrt(var.view(shape) + eps)
    return y * w[f"{prefix}.weight"].view(shape) + w[f"{prefix}.bias"].view(shape)


def _bottleneck(w: Weights, h: Tensor, p: str, stride: int, project: bool,
                training: bool, prec: Precision) -> Tensor:
    y = prec.conv(h, w[f"{p}.Conv_0.weight"])
    y = torch.relu(prec(batch_norm(y, w, f"{p}.BatchNorm_0", training)))
    y = prec.conv(y, w[f"{p}.Conv_1.weight"], stride, 1)
    y = torch.relu(prec(batch_norm(y, w, f"{p}.BatchNorm_1", training)))
    y = prec(batch_norm(prec.conv(y, w[f"{p}.Conv_2.weight"]), w, f"{p}.BatchNorm_2",
                        training))
    if project:
        r = prec(batch_norm(prec.conv(h, w[f"{p}.Conv_3.weight"], stride), w,
                            f"{p}.BatchNorm_3", training))
    else:
        r = h
    return torch.relu(prec(y + r))


def resnet50(w: Weights, x: Tensor, prefix: str, training: bool = False,
             small_images: bool = False, prec: Precision = FP32,
             remat: bool = False) -> Tensor:
    """ResNet-50 logits of NHWC images. `remat` recomputes each
    bottleneck's activations on the backward pass (the same values: the
    batch statistics are recomputed from the same inputs), so a large batch
    fits."""
    h = x.permute(0, 3, 1, 2)
    if small_images:
        h = prec.conv(h, w[f"{prefix}.Conv_0.weight"], 1, 1)
    else:
        h = prec.conv(h, w[f"{prefix}.Conv_0.weight"], 2, 3)
    h = torch.relu(prec(batch_norm(h, w, f"{prefix}.BatchNorm_0", training)))
    if not small_images:
        h = F.max_pool2d(h, 3, 2, 1)
    in_ch, filters, b = 64, 64, 0
    for i, n in enumerate(RESNET50_STAGES):
        for j in range(n):
            stride = 2 if (i > 0 and j == 0) else 1
            args = (w, h, f"{prefix}.Bottleneck_{b}", stride,
                    stride != 1 or in_ch != filters * 4, training, prec)
            h = (torch.utils.checkpoint.checkpoint(_bottleneck, *args, use_reentrant=False)
                 if remat else _bottleneck(*args))
            in_ch = filters * 4
            b += 1
        filters *= 2
    h = h.mean(dim=(2, 3))
    return prec.linear(h, w[f"{prefix}.Dense_0.weight"], w[f"{prefix}.Dense_0.bias"])


# ---------------------------------------------------------------- images

def crop_and_resize(x: Tensor, crop_ratio: float, size: int) -> Tensor:
    """Centre crop of ceil(side * ratio) (top = round of half the margin),
    then an antialiased bilinear resize to size x size (half-pixel
    centres), NHWC."""
    H, W = x.shape[1], x.shape[2]
    ch, cw = math.ceil(H * crop_ratio), math.ceil(W * crop_ratio)
    top, left = int(round((H - ch) / 2.0)), int(round((W - cw) / 2.0))
    x = x[:, top:top + ch, left:left + cw, :]
    out = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


def _lerp_gather(img: Tensor, pos: Tensor, axis: int) -> Tensor:
    """Linear interpolation of NHWC `img` along `axis` (1 rows, 2 columns)
    at positions `pos` broadcast to (B, H, W), edge-clamped taps."""
    B, H, W, C = img.shape
    size = img.shape[axis]
    pos = pos.expand(B, H, W)
    lo = torch.floor(pos)
    f = (pos - lo)[..., None]
    i0 = lo.long().clamp(0, size - 1)
    i1 = (lo.long() + 1).clamp(0, size - 1)
    t0 = torch.gather(img, axis, i0[..., None].expand(B, H, W, C))
    t1 = torch.gather(img, axis, i1[..., None].expand(B, H, W, C))
    return (1.0 - f) * t0 + f * t1


def two_pass_rotate(x: Tensor, angle_deg: float) -> Tensor:
    """The configuration's fast static rotation of square NHWC images by
    |angle| <= 45 degrees, border clamp: a vertical 1-D interpolation at
    p(y, w) = (sin (w - c) + (y - c)) / cos + c, then a horizontal one at
    q(y, x) = cos (x - c) - sin (y - c) + c, c = (W - 1) / 2."""
    B, H, W, C = x.shape
    rad = math.radians(angle_deg)
    a, b = math.cos(rad), math.sin(rad)
    c = (W - 1) / 2.0
    ys = torch.arange(H, dtype=torch.float32, device=x.device)
    ws = torch.arange(W, dtype=torch.float32, device=x.device)
    p = (b * (ws[None, :] - c) + (ys[:, None] - c)) / a + c  # (y, w)
    v = _lerp_gather(x, p[None], 1)
    q = a * (ws[None, :] - c) - b * (ys[:, None] - c) + c  # (y, x)
    return _lerp_gather(v, q[None], 2)


def discrete_rotation_candidates(x: Tensor, num_rotations: int,
                                 sign: float = -1.0) -> List[Tensor]:
    """rotate(x, sign * 360 g / n) for each g, fast mode: each residual
    angle mod 90 by `two_pass_rotate`, the quarter turns exact."""
    out, cache = [], {}
    for g in range(num_rotations):
        ang = (sign * 360.0 * g / num_rotations) % 360.0
        r = ang % 90.0
        k = int(round((ang - r) / 90.0)) % 4
        if r not in cache:
            cache[r] = x if r == 0.0 else two_pass_rotate(x, r if r <= 45.0 else r - 90.0)
            if r > 45.0:
                k = (k + 1) % 4
        elif r > 45.0:
            k = (k + 1) % 4
        out.append(torch.rot90(cache[r], k, dims=(1, 2)))
    return out


def rotation_tap_matrix(K: int, angles: Sequence[float]) -> np.ndarray:
    """(G, K*K, K*K): T[g] @ vec(w) = vec(w rotated by angles[g]), bilinear
    with zeros outside the filter; multiples of 90 degrees exact."""
    G = len(angles)
    c = (K - 1) / 2.0
    gy, gx = np.meshgrid(np.arange(K, dtype=np.float64),
                         np.arange(K, dtype=np.float64), indexing="ij")
    dst = (gy.astype(np.int64) * K + gx.astype(np.int64)).ravel()
    T = np.zeros((G, K * K, K * K), np.float64)
    for g, ang in enumerate(angles):
        ang = float(ang) % 360.0
        k90 = ang / 90.0
        rad = math.radians(90.0 * round(k90) if abs(k90 - round(k90)) < 1e-9 else ang)
        a, b = math.cos(rad), math.sin(rad)
        if abs(k90 - round(k90)) < 1e-9:
            a, b = round(a), round(b)
        sx = a * (gx - c) - b * (gy - c) + c
        sy = b * (gx - c) + a * (gy - c) + c
        x0, y0 = np.floor(sx), np.floor(sy)
        fx, fy = sx - x0, sy - y0
        for ddx, ddy, wt in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                             (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
            xi, yi = x0 + ddx, y0 + ddy
            valid = (xi >= 0) & (xi <= K - 1) & (yi >= 0) & (yi <= K - 1)
            src = (np.clip(yi, 0, K - 1) * K + np.clip(xi, 0, K - 1)).astype(np.int64)
            np.add.at(T[g], (dst, src.ravel()), (wt * valid).ravel())
    return T.astype(np.float32)


# ---------------------------------------------------------------- training

def adamw_step(params: Weights, grads: Weights, state: Dict[str, dict], lr: float,
               weight_decay: float, betas=(0.9, 0.999), eps: float = 1e-8) -> None:
    """One decoupled-weight-decay Adam step in place on every parameter
    that has a gradient."""
    b1, b2 = betas
    for name, p in params.items():
        g = grads.get(name)
        if g is None:
            continue
        s = state.setdefault(name, {"t": 0, "m": torch.zeros_like(p),
                                    "v": torch.zeros_like(p)})
        s["t"] += 1
        t = s["t"]
        s["m"] = b1 * s["m"] + (1.0 - b1) * g
        s["v"] = b2 * s["v"] + (1.0 - b2) * g * g
        m_hat = s["m"] / (1.0 - b1 ** t)
        v_hat = s["v"] / (1.0 - b2 ** t)
        p.mul_(1.0 - lr * weight_decay)
        p.sub_(lr * m_hat / (torch.sqrt(v_hat) + eps))


def dropout_keep(shape, generator: torch.Generator, device) -> Tensor:
    """The keep mask of dropout at rate 0.5 as the configuration draws it:
    one Bernoulli(0.5) draw per element from the step's generator."""
    return torch.bernoulli(torch.full(shape, 0.5, dtype=torch.float32, device=device),
                           generator=generator).bool()


def train_steps(weights: Weights, trainable: Sequence[str], forward: Callable,
                batches: Sequence[Tuple[Tensor, Tensor]], generator: torch.Generator,
                lr: float, weight_decay: float, steps: int) -> dict:
    """`steps` AdamW steps of `forward(w, images, labels, generator)` ->
    loss from `weights` (copied, fp32): the loss of each step, the
    gradient of each trainable leaf at step 1 and the leaves after the
    last step."""
    params = {k: v.detach().clone().float() for k, v in weights.items()}
    state: Dict[str, dict] = {}
    losses, first_grads = [], None
    for i in range(steps):
        leaves = {k: params[k].requires_grad_(True) for k in trainable}
        images, labels = batches[i]
        loss = forward(params, images, labels, generator)
        grads = torch.autograd.grad(loss, [leaves[k] for k in trainable])
        with torch.no_grad():
            gd = {k: g.detach() for k, g in zip(trainable, grads)}
            if first_grads is None:
                first_grads = {k: g.clone() for k, g in gd.items()}
            for k in trainable:
                params[k] = params[k].detach()
            adamw_step(params, gd, state, lr, weight_decay)
        losses.append(float(loss.detach()))
        del loss, grads, leaves
    return {"losses": losses, "first_grads": first_grads,
            "params": {k: params[k].detach() for k in trainable}}
