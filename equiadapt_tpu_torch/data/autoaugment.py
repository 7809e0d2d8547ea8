"""AutoAugment (CIFAR10 policy) — host-side numpy, torchvision semantics.

The port's own copy of `equiadapt_tpu/data/autoaugment.py` (pure numpy;
the port imports nothing of the JAX package): the same functions and draws,
so a batch and a `np.random.Generator` give the same bytes in both packages.

The reference's CIFAR datamodules offer `transforms.AutoAugment(policy=
CIFAR10)` (prepare/cifar_data.py:55-63). This implements the same 25
sub-policy table and per-op semantics on uint8 HWC images:

* photometric ops follow PIL exactly (ImageOps equalize/autocontrast/
  posterize/solarize/invert, ImageEnhance color/contrast/brightness/
  sharpness incl. the SMOOTH-kernel 1px-border rule) — fixture-tested;
* geometric ops (shear/translate/rotate) use nearest-neighbor inverse
  affine sampling about the image center with zero fill (torchvision's
  InterpolationMode.NEAREST default);
* magnitudes use torchvision's 10-bin augmentation space with random signs.

Runs on the host per batch (data-pipeline stage, like the torch reference's
CPU transforms), keeping the device program static.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

__all__ = ["autoaugment_cifar10", "CIFAR10_POLICY"]

# torchvision _get_policies("cifar10"): 25 x ((op, p, magnitude_bin) x 2)
CIFAR10_POLICY = (
    (("Invert", 0.1, None), ("Contrast", 0.2, 6)),
    (("Rotate", 0.7, 2), ("TranslateX", 0.3, 9)),
    (("Sharpness", 0.8, 1), ("Sharpness", 0.9, 3)),
    (("ShearY", 0.5, 8), ("TranslateY", 0.7, 9)),
    (("AutoContrast", 0.5, None), ("Equalize", 0.9, None)),
    (("ShearY", 0.2, 7), ("Posterize", 0.3, 7)),
    (("Color", 0.4, 3), ("Brightness", 0.6, 7)),
    (("Sharpness", 0.3, 9), ("Brightness", 0.7, 9)),
    (("Equalize", 0.6, None), ("Equalize", 0.5, None)),
    (("Contrast", 0.6, 7), ("Sharpness", 0.6, 5)),
    (("Color", 0.7, 7), ("TranslateX", 0.5, 8)),
    (("Equalize", 0.3, None), ("AutoContrast", 0.4, None)),
    (("TranslateY", 0.4, 3), ("Sharpness", 0.2, 6)),
    (("Brightness", 0.9, 6), ("Color", 0.2, 8)),
    (("Solarize", 0.5, 2), ("Invert", 0.0, None)),
    (("Equalize", 0.2, None), ("AutoContrast", 0.6, None)),
    (("Equalize", 0.2, None), ("Equalize", 0.6, None)),
    (("Color", 0.9, 9), ("Equalize", 0.6, None)),
    (("AutoContrast", 0.8, None), ("Solarize", 0.2, 8)),
    (("Brightness", 0.1, 3), ("Color", 0.7, 0)),
    (("Solarize", 0.4, 5), ("AutoContrast", 0.9, None)),
    (("TranslateY", 0.9, 9), ("TranslateY", 0.7, 9)),
    (("AutoContrast", 0.9, None), ("Solarize", 0.8, 3)),
    (("Equalize", 0.8, None), ("Invert", 0.1, None)),
    (("TranslateY", 0.7, 9), ("AutoContrast", 0.9, None)),
)

_NUM_BINS = 10


def _magnitude(op: str, bin_idx: Optional[int], size: int, sign: float) -> float:
    """torchvision _augmentation_space(10, (size, size)) lookup + sign."""
    if bin_idx is None:
        return 0.0
    t = bin_idx / (_NUM_BINS - 1)
    if op in ("ShearX", "ShearY"):
        return sign * 0.3 * t
    if op in ("TranslateX", "TranslateY"):
        return sign * (150.0 / 331.0) * size * t
    if op == "Rotate":
        return sign * 30.0 * t
    if op in ("Brightness", "Color", "Contrast", "Sharpness"):
        return sign * 0.9 * t
    if op == "Posterize":
        return 8 - int(round(4.0 * t))
    if op == "Solarize":
        return 255.0 * (1.0 - t)
    return 0.0


# ---------------- geometric (nearest, zero fill, about center) ------------


def _affine_nearest(img: np.ndarray, inv: np.ndarray, t: Tuple[float, float]) -> np.ndarray:
    """dst(p) = src(inv @ (p - c - t) + c), nearest-rounded, zero fill."""
    H, W = img.shape[:2]
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    dx = gx - cx - t[0]
    dy = gy - cy - t[1]
    sx = np.rint(inv[0, 0] * dx + inv[0, 1] * dy + cx).astype(np.int64)
    sy = np.rint(inv[1, 0] * dx + inv[1, 1] * dy + cy).astype(np.int64)
    valid = (sx >= 0) & (sx < W) & (sy >= 0) & (sy < H)
    out = np.zeros_like(img)
    out[valid] = img[sy[valid], sx[valid]]
    return out


def _shear_x(img, mag):
    return _affine_nearest(img, np.array([[1.0, -mag], [0.0, 1.0]]), (0.0, 0.0))


def _shear_y(img, mag):
    return _affine_nearest(img, np.array([[1.0, 0.0], [-mag, 1.0]]), (0.0, 0.0))


def _translate_x(img, mag):
    return _affine_nearest(img, np.eye(2), (mag, 0.0))


def _translate_y(img, mag):
    return _affine_nearest(img, np.eye(2), (0.0, mag))


def _rotate(img, deg):
    r = math.radians(deg)
    c, s = math.cos(r), math.sin(r)
    return _affine_nearest(img, np.array([[c, s], [-s, c]]), (0.0, 0.0))


# ---------------- photometric (PIL semantics on uint8) --------------------


def _luma(img: np.ndarray) -> np.ndarray:
    """PIL L-mode conversion: ITU-R 601-2, truncated like PIL's int cast."""
    if img.shape[-1] == 1:
        return img[..., 0].astype(np.float64)
    f = img.astype(np.float64)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    return np.floor(r * 299 / 1000 + g * 587 / 1000 + b * 114 / 1000)


def _blend(a: np.ndarray, b: np.ndarray, factor: float) -> np.ndarray:
    """PIL Image.blend(a, b, factor) = a + factor * (b - a), clipped uint8."""
    out = a.astype(np.float64) + factor * (b.astype(np.float64) - a.astype(np.float64))
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _brightness(img, mag):
    return _blend(np.zeros_like(img), img, 1.0 + mag)


def _color(img, mag):
    gray = _luma(img)[..., None].astype(np.uint8)
    degenerate = np.broadcast_to(gray, img.shape)
    return _blend(degenerate, img, 1.0 + mag)


def _contrast(img, mag):
    mean = int(_luma(img).mean() + 0.5)
    degenerate = np.full_like(img, mean)
    return _blend(degenerate, img, 1.0 + mag)


def _sharpness(img, mag):
    # PIL ImageEnhance.Sharpness: blend with the SMOOTH-filtered image;
    # the filter leaves a 1-pixel border unchanged
    k = np.array([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]]) / 13.0
    f = img.astype(np.float64)
    sm = f.copy()
    acc = np.zeros_like(f[1:-1, 1:-1])
    for dy in range(3):
        for dx in range(3):
            acc += k[dy, dx] * f[dy:dy + f.shape[0] - 2, dx:dx + f.shape[1] - 2]
    sm[1:-1, 1:-1] = np.clip(np.rint(acc), 0, 255)
    return _blend(sm.astype(np.uint8), img, 1.0 + mag)


def _posterize(img, bits):
    mask = ~np.uint8((1 << (8 - int(bits))) - 1)
    return img & mask


def _solarize(img, threshold):
    return np.where(img >= threshold, 255 - img, img).astype(np.uint8)


def _invert(img, _=None):
    return (255 - img).astype(np.uint8)


def _autocontrast(img, _=None):
    out = np.empty_like(img)
    for c in range(img.shape[-1]):
        ch = img[..., c]
        lo, hi = int(ch.min()), int(ch.max())
        if hi <= lo:
            out[..., c] = ch
        else:
            scale = 255.0 / (hi - lo)
            out[..., c] = np.clip(
                np.rint((ch.astype(np.float64) - lo) * scale), 0, 255
            ).astype(np.uint8)
    return out


def _equalize(img, _=None):
    """PIL ImageOps.equalize: per-channel LUT from the cumulative histogram
    with PIL's exact step arithmetic."""
    out = np.empty_like(img)
    for c in range(img.shape[-1]):
        ch = img[..., c]
        h = np.bincount(ch.reshape(-1), minlength=256)
        nonzero = h[h > 0]
        if len(nonzero) <= 1:
            out[..., c] = ch
            continue
        step = (int(nonzero.sum()) - int(nonzero[-1])) // 255
        if step == 0:
            out[..., c] = ch
            continue
        lut = np.empty(256, np.int64)
        n = step // 2
        for i in range(256):
            lut[i] = min(n // step, 255)
            n += int(h[i])
        out[..., c] = lut[ch].astype(np.uint8)
    return out


_OPS = {
    "ShearX": _shear_x,
    "ShearY": _shear_y,
    "TranslateX": _translate_x,
    "TranslateY": _translate_y,
    "Rotate": _rotate,
    "Brightness": _brightness,
    "Color": _color,
    "Contrast": _contrast,
    "Sharpness": _sharpness,
    "Posterize": _posterize,
    "Solarize": _solarize,
    "AutoContrast": _autocontrast,
    "Equalize": _equalize,
    "Invert": _invert,
}

_SIGNED = {
    "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate",
    "Brightness", "Color", "Contrast", "Sharpness",
}


def autoaugment_cifar10(rng: np.random.Generator, images: np.ndarray) -> np.ndarray:
    """Apply the AutoAugment CIFAR10 policy to a uint8 (B, H, W, C) batch.

    Per image: one of the 25 sub-policies uniformly at random; each of its
    two ops applies with its probability; signed magnitudes flip sign with
    probability 0.5 (torchvision behavior).
    """
    assert images.dtype == np.uint8, "autoaugment operates on uint8 images"
    B, H, W, _ = images.shape
    out = images.copy()
    policy_idx = rng.integers(0, len(CIFAR10_POLICY), B)
    for b in range(B):
        img = out[b]
        for op, prob, bin_idx in CIFAR10_POLICY[policy_idx[b]]:
            if rng.random() >= prob:
                continue
            sign = -1.0 if (op in _SIGNED and rng.random() < 0.5) else 1.0
            mag = _magnitude(op, bin_idx, W, sign)
            img = _OPS[op](img, mag)
        out[b] = img
    return out
