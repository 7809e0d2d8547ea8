"""A stride-1 convolution in the frequency domain, fp32, and its channel
contraction as a hand-written CUDA kernel.

For x (B, Cin, H, W) and an OIHW kernel (Cout, Cin, K, K) with zero padding
p, `F.conv2d`'s cross-correlation is, by the convolution theorem,

    y = irfft2(Y)[..., :Ho, :Wo],   Y[b, o] = sum_i rfft2(x)[b, i] S[i, o]

with both transforms at Nh x Nw (`fft_shape`: at least H + 2p and W + 2p,
even, no prime factor above 7) and S the conjugate rfft2 of the kernel
zero-padded to that size and rolled by -p in both axes (`kernel_spectrum`,
(Cin, Cout, Nh, Nw / 2 + 1) complex64). Every step is exact in real
arithmetic; here each runs in fp32 (the transforms are cuFFT's on the
card, which has no TF32). The spectrum depends on the weights alone, so a
caller that keeps it across calls (`SteerableConv` under grad mode off)
pays for two transforms and the contraction a call.

`spectral_contraction` computes Y from rfft2(x) and S: it launches the
kernel of `csrc/spectral_conv.cu` for CUDA tensors and takes
`spectral_contraction_plain` (a complex `torch.einsum`) for CPU tensors
only; a CUDA call launches or raises. The kernel replaces no TPU kernel
(the JAX package's convolution is a plain XLA convolution); its source says
what bounds it and how it is built.

`conv_path` decides between "spectral" and "direct" (`F.conv2d`) for a call
from what it can observe: grad mode, dtype, stride and shapes. It compares
two operation counts (`conv_counts`): the direct one, 2 B Cin Cout Ho Wo
K^2, and the spectral one, the contraction's 8 B Cin Cout Nh (Nw / 2 + 1)
plus TRANSFORM_WEIGHT B (Cin + Cout) Nh Nw log2(Nh Nw) / 2 for the two
transforms; the spectral path is taken where its count times MARGIN is
under the direct one. Both constants are the card's (H100, fp32, cuFFT
and the kernel against cuDNN; PERF.md): TRANSFORM_WEIGHT from the so2
cell's two spectral layers, MARGIN from an fp32 3 -> 80 layer at 64 px,
whose counts tie while spectral took 1.21 ms and direct 1.39. The rule
does not look at the device: a CPU call follows the card's rule, so that
CPU runs (the tests against the JAX package, the fp32 parity mode) take
the path the card takes at the same shapes, not the faster one there
(the einsum is slower than oneDNN's convolution at a small batch).

`launches` counts the kernel's launches by dtype,
`launches["spectral_contraction/float32"]`, and `path_launches` by dtype
and output tile, e.g. `path_launches["spectral_contraction/float32/o80"]`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from equiadapt_tpu_torch.ops.kernels import _build

Tensor = torch.Tensor

__all__ = ["spectral_contraction", "spectral_contraction_plain", "spectral_conv2d",
           "kernel_spectrum", "fft_shape", "conv_counts", "conv_path",
           "TRANSFORM_WEIGHT", "MARGIN", "launches", "path_launches", "reset_launches"]

_KERNELS = "the spectral contraction kernel"
_DIFFERENTIABLE = (
    "SteerableConv takes the direct F.conv2d path under grad mode, which is the "
    "differentiable one")

# the transforms' weight in the spectral count, per element and log2 of the
# size: their card time at the contraction kernel's rate, 46 and 54 at the
# so2 cell's 80 -> 4 and 80 -> 80 layers (cuFFT moves bytes; a real FFT's
# textbook count would be 5); and the factor by which the spectral count
# must undercut the direct one, which leaves the tie of an fp32 3 -> 80
# layer at 64 px direct (module docstring; PERF.md)
TRANSFORM_WEIGHT = 50.0
MARGIN = 1.25
# the kernel's tile (`csrc/spectral_conv.cu`): batch rows and bins a block;
# output channels a block by the thread's RO (8 RO): 8 for so2's 80 -> 4
# layer, 80 for its 80 -> 80 layer and any other
_BT, _FT = 64, 4
_OUT_TILES = {1: 8, 10: 80}
# the grid's limit: tiles_o x tiles_b x tiles_f blocks in x
MAX_GRID_X = 2**31 - 1

# kernel launches by dtype and by dtype and output tile, e.g.
# launches["spectral_contraction/float32"], path_launches["spectral_contraction/float32/o80"]
launches: Dict[str, int] = {}
path_launches: Dict[str, int] = {}


def reset_launches() -> None:
    launches.clear()
    path_launches.clear()


def _fft_size(n: int) -> int:
    """The smallest even size of at least n with no prime factor above 7."""
    m = max(2, n + (n % 2))
    while True:
        r = m
        for p in (2, 3, 5, 7):
            while r % p == 0:
                r //= p
        if r == 1:
            return m
        m += 2


def fft_shape(H: int, W: int, padding: int) -> Tuple[int, int]:
    """(Nh, Nw), the transforms' size for an H x W map padded by `padding`."""
    return _fft_size(H + 2 * padding), _fft_size(W + 2 * padding)


def conv_counts(B: int, Cin: int, Cout: int, H: int, W: int, K: int,
                padding: int) -> Tuple[float, float]:
    """(direct, spectral) operation counts of a stride-1 K x K convolution
    of (B, Cin, H, W) to Cout channels (module docstring)."""
    Ho, Wo = H + 2 * padding - K + 1, W + 2 * padding - K + 1
    Nh, Nw = fft_shape(H, W, padding)
    direct = 2.0 * B * Cin * Cout * Ho * Wo * K * K
    contraction = 8.0 * B * Cin * Cout * Nh * (Nw // 2 + 1)
    transforms = TRANSFORM_WEIGHT * B * (Cin + Cout) * Nh * Nw * math.log2(Nh * Nw) / 2
    return direct, contraction + transforms


def conv_path(x: Tensor, Cout: int, K: int, stride: int, padding: int) -> str:
    """"spectral" for an fp32 (B, Cin, H, W) call under grad mode off at
    stride 1 whose counts favour it by MARGIN; "direct" for every other:
    grad mode on (autograd takes `F.conv2d`), another dtype (a bf16 input
    stays on `F.conv2d` in bf16), another stride, an output under 1 x 1, or
    counts that favour `F.conv2d`. The constants are the card's, on every
    device (module docstring)."""
    if torch.is_grad_enabled() or x.dtype != torch.float32 or stride != 1 or x.dim() != 4:
        return "direct"
    B, Cin, H, W = x.shape
    if min(H, W) + 2 * padding < K:
        return "direct"
    direct, spectral = conv_counts(B, Cin, Cout, H, W, K, padding)
    return "spectral" if spectral * MARGIN < direct else "direct"


def kernel_spectrum(kernel: Tensor, fft_hw: Tuple[int, int], padding: int) -> Tensor:
    """S (Cin, Cout, Nh, Nw / 2 + 1) complex of the OIHW `kernel`: zero-padded
    to `fft_hw`, rolled by -padding in both axes (so the top-left Ho x Wo of
    the inverse is the padded cross-correlation), rfft2, conjugated (a
    cross-correlation), in the contraction's layout."""
    Nh, Nw = fft_hw
    K = kernel.shape[-1]
    padded = torch.nn.functional.pad(kernel, (0, Nw - K, 0, Nh - K))
    if padding:
        padded = torch.roll(padded, shifts=(-padding, -padding), dims=(-2, -1))
    spectrum = torch.fft.rfft2(padded)
    return torch.conj_physical(spectrum.transpose(0, 1)).contiguous()


def spectral_conv2d(x: Tensor, spectrum: Tensor, kernel_size: int, padding: int) -> Tensor:
    """`F.conv2d(x, kernel, padding=padding)` at stride 1 for the kernel
    whose `kernel_spectrum` is `spectrum`: rfft2 of x at the spectrum's
    size, the contraction, irfft2, and the Ho x Wo window of the inverse (a
    view)."""
    B, Cin, H, W = x.shape
    Nh, Nw = fft_shape(H, W, padding)
    Ho, Wo = H + 2 * padding - kernel_size + 1, W + 2 * padding - kernel_size + 1
    y_hat = spectral_contraction(torch.fft.rfft2(x, s=(Nh, Nw)), spectrum)
    return torch.fft.irfft2(y_hat, s=(Nh, Nw))[..., :Ho, :Wo]


def _check(x_hat: Tensor, k_hat: Tensor) -> None:
    if x_hat.dim() != 4 or k_hat.dim() != 4:
        raise ValueError(f"x_hat (B, Cin, Nh, Nf) and k_hat (Cin, Cout, Nh, Nf), got "
                         f"{tuple(x_hat.shape)}, {tuple(k_hat.shape)}")
    if x_hat.shape[1] != k_hat.shape[0] or x_hat.shape[2:] != k_hat.shape[2:]:
        raise ValueError(f"x_hat (B, Cin, Nh, Nf) and k_hat (Cin, Cout, Nh, Nf) with one "
                         f"Cin and bins, got {tuple(x_hat.shape)}, {tuple(k_hat.shape)}")
    if x_hat.dtype != k_hat.dtype or not x_hat.is_complex():
        raise TypeError(f"x_hat and k_hat of one complex dtype, got {x_hat.dtype}, "
                        f"{k_hat.dtype}")


def spectral_contraction_plain(x_hat: Tensor, k_hat: Tensor) -> Tensor:
    """Y[b, o] = sum_i x_hat[b, i] k_hat[i, o], bin by bin: (B, Cout, Nh, Nf)
    from x_hat (B, Cin, Nh, Nf) and k_hat (Cin, Cout, Nh, Nf)."""
    _check(x_hat, k_hat)
    return torch.einsum("bihw,iohw->bohw", x_hat, k_hat)


def _fake(x_hat, k_hat):
    return x_hat.new_empty((x_hat.shape[0], k_hat.shape[1], *x_hat.shape[2:]))


def spectral_contraction(x_hat: Tensor, k_hat: Tensor) -> Tensor:
    """The contraction (module docstring) of x_hat (B, Cin, Nh, Nf) and
    k_hat (Cin, Cout, Nh, Nf), complex64, to (B, Cout, Nh, Nf): the kernel
    on the card, `spectral_contraction_plain` on the CPU. Meta tensors
    inside `_build.shapes_only()` give an empty result of that shape."""
    _check(x_hat, k_hat)
    where = _build.route([x_hat, k_hat], _KERNELS)
    if where == "meta":
        return _fake(x_hat, k_hat)
    if where == "cpu":
        return spectral_contraction_plain(x_hat, k_hat)
    _build.refuse_grad([x_hat, k_hat], _KERNELS, _DIFFERENTIABLE)
    return _contraction_op(x_hat, k_hat)


# the kernel as a registered operator around `_launch` (`_build.register_op`)
_contraction_op = _build.register_op(
    "spectral_contraction(Tensor x_hat, Tensor k_hat) -> Tensor",
    lambda x_hat, k_hat: _launch(x_hat, k_hat), _fake)


def _out_tile(Cout: int) -> int:
    """The thread's output channels RO: 1 for at most 8 outputs, else 10."""
    return 1 if Cout <= _OUT_TILES[1] else 10


def _validate_launch(x_hat: Tensor, k_hat: Tensor) -> None:
    """What the kernel takes beyond `_check`: complex64; each map's bins
    contiguous; every stride even and both starts 16-byte aligned (16-byte
    copies of two bins), so an even number of bins a map; the grid within
    its limits."""
    if x_hat.dtype != torch.complex64:
        raise TypeError(f"{_KERNELS} takes complex64, got {x_hat.dtype}")
    B, _, Nh, Nf = x_hat.shape
    for name, t in (("x_hat", x_hat), ("k_hat", k_hat)):
        if t.stride(3) != 1 or t.stride(2) != Nf:
            raise ValueError(f"{_KERNELS} reads {name}'s bins contiguous, got strides "
                             f"{t.stride()}")
        if any(s % 2 for s in t.stride()[:2]) or (Nh * Nf) % 2 or t.data_ptr() % 16:
            raise ValueError(f"{_KERNELS} copies {name} in 16-byte words: even strides and "
                             f"bins, a 16-byte aligned start; got strides {t.stride()}")
    Cout, F = k_hat.shape[1], Nh * Nf
    ro = _out_tile(Cout)
    if -(-B // _BT) * -(-F // _FT) * -(-Cout // _OUT_TILES[ro]) > MAX_GRID_X:
        raise ValueError(f"grid limit: B {B}, {F} bins, Cout {Cout}")


def _lib() -> ctypes.CDLL:
    lib = _build.load("spectral_conv")
    fn = lib.eqt_spectral_contraction
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, ctypes.POINTER(ctypes.c_longlong),
                       ci, ci, ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
    return lib


def _launch(x_hat: Tensor, k_hat: Tensor) -> Tensor:
    _validate_launch(x_hat, k_hat)
    B, Cin, Nh, Nf = x_hat.shape
    Cout, F = k_hat.shape[1], Nh * Nf
    ro = _out_tile(Cout)
    out = torch.empty((B, Cout, Nh, Nf), dtype=x_hat.dtype, device=x_hat.device)
    strides = (x_hat.stride(0), x_hat.stride(1), k_hat.stride(0), k_hat.stride(1),
               out.stride(0), out.stride(1))
    err = _lib().eqt_spectral_contraction(
        x_hat.data_ptr(), k_hat.data_ptr(), out.data_ptr(),
        (ctypes.c_longlong * 6)(*strides), B, Cin, Cout, F, ro, -(-B // _BT),
        -(-F // _FT), -(-Cout // _OUT_TILES[ro]),
        torch.cuda.current_stream(x_hat.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spectral_contraction launch failed: cudaError {err}")
    key = "spectral_contraction/float32"
    launches[key] = launches.get(key, 0) + 1
    path = f"{key}/o{_OUT_TILES[ro]}"
    path_launches[path] = path_launches.get(path, 0) + 1
    return out
