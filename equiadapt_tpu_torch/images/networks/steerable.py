"""SO(2)-steerable CNN from circular-harmonic filter bases (eval path).

Counterpart of `equiadapt_tpu/images/networks/steerable.py`. A field of
rotation order m is one real channel (m = 0) or a (re, im) channel pair.
A kernel from order m_in to order m_out is rho(r) e^{i (m_out - m_in) phi},
rho expanded in Gaussian rings with one learnable complex coefficient per
(out field, in field, ring); the parameters keep the Flax names and shapes
(`w_{fo}_{fi}`, (J, 2)), so weights carry across as a copy.

The real kernel is assembled from the JAX module's blocks (k_re = sum_j
a_j B_re - b_j B_im, k_im = sum_j a_j B_im + b_j B_re, placed and signed
as the real form of the complex product): every (out, in) channel pair of
the kernel is one block entry, so the kernel is one batched product of
each pair's 2 J coefficients with its signed ring basis, both gathered by
a host-built plan. Work and memory grow with the kernel's size times 2 J,
not with its product with the number of coefficients. Takes NHWC like the
JAX module, runs NCHW inside.

A convolution takes one of two paths (`ops.kernels.spectral_conv.
conv_path`, from the call's grad mode, dtype, stride and shapes; counters
`paths/steerable_conv/{spectral,direct}`, one an eager call): "direct",
one `F.conv2d` with the OIHW kernel (grad mode on, a bf16 input, another
stride, and shapes where it counts fewer operations), or "spectral" for
an fp32 call at stride 1 under grad mode off whose shapes favour it: two real FFTs around a channel
contraction bin by bin (`spectral_conv2d`; the hand-written kernel of
`csrc/spectral_conv.cu` on the card), fp32 throughout, the same
cross-correlation up to fp32 rounding of the transforms.

Serving keeps the host out of the card's way. With grad mode off
(`torch.no_grad()`, `torch.inference_mode()`) a `SteerableConv` assembles
its kernel once per weight change and reuses it, already cast to the
input's dtype (on the spectral path with the kernel's spectrum), while
every coefficient leaf is the same tensor with the same storage pointer
and version counter, on the input's device and dtype (counters
`steerable/kernel_cache_hit` and `..._miss` in
`utils.profiling.counters()`). With grad mode on it assembles the kernel
on every call, so autograd sees it, and drops what it kept.
`NormNonlinearity` indexes with tensors kept on the module's device, so no
call copies an index from the host or waits for the card.

Dtypes follow the JAX module: a convolution runs in its input's dtype
(fp32 parameters cast), and `NormBatchNorm` multiplies by its fp32 scale,
which promotes a bf16 input to fp32. So with bf16 input only the first
convolution runs in bf16, and the output vectors are fp32.

`training` is an argument, as in the JAX module and the port's discrete
family; the torch module mode is not read. In training `NormBatchNorm`
normalizes by the batch statistics and updates its running ones.
"""

from __future__ import annotations

import functools
import math
import operator
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from equiadapt_tpu_torch.common.layers import global_mean, stats_shard
from equiadapt_tpu_torch.ops.kernels.spectral_conv import (
    conv_path, fft_shape, kernel_spectrum, spectral_conv2d)
from equiadapt_tpu_torch.utils.profiling import count

Tensor = torch.Tensor

__all__ = ["SteerableConv", "NormNonlinearity", "NormBatchNorm", "SteerableNetwork"]


def _field_channels(orders: Sequence[int]) -> int:
    return sum(1 if m == 0 else 2 for m in orders)


@functools.lru_cache(maxsize=None)
def _harmonic_basis(kernel_size: int, dm: int) -> np.ndarray:
    """(J, K, K, 2) basis of angular order difference dm: [cos, sin](dm phi)
    times ring j, L2-normalized per ring; rings at radii 0..K//2 with
    sigma 0.6, the r = 0 ring left out for dm != 0. Built in float64,
    returned as float32."""
    K = kernel_size
    c = (K - 1) / 2.0
    ys, xs = np.mgrid[0:K, 0:K].astype(np.float64)
    x = xs - c
    y = ys - c
    r = np.sqrt(x * x + y * y)
    # math-convention angle (y up), so order-1 outputs co-rotate with the
    # canonicalizer's image rotation
    phi = np.arctan2(-y, x)
    sigma = 0.6
    max_r = K // 2
    rings = []
    for j in range(0 if dm == 0 else 1, max_r + 1):
        radial = np.exp(-((r - j) ** 2) / (2 * sigma**2))
        radial[r > max_r + 0.5] = 0.0
        if dm != 0:
            radial[r == 0.0] = 0.0  # no phase at the centre
        re = radial * np.cos(dm * phi)
        im = radial * np.sin(dm * phi)
        norm = np.sqrt((re**2 + im**2).sum()) + 1e-12
        rings.append(np.stack([re / norm, im / norm], axis=-1))
    return np.asarray(rings, dtype=np.float32)


def _coefficient_names(in_orders, out_orders) -> List[Tuple[str, int, int]]:
    """(name, fi, fo) of each coefficient, in the Flax creation order."""
    return [(f"w_{fo}_{fi}", fi, fo)
            for fi in range(len(in_orders)) for fo in range(len(out_orders))]


@functools.lru_cache(maxsize=None)
def _assembly_plan(in_orders: Tuple[int, ...], out_orders: Tuple[int, ...],
                   kernel_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(index (Cout * Cin, 2 J) int64, weights (Cout * Cin, 2 J, K * K)
    float32) with, for the OIHW kernel's channel pair p = out * Cin + in,
    kernel[p] = sum_t theta[index[p, t]] * weights[p, t]: theta the
    concatenated (J, 2) coefficients in `_coefficient_names` order with a
    zero appended, which the padding (rings past a block's J) points at.

    Every channel pair is one entry of one block: the real (re) or the
    imaginary (im) part of that block's complex kernel, signed as the real
    form of the complex product; re draws (a_j, B_re) and (b_j, -B_im), im
    draws (a_j, B_im) and (b_j, B_re).
    """
    K = kernel_size
    Cin, Cout = _field_channels(in_orders), _field_channels(out_orders)
    cin_of = np.cumsum([0] + [1 if m == 0 else 2 for m in in_orders])
    cout_of = np.cumsum([0] + [1 if m == 0 else 2 for m in out_orders])
    names = _coefficient_names(in_orders, out_orders)
    bases = [_harmonic_basis(K, out_orders[fo] - in_orders[fi])
             for _, fi, fo in names]
    J = max(b.shape[0] for b in bases)
    index = np.full((Cout * Cin, 2 * J), sum(2 * b.shape[0] for b in bases),
                    np.int64)
    weights = np.zeros((Cout * Cin, 2 * J, K * K), np.float32)
    offset = 0
    for (_, fi, fo), b in zip(names, bases):
        nj = b.shape[0]
        b_re = b[..., 0].reshape(nj, K * K)
        b_im = b[..., 1].reshape(nj, K * K)
        mi, mo = in_orders[fi], out_orders[fo]
        co, ci = cout_of[fo], cin_of[fi]
        entries = [(co, ci, "re", 1.0)]
        if mi == 0 and mo != 0:  # complex kernel times a real input
            entries.append((co + 1, ci, "im", 1.0))
        elif mi != 0 and mo == 0:  # real part of the complex product
            entries.append((co, ci + 1, "im", -1.0))
        elif mi != 0:  # the complex product
            entries += [(co, ci + 1, "im", -1.0), (co + 1, ci, "im", 1.0),
                        (co + 1, ci + 1, "re", 1.0)]
        for o, i, part, sign in entries:
            p = o * Cin + i
            index[p, :2 * nj] = offset + np.arange(2 * nj)  # a_0, b_0, a_1, ...
            if part == "re":
                weights[p, 0:2 * nj:2], weights[p, 1:2 * nj:2] = sign * b_re, -sign * b_im
            else:
                weights[p, 0:2 * nj:2], weights[p, 1:2 * nj:2] = sign * b_im, sign * b_re
        offset += 2 * nj
    return index, weights


class _KernelCache(NamedTuple):
    """An assembled kernel, its spectrum at the FFT size `fft` (None on the
    direct path), and the leaves it was assembled from."""

    kernel: Tensor
    spectrum: Optional[Tensor]
    fft: Optional[Tuple[int, int]]
    leaves: List[Tensor]
    storages: list  # held so that no new leaf storage can take a freed address
    pointers: List[int]
    versions: List[int]


class SteerableConv(nn.Module):
    """Equivariant convolution between collections of SO(2) fields, on
    NCHW tensors. Parameters `w_{fo}_{fi}` (J, 2) as in Flax; `kernel()`
    assembles the OIHW kernel from them (`_assembly_plan`).

    With grad mode on, `forward` assembles the kernel on every call and
    drops any kept one. With grad mode off it keeps the kernel, cast to the
    input's dtype (and, on the spectral path, its spectrum at the call's FFT
    size), and reuses it while each leaf is the same tensor with the same
    `data_ptr()` and `_version` and the input's device, dtype and FFT size
    match; any other call assembles it anew (the same operations, so the
    same values) and keeps that. So an in-place write (a copy, an optimizer
    step), `p.data = ...`, `load_state_dict(assign=True)` or `.to()` is seen;
    a write that bypasses the version counter (an in-place write through
    `p.data`; FSDP2's all-gather into its unsharded parameters) is seen only
    through the next grad-on call. Traced calls (`torch.compile`,
    `torch.export`, tensor subclasses) take the path an eager call would,
    and assemble, keep and count nothing. Copies and pickles of the module
    start without the kept kernel."""

    _cache: Optional[_KernelCache] = None

    def __init__(self, in_orders: Sequence[int], out_orders: Sequence[int],
                 kernel_size: int, stride: int = 1, padding: int = 0, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_orders = tuple(in_orders)
        self.out_orders = tuple(out_orders)
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self._names = []
        for name, fi, fo in _coefficient_names(self.in_orders, self.out_orders):
            J = _harmonic_basis(kernel_size,
                                self.out_orders[fo] - self.in_orders[fi]).shape[0]
            p = nn.Parameter(torch.empty(J, 2, device=device))
            std = 1.0 / math.sqrt(J * max(1, len(self.in_orders)))
            nn.init.normal_(p, 0.0, std, generator=generator)
            self.register_parameter(name, p)
            self._names.append(name)
        index, weights = _assembly_plan(self.in_orders, self.out_orders,
                                        kernel_size)
        self.register_buffer("_index", torch.from_numpy(index).to(device),
                             persistent=False)
        self.register_buffer("_weights", torch.from_numpy(weights).to(device),
                             persistent=False)

    def kernel(self) -> Tensor:
        """The fp32 OIHW kernel."""
        theta = torch.cat([getattr(self, n).reshape(-1) for n in self._names]
                          + [self._weights.new_zeros(1)])
        K = self.kernel_size
        return torch.einsum("pt,ptq->pq", theta[self._index], self._weights).reshape(
            _field_channels(self.out_orders), _field_channels(self.in_orders), K, K)

    def __getstate__(self):
        state = super().__getstate__()
        state.pop("_cache", None)
        return state

    def _kept(self, x: Tensor, fft: Optional[Tuple[int, int]]) -> _KernelCache:
        """The kernel in x's dtype and, for a spectral call (`fft` the
        transforms' size), its spectrum, reused while the leaves are
        unchanged."""
        params = self._parameters
        leaves = [params[n] for n in self._names]
        pointers = list(map(Tensor.data_ptr, leaves))
        versions = [p._version for p in leaves]
        kept = self._cache
        if (kept is not None and kept.kernel.dtype == x.dtype
                and kept.kernel.device == x.device and kept.fft == fft
                and pointers == kept.pointers and versions == kept.versions
                and all(map(operator.is_, leaves, kept.leaves))):
            count("steerable/kernel_cache_hit")
            return kept
        count("steerable/kernel_cache_miss")
        kernel = self.kernel().to(x.dtype)
        spectrum = None if fft is None else kernel_spectrum(kernel, fft, self.padding)
        self._cache = _KernelCache(kernel, spectrum, fft, leaves,
                                   [p.untyped_storage() for p in leaves], pointers, versions)
        return self._cache

    def forward(self, x: Tensor) -> Tensor:
        K = self.kernel_size
        path = conv_path(x, _field_channels(self.out_orders), K, self.stride, self.padding)
        fft = fft_shape(*x.shape[-2:], self.padding) if path == "spectral" else None
        eager = type(x) is Tensor and not torch.compiler.is_compiling()
        if eager:
            count(f"paths/steerable_conv/{path}")
        if torch.is_grad_enabled():
            self._cache = None
        if eager and not torch.is_grad_enabled():
            kept = self._kept(x, fft)
            kernel, spectrum = kept.kernel, kept.spectrum
        else:
            kernel = self.kernel().to(x.dtype)
            spectrum = None if fft is None else kernel_spectrum(kernel, fft, self.padding)
        if fft is not None:
            return spectral_conv2d(x, spectrum, K, self.padding)
        return F.conv2d(x, kernel, stride=self.stride, padding=self.padding)


class NormNonlinearity(nn.Module):
    """Phase-preserving norm-ReLU, relu(|z| + b) z / |z|, for m != 0
    fields (parameters `bias_{fi}` (1,)); tanh-approximate GELU, which is
    Flax's `nn.gelu`, for m = 0 fields. NCHW. The channel indices
    (`_scalar`, `_re`, `_im`, `_order`) are int64 buffers on the module's
    device, outside the `state_dict`, so indexing makes no host copy."""

    def __init__(self, orders: Sequence[int], device="cuda"):
        super().__init__()
        self.orders = tuple(orders)
        scalar, re, im, self._bias_names = [], [], [], []
        ci = 0
        for fi, m in enumerate(self.orders):
            if m == 0:
                scalar.append(ci)
                ci += 1
            else:
                re.append(ci)
                im.append(ci + 1)
                name = f"bias_{fi}"
                self.register_parameter(
                    name, nn.Parameter(torch.zeros(1, device=device)))
                self._bias_names.append(name)
                ci += 2
        # channel c of cat([scalar, re, im]) back to its place
        order = np.argsort(scalar + re + im)
        for name, index in (("_scalar", scalar), ("_re", re), ("_im", im),
                            ("_order", order)):
            self.register_buffer(
                name, torch.as_tensor(index, dtype=torch.int64).to(device),
                persistent=False)

    def forward(self, x: Tensor) -> Tensor:
        parts = [F.gelu(x[:, self._scalar], approximate="tanh")]
        if self._bias_names:
            z_re, z_im = x[:, self._re], x[:, self._im]
            norm = torch.sqrt(z_re * z_re + z_im * z_im + 1e-8)
            b = torch.cat([getattr(self, n) for n in self._bias_names])
            gate = torch.relu(norm + b[None, :, None, None])
            parts += [gate * z_re / norm, gate * z_im / norm]
        return torch.cat(parts, dim=1)[:, self._order]


class NormBatchNorm(nn.Module):
    """Each field times `scale` over the RMS of its norm:
    z * scale / sqrt(s + eps), `scale` (params) and the running `norm_sq`
    (batch_stats) of shape (fields,). Not a `_BatchNorm`: its leaves are
    its own. NCHW.

    Eval: s = norm_sq. Training: s is the batch statistic, the mean over
    (B, H, W) of each field's sum of squares (taken in x's dtype, as the JAX
    module), and the running statistic moves by Flax's convention,
    norm_sq <- momentum norm_sq + (1 - momentum) s (Flax's default 0.9;
    torch's momentum would be 0.1)."""

    def __init__(self, orders: Sequence[int], momentum: float = 0.9,
                 epsilon: float = 1e-5, device="cuda"):
        super().__init__()
        self.orders = tuple(orders)
        self.momentum = momentum
        self.epsilon = epsilon
        n = len(self.orders)
        self.scale = nn.Parameter(torch.ones(n, device=device))
        self.register_buffer("norm_sq", torch.ones(n, device=device))
        field = [fi for fi, m in enumerate(self.orders)
                 for _ in range(1 if m == 0 else 2)]
        self.register_buffer("_field", torch.tensor(field, device=device),
                             persistent=False)

    def forward(self, x: Tensor, training: bool = False) -> Tensor:
        shape = (1, -1, 1, 1)
        scale = self.scale[self._field].reshape(shape)
        if not training:
            denom = torch.sqrt(self.norm_sq[self._field] + self.epsilon).reshape(shape)
            return x * scale / denom
        B, _, H, W = x.shape
        per_field = x.new_zeros(B, len(self.orders), H, W).index_add_(
            1, self._field, x * x)
        shard = stats_shard(training, "NormBatchNorm")
        batch = (per_field.mean(dim=(0, 2, 3)) if shard is None
                 else global_mean(per_field, (0, 2, 3), shard))
        with torch.no_grad():
            self.norm_sq.mul_(self.momentum).add_(
                batch.float(), alpha=1.0 - self.momentum)
        return x * scale / torch.sqrt(batch[self._field] + self.epsilon).reshape(shape)


class SteerableNetwork(nn.Module):
    """NHWC images -> (B, num_vectors, 2) frame vectors: trivial input
    fields, `num_layers` blocks of SteerableConv -> NormBatchNorm ->
    NormNonlinearity over `out_channels` fields of each order 0, 1, 2, then
    a SteerableConv to `num_vectors` order-1 fields, averaged over space.
    SO(2) only: `group_type` must be "rotation" (the reference asserts it;
    another value raises), and `num_rotations` is accepted and unused, as
    in the JAX module."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 9,
                 num_layers: int = 1, num_vectors: int = 2,
                 group_type: str = "rotation", num_rotations: int = -1,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        if group_type != "rotation":
            raise ValueError(
                f"SteerableNetwork is SO(2) only: group_type 'rotation', got {group_type!r}")
        self.num_vectors = num_vectors
        hidden = (0,) * out_channels + (1,) * out_channels + (2,) * out_channels
        cur = (0,) * in_channels
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"SteerableConv_{i}", SteerableConv(
                cur, hidden, kernel_size, device=device, generator=generator))
            self.add_module(f"NormBatchNorm_{i}", NormBatchNorm(hidden, device=device))
            self.add_module(f"NormNonlinearity_{i}",
                            NormNonlinearity(hidden, device=device))
            cur = hidden
        self.add_module(f"SteerableConv_{num_layers}", SteerableConv(
            cur, (1,) * num_vectors, kernel_size, device=device, generator=generator))

    def forward(self, x: Tensor, training: bool = False) -> Tensor:
        h = x.permute(0, 3, 1, 2)
        for i in range(self.num_layers):
            h = getattr(self, f"SteerableConv_{i}")(h)
            h = getattr(self, f"NormBatchNorm_{i}")(h, training)
            h = getattr(self, f"NormNonlinearity_{i}")(h)
        h = getattr(self, f"SteerableConv_{self.num_layers}")(h)
        v = h.mean(dim=(2, 3))
        return v.reshape(v.shape[0], self.num_vectors, 2)
