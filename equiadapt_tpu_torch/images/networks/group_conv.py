"""Discrete-group equivariant convolutions (C_n / D_n GCNN layers).

Counterpart of `equiadapt_tpu/images/networks/group_conv.py`. The layers
run on NCHW tensors internally; their parameters keep the JAX shapes
(`weights` (K, K, Ci, Co) for a lift, (K, K, Ci, |G|, Co) for a group conv,
`bias` (Co,)), so weights carry across as a copy. The |G| filter bank is
built on every forward from the parameters: a host-side tap matrix per
static angle rotates the filters (kornia `rotate` semantics, zeros fill,
exact permutations at multiples of 90 degrees), then one `F.conv2d` runs
over C * |G| channels.

The fiber layout is C-major / G-minor, channel = c * |G| + g, which the
invert's fiber roll relies on. D_n fibers are [r_0..r_{n-1}, m r_0..m r_{n-1}].
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from equiadapt_tpu_torch.ops.warp import _angle_tuple

Tensor = torch.Tensor

__all__ = [
    "RotationEquivariantConvLift",
    "RotoReflectionEquivariantConvLift",
    "RotationEquivariantConv",
    "RotoReflectionEquivariantConv",
]


def _fold_avg_pool(bank: Tensor) -> Tensor:
    """Fold a trailing 2x2 / stride-2 average pool into OIHW filters:
    avg_pool(conv_K(x, w)) == conv_{K+1, stride 2}(x, w') with
    w'[u, v] = (w[u, v] + w[u-1, v] + w[u, v-1] + w[u-1, v-1]) / 4."""
    p00 = F.pad(bank, (0, 1, 0, 1))
    p10 = F.pad(bank, (0, 1, 1, 0))
    p01 = F.pad(bank, (1, 0, 0, 1))
    p11 = F.pad(bank, (1, 0, 1, 0))
    return 0.25 * (p00 + p10 + p01 + p11)


@functools.lru_cache(maxsize=64)
def _rotation_tap_matrix(K: int, angles: tuple) -> np.ndarray:
    """(G, K*K, K*K) fp32 tap matrices: T[g] @ vec(w) == vec(rotate(w, g)),
    bilinear with zeros fill; multiples of 90 degrees snap to exact
    permutations."""
    G = len(angles)
    c = (K - 1) / 2.0
    gy, gx = np.meshgrid(
        np.arange(K, dtype=np.float64), np.arange(K, dtype=np.float64),
        indexing="ij",
    )
    dst = (gy.astype(np.int64) * K + gx.astype(np.int64)).ravel()
    T = np.zeros((G, K * K, K * K), np.float32)
    for g, ang in enumerate(angles):
        ang = float(ang) % 360.0
        k90 = ang / 90.0
        if abs(k90 - round(k90)) < 1e-9:
            rad = math.radians(90.0 * round(k90))
            a, b = round(math.cos(rad)), round(math.sin(rad))
        else:
            rad = math.radians(ang)
            a, b = math.cos(rad), math.sin(rad)
        sx = a * (gx - c) - b * (gy - c) + c
        sy = b * (gx - c) + a * (gy - c) + c
        x0 = np.floor(sx)
        y0 = np.floor(sy)
        fx = sx - x0
        fy = sy - y0
        for ddx, ddy, w in (
            (0, 0, (1 - fx) * (1 - fy)),
            (1, 0, fx * (1 - fy)),
            (0, 1, (1 - fx) * fy),
            (1, 1, fx * fy),
        ):
            xi = x0 + ddx
            yi = y0 + ddy
            valid = (xi >= 0) & (xi <= K - 1) & (yi >= 0) & (yi <= K - 1)
            xc = np.clip(xi, 0, K - 1).astype(np.int64)
            yc = np.clip(yi, 0, K - 1).astype(np.int64)
            np.add.at(
                T[g], (dst, (yc * K + xc).ravel()),
                (w * valid).ravel().astype(np.float32),
            )
    return T


def _rotate_bank(w_img: Tensor, angles: tuple) -> Tensor:
    """Rotate filters by static angles.

    Args:
        w_img: (K, K, F) shared filters, or (G, K, K, F) one set per element.
        angles: length-G tuple of degrees.

    Returns:
        (G, K, K, F) rotated filters.
    """
    G = len(angles)
    K = w_img.shape[-3]
    F_ = w_img.shape[-1]
    T = torch.from_numpy(_rotation_tap_matrix(K, tuple(float(a) for a in angles)))
    T = T.to(device=w_img.device, dtype=w_img.dtype)
    if w_img.dim() == 3:
        out = torch.matmul(T, w_img.reshape(K * K, F_))
    else:
        out = torch.matmul(T, w_img.reshape(G, K * K, F_))
    return out.reshape(G, K, K, F_)


def _rotation_perm_indices(n: int) -> np.ndarray:
    """(n, n): output element j reads input fiber (k - j) mod n."""
    k = np.arange(n)[None, :]
    j = np.arange(n)[:, None]
    return (k - j) % n


def _dihedral_perm_indices(n: int) -> np.ndarray:
    """(2n, 2n) fiber gather table of D_n (group_conv.py module docstring)."""
    fwd = _rotation_perm_indices(n)
    inv = (np.arange(n)[None, :] + np.arange(n)[:, None]) % n
    upper = np.concatenate([fwd, inv + n], axis=1)
    lower = np.concatenate([inv + n, fwd], axis=1)
    return np.concatenate([upper, lower], axis=0)


class _GroupConvBase(nn.Module):
    """Parameters in the JAX shapes and the conv around a built bank."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 num_rotations: int, stride: int, padding: int, use_bias: bool,
                 weight_shape: tuple, device, dtype: Optional[torch.dtype],
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.num_rotations = num_rotations
        self.stride = stride
        self.padding = padding
        self.compute_dtype = dtype
        self.weights = nn.Parameter(torch.empty(weight_shape, device=device))
        self.bias = (
            nn.Parameter(torch.zeros(out_channels, device=device))
            if use_bias else None
        )
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """torch kaiming_uniform_(a=sqrt(5)): U(+-1/sqrt(fan_in)), fan_in =
        prod(shape[:-1]) of the HWIO-style weights; zero bias."""
        bound = 1.0 / math.sqrt(int(np.prod(self.weights.shape[:-1])))
        with torch.no_grad():
            nn.init.uniform_(self.weights, -bound, bound, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def _conv(self, x: Tensor, bank: Tensor, stride: int, G: int) -> Tensor:
        dt = self.compute_dtype or x.dtype
        y = F.conv2d(x.to(dt), bank.to(dt), stride=stride, padding=self.padding)
        if self.bias is not None:
            y = y + torch.repeat_interleave(self.bias.to(dt), G)[None, :, None, None]
        return y


class RotationEquivariantConvLift(_GroupConvBase):
    """Lifting conv: scalar NCHW input -> C_n regular-rep map (Co * n)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 num_rotations: int = 4, stride: int = 1, padding: int = 0,
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None,
                 fused_pool: bool = False, device="cuda",
                 generator: Optional[torch.Generator] = None):
        K, Ci, Co = kernel_size, in_channels, out_channels
        super().__init__(Ci, Co, K, num_rotations, stride, padding, use_bias,
                         (K, K, Ci, Co), device, dtype, generator)
        self.fused_pool = fused_pool

    def _bank(self, rot: Tensor, G: int) -> Tensor:
        """(G, K, K, Ci*Co) rotated filters -> OIHW, out channel c * G + g."""
        K, Ci, Co = self.kernel_size, self.in_channels, self.out_channels
        bank = rot.reshape(G, K, K, Ci, Co).permute(4, 0, 3, 1, 2)
        return bank.reshape(Co * G, Ci, K, K)

    def _lift(self, x: Tensor, bank: Tensor, G: int) -> Tensor:
        stride = self.stride
        if self.fused_pool:
            if self.stride != 1:
                raise ValueError("fused_pool composes with stride-1 convs")
            bank = _fold_avg_pool(bank)
            stride = 2
        return self._conv(x, bank, stride, G)

    def forward(self, x: Tensor) -> Tensor:
        K, n = self.kernel_size, self.num_rotations
        rot = _rotate_bank(self.weights.reshape(K, K, -1), _angle_tuple(n))
        return self._lift(x, self._bank(rot, n), n)


class RotoReflectionEquivariantConvLift(RotationEquivariantConvLift):
    """Lifting conv: scalar NCHW input -> D_n regular-rep map (Co * 2n)."""

    def forward(self, x: Tensor) -> Tensor:
        K, n = self.kernel_size, self.num_rotations
        rot = _rotate_bank(self.weights.reshape(K, K, -1), _angle_tuple(n))
        ref = torch.flip(rot, dims=(2,))  # hflip on the width axis
        bank = self._bank(torch.cat([rot, ref], dim=0), 2 * n)
        return self._lift(x, bank, 2 * n)


class RotationEquivariantConv(_GroupConvBase):
    """Group-to-group conv on C_n regular-rep NCHW maps (C * n channels)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 num_rotations: int = 4, stride: int = 1, padding: int = 0,
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None,
                 device="cuda", generator: Optional[torch.Generator] = None):
        K, Ci, Co = kernel_size, in_channels, out_channels
        super().__init__(Ci, Co, K, num_rotations, stride, padding, use_bias,
                         (K, K, Ci, self._fiber(num_rotations), Co), device,
                         dtype, generator)

    @staticmethod
    def _fiber(n: int) -> int:
        return n

    @staticmethod
    def _perm(n: int) -> np.ndarray:
        return _rotation_perm_indices(n)

    def _angles(self) -> tuple:
        return _angle_tuple(self.num_rotations)

    def _bank(self) -> Tensor:
        K, Ci, Co = self.kernel_size, self.in_channels, self.out_channels
        G = self._fiber(self.num_rotations)
        perm = torch.from_numpy(self._perm(self.num_rotations)).to(
            self.weights.device
        )
        # wp[j] = w[..., perm[j], :]: (K, K, Ci, G_out, G_in, Co)
        wp = self.weights[:, :, :, perm, :]
        wp = wp.permute(3, 0, 1, 2, 4, 5).reshape(G, K, K, Ci * G * Co)
        bank = _rotate_bank(wp, self._angles())
        return self._flip_reflections(bank)

    def _flip_reflections(self, bank: Tensor) -> Tensor:
        return bank

    def forward(self, x: Tensor) -> Tensor:
        K, Ci, Co = self.kernel_size, self.in_channels, self.out_channels
        G = self._fiber(self.num_rotations)
        # (G_out, K, K, Ci, G_in, Co) -> OIHW (Co * G_out, Ci * G_in, K, K)
        bank = self._bank().reshape(G, K, K, Ci, G, Co).permute(5, 0, 3, 4, 1, 2)
        return self._conv(x, bank.reshape(Co * G, Ci * G, K, K), self.stride, G)


class RotoReflectionEquivariantConv(RotationEquivariantConv):
    """Group-to-group conv on D_n regular-rep NCHW maps (C * 2n channels)."""

    @staticmethod
    def _fiber(n: int) -> int:
        return 2 * n

    @staticmethod
    def _perm(n: int) -> np.ndarray:
        return _dihedral_perm_indices(n)

    def _angles(self) -> tuple:
        return _angle_tuple(self.num_rotations) * 2

    def _flip_reflections(self, bank: Tensor) -> Tensor:
        n = self.num_rotations
        return torch.cat([bank[:n], torch.flip(bank[n:], dims=(2,))], dim=0)
