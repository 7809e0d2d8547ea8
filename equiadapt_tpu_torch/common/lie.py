"""Lie-group representations (SO(n), O(n), SE(n), E(n)) as tensor functions.

Counterpart of `equiadapt_tpu/common/lie.py`. The matrix exponential is
`torch.linalg.matrix_exp` where the JAX package takes
`jax.scipy.linalg.expm`; both are accurate to fp32 rounding on the small
(n <= 4) per-sample matrices here, by different algorithms. Every function
works on its input's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

Tensor = torch.Tensor

__all__ = ["son_bases", "son_rep", "on_rep", "sen_rep", "en_rep",
           "LieParameterization"]


def son_bases(n: int) -> np.ndarray:
    """(n(n-1)/2, n, n) skew-symmetric basis of so(n): basis[k][i, j] = 1,
    basis[k][j, i] = -1 for each i < j in lexicographic order."""
    bases = np.zeros((n * (n - 1) // 2, n, n), dtype=np.float32)
    k = 0
    for i in range(n):
        for j in range(i + 1, n):
            bases[k, i, j] = 1.0
            bases[k, j, i] = -1.0
            k += 1
    return bases


def son_rep(params: Tensor, n: int) -> Tensor:
    """(B, n(n-1)/2) algebra coordinates -> (B, n, n) rotations, exp of
    the algebra element."""
    bases = torch.as_tensor(son_bases(n), dtype=params.dtype, device=params.device)
    return torch.linalg.matrix_exp(torch.einsum("bs,sij->bij", params, bases))


def on_rep(params: Tensor, reflect_indicators: Tensor, n: int) -> Tensor:
    """O(n): the SO(n) rotation right-multiplied by diag(1, ..., 1, -1)
    blended with the identity by `reflect_indicators` (B, 1) in [0, 1]."""
    rot = son_rep(params, n)
    refl = torch.diag(torch.tensor([1.0] * (n - 1) + [-1.0], dtype=rot.dtype,
                                   device=rot.device))
    eye = torch.eye(n, dtype=rot.dtype, device=rot.device)
    r = reflect_indicators[..., None]
    return torch.matmul(rot, r * refl + (1.0 - r) * eye)


def _homogeneous(linear: Tensor, translation: Tensor) -> Tensor:
    """(B, n+1, n+1) [[linear, t], [0, 1]]."""
    b, n = translation.shape
    out = torch.zeros(b, n + 1, n + 1, dtype=linear.dtype, device=linear.device)
    out[:, :n, :n] = linear
    out[:, :n, n] = translation
    out[:, n, n] = 1.0
    return out


def sen_rep(params: Tensor, n: int) -> Tensor:
    """SE(n) homogeneous (B, n+1, n+1): the first n(n-1)/2 params rotate,
    the next n translate."""
    k = n * (n - 1) // 2
    return _homogeneous(son_rep(params[:, :k], n), params[:, k:k + n])


def en_rep(params: Tensor, reflect_indicators: Tensor, n: int) -> Tensor:
    """E(n) homogeneous (B, n+1, n+1): roto-reflection and translation."""
    k = n * (n - 1) // 2
    return _homogeneous(on_rep(params[:, :k], reflect_indicators, n),
                        params[:, k:k + n])


@dataclasses.dataclass(frozen=True)
class LieParameterization:
    """`get_group_rep(params)` for group_type in {"SOn", "SEn", "On", "En"}
    and group_dim n."""

    group_type: str
    group_dim: int

    @property
    def num_rot_params(self) -> int:
        return self.group_dim * (self.group_dim - 1) // 2

    def get_group_rep(self, params: Tensor) -> Tensor:
        n = self.group_dim
        no_reflection = params.new_zeros(params.shape[0], 1)
        if self.group_type == "SOn":
            return son_rep(params, n)
        if self.group_type == "SEn":
            return sen_rep(params, n)
        if self.group_type == "On":
            return on_rep(params, no_reflection, n)
        if self.group_type == "En":
            return en_rep(params, no_reflection, n)
        raise ValueError(f"Unsupported group type: {self.group_type}")
