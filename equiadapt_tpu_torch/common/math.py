"""Batched frame math shared by the canonicalizers.

Counterpart of `equiadapt_tpu/common/math.py`. The two 3-D
orthogonalizations stay distinct, as in the JAX package: point clouds use
classical Gram-Schmidt (the raw third vector projected on u1 and u2),
n-body uses modified Gram-Schmidt (sequential re-projection), and the two
differ in fp32 for ill-conditioned frames.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

__all__ = [
    "gram_schmidt",
    "modified_gram_schmidt",
    "gram_schmidt_2d",
    "rotmat_2d_from_vector",
    "det_2x2",
]


def _unit(v: Tensor) -> Tensor:
    """Normalize along the last axis, with no epsilon: a zero vector gives
    NaN, as in the JAX package."""
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.sum(a * b, dim=-1, keepdim=True)


def gram_schmidt(vectors: Tensor) -> Tensor:
    """Classical Gram-Schmidt of three 3-vectors: (..., 3, 3) rows in,
    orthonormal rows out; v3 is projected with the raw third vector."""
    v1 = _unit(vectors[..., 0, :])
    v2 = _unit(vectors[..., 1, :] - _dot(vectors[..., 1, :], v1) * v1)
    v3 = (
        vectors[..., 2, :]
        - _dot(vectors[..., 2, :], v1) * v1
        - _dot(vectors[..., 2, :], v2) * v2
    )
    return torch.stack([v1, v2, _unit(v3)], dim=-2)


def modified_gram_schmidt(vectors: Tensor) -> Tensor:
    """Modified Gram-Schmidt of three 3-vectors: v3 is orthogonalized
    against v1, then the result against v2."""
    v1 = _unit(vectors[..., 0, :])
    v2 = _unit(vectors[..., 1, :] - _dot(vectors[..., 1, :], v1) * v1)
    v3 = vectors[..., 2, :] - _dot(vectors[..., 2, :], v1) * v1
    v3 = v3 - _dot(v3, v2) * v2
    return torch.stack([v1, v2, _unit(v3)], dim=-2)


def gram_schmidt_2d(vectors: Tensor) -> Tensor:
    """Gram-Schmidt of two 2-vectors, (..., 2, 2) rows: an O(2) frame,
    possibly with determinant -1."""
    v1 = _unit(vectors[..., 0, :])
    v2 = _unit(vectors[..., 1, :] - _dot(vectors[..., 1, :], v1) * v1)
    return torch.stack([v1, v2], dim=-2)


def rotmat_2d_from_vector(v: Tensor) -> Tensor:
    """(..., 2) vector -> (..., 2, 2) rotation with rows [v_hat, (-y, x)]."""
    v1 = _unit(v)
    v2 = torch.stack([-v1[..., 1], v1[..., 0]], dim=-1)
    return torch.stack([v1, v2], dim=-2)


def det_2x2(m: Tensor) -> Tensor:
    """Determinant of (..., 2, 2) matrices."""
    return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
