"""Fused k-nearest-neighbour indices (K8).

Counterpart of `equiadapt_tpu/ops/pallas/knn.py` (`pallas_knn_indices`):
for points (B, N, D), the (B, N, k) int32 indices of each point's k nearest
points by negative squared distance d = (2 <q, p> - |q|^2) - |p|^2, nearest
first, self included, by k rounds of first-occurrence argmax with each pick
masked to -inf. Input is fp32 or bf16 and the distances are fp32.

`knn_indices` launches the hand-written CUDA kernel of `csrc/knn.cu` for
CUDA tensors, takes the plain PyTorch version `knn_indices_plain` for CPU
tensors, and raises for anything else. The kernel never writes the
(B, N, N) matrix; the plain version does. Both follow torch.argmax's order
(NaN above every number, ties to the first index), so a NaN distance never
yields an index outside [0, N).

Numerics: at D <= 4 both compute the distances with the same fixed-order
fp32 products and sums, the JAX package's algebra, and agree bit for bit.
At D > 4 the plain version takes a matrix product (`torch.einsum`) and the
kernel its own fp32 dot product, so their indices may differ only where
two distances tie at fp32 level, as the JAX package states for its fused
and exact modes.

`launches` counts kernel launches by dtype and distance branch, e.g.
`launches["knn_indices/float32/d<=4"]`.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from equiadapt_tpu_torch.ops.kernels import _build

Tensor = torch.Tensor

__all__ = ["knn_indices", "knn_indices_plain", "launches", "reset_launches",
           "MAX_N", "MAX_D", "MAX_K"]

_KERNELS = "the kNN kernel"

# the kernel's limits: the row of N fp32 distances of each of a block's 8
# query rows and a transposed (32, D) point tile share one block's shared
# memory (170 KB at the limits); k rounds each scan the whole row, so a
# larger k is a sort's work
MAX_N, MAX_D, MAX_K = 4096, 256, 128

# kernel launches by dtype and branch, e.g. launches["knn_indices/bfloat16/d>4"]
launches: Dict[str, int] = {}


def reset_launches() -> None:
    launches.clear()


def _lib() -> ctypes.CDLL:
    lib = _build.load("knn")
    fn = lib.eqt_knn_indices
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, vp, vp, ci, ci, ci, ci, vp]
        fn.restype = ci
    return lib


def _neg_sq_dist(points: Tensor) -> Tensor:
    """(B, N, N) fp32 d[b, i, j] = (2 <p_i, p_j> - |p_i|^2) - |p_j|^2."""
    p = points.float()
    D = p.shape[-1]
    if D <= 4:
        # fixed-order elementwise products and sums: the kernel's and the
        # JAX package's algebra, one (B, N, N) term per coordinate
        pt = p.transpose(1, 2)
        inner = p[:, :, 0, None] * pt[:, None, 0, :]
        for d in range(1, D):
            inner = inner + p[:, :, d, None] * pt[:, None, d, :]
        sq = p[..., 0] * p[..., 0]
        for d in range(1, D):
            sq = sq + p[..., d] * p[..., d]
    else:
        inner = torch.einsum("bnd,bmd->bnm", p, p)
        sq = torch.sum(p * p, dim=-1)
    return 2 * inner - sq[:, :, None] - sq[:, None, :]


def knn_indices_plain(points: Tensor, k: int) -> Tensor:
    """Plain version of K8: the (B, N, N) distances, then k rounds of
    `torch.argmax` with each pick set to -inf. (B, N, k) int32."""
    d = _neg_sq_dist(points)
    picks = []
    for _ in range(k):
        am = torch.argmax(d, dim=-1, keepdim=True)
        picks.append(am)
        d.scatter_(-1, am, float("-inf"))
    return torch.cat(picks, dim=-1).int()


def knn_indices(points: Tensor, k: int) -> Tensor:
    """K8: (B, N, D) points -> (B, N, k) int32 neighbour indices, nearest
    first, self included."""
    if points.dim() != 3:
        raise ValueError(f"expected points (B, N, D), got {tuple(points.shape)}")
    N = points.shape[1]
    if not 1 <= k <= N:
        raise ValueError(f"k must lie in [1, N = {N}], got {k}")
    if _build.route([points], _KERNELS) == "cpu":
        return knn_indices_plain(points, k)
    return _launch(points, k)


def _launch(points: Tensor, k: int) -> Tensor:
    B, N, D = points.shape
    if points.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{_KERNELS} takes float32 or bfloat16, got {points.dtype}")
    if not points.is_contiguous():
        raise ValueError(f"{_KERNELS} needs contiguous (B, N, D) points")
    if B > 65535 or N > MAX_N or D > MAX_D or k > MAX_K:
        raise ValueError(
            f"{_KERNELS} takes B <= 65535, N <= {MAX_N}, D <= {MAX_D} and "
            f"k <= {MAX_K}; got (B, N, D) = {tuple(points.shape)}, k = {k}")
    out = torch.empty(B, N, k, dtype=torch.int32, device=points.device)
    err = _lib().eqt_knn_indices(
        _build.DTYPE_CODES[points.dtype], points.data_ptr(), out.data_ptr(),
        B, N, D, k, torch.cuda.current_stream(points.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"knn_indices launch failed: cudaError {err}")
    branch = "d<=4" if D <= 4 else "d>4"
    key = f"knn_indices/{str(points.dtype).removeprefix('torch.')}/{branch}"
    launches[key] = launches.get(key, 0) + 1
    return out
