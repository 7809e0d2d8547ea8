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

The kernel orders by a packed key: `order_key` maps each fp32 distance to
an integer whose order is the rounds' pick order (every NaN above +inf,
-0.0 tied with +0.0, ties to the smaller index), and `select_by_order_key`
is the plain model of its selection, held against the rounds by the CPU
tests.

`launches` counts kernel launches by dtype and distance branch, e.g.
`launches["knn_indices/float32/d<=4"]`.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from equiadapt_tpu_torch.ops.kernels import _build

Tensor = torch.Tensor

__all__ = ["knn_indices", "knn_indices_plain", "argmax_rounds", "order_key",
           "select_by_order_key", "launches", "reset_launches", "MAX_N",
           "MAX_D", "MAX_K"]

_KERNELS = "the kNN kernel"

# the kernel's limits: at D > 4 and k <= 32 a block keeps 64 queries (D, 64)
# and a key chunk in shared memory (about 100 KB at the limits); otherwise
# a block's query rows of N order keys (up to 32 rows at N <= 1024, else 8)
# share it with the queries (at most 193 KB); above k = 32 the selection
# takes k rounds over each row, so a larger k is a sort's work
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


def argmax_rounds(d: Tensor, k: int) -> Tensor:
    """k rounds of `torch.argmax` over the last dimension of fp32 `d`, each
    pick set to -inf (in place): (..., k) int32."""
    picks = []
    for _ in range(k):
        am = torch.argmax(d, dim=-1, keepdim=True)
        picks.append(am)
        d.scatter_(-1, am, float("-inf"))
    return torch.cat(picks, dim=-1).int()


def knn_indices_plain(points: Tensor, k: int) -> Tensor:
    """Plain version of K8: the (B, N, N) distances, then k rounds of
    `torch.argmax` with each pick set to -inf. (B, N, k) int32."""
    return argmax_rounds(_neg_sq_dist(points), k)


_NEG_INF_KEY = 0x007FFFFF  # order_key(-inf)


def order_key(d: Tensor) -> Tensor:
    """The kernel's 32-bit order key of fp32 `d`, as int64 in [0, 2^32):
    every NaN to 2^32 - 1 (above +inf), -0.0 to +0.0's key, then the
    sign-magnitude bits to a monotone unsigned code."""
    bits = d.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
    bits = torch.where(bits == 0x80000000, torch.zeros_like(bits), bits)
    u = torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF, bits | 0x80000000)
    return torch.where(torch.isnan(d), torch.full_like(u, 0xFFFFFFFF), u)


def select_by_order_key(d: Tensor, k: int) -> Tensor:
    """Plain model of the kernel's selection over the last dimension of
    fp32 `d`: the k largest packed keys (order_key(d) << 32 | (2^32 - 1 -
    index), kept in int64 as that minus 2^63), in descending order; entries
    of -inf are never picked, and the slots they would fill take index 0,
    as the rounds' picks do once every entry above -inf is spent. (..., k)
    int32."""
    u = order_key(d)
    n = d.shape[-1]
    index = torch.arange(n, dtype=torch.int64, device=d.device)
    packed = ((u - 2**31) << 32) | (0xFFFFFFFF - index)
    packed = torch.where(u > _NEG_INF_KEY, packed,
                         torch.full_like(packed, torch.iinfo(torch.int64).min))
    top = torch.sort(packed, dim=-1, descending=True).values[..., :k]
    picks = 0xFFFFFFFF - (top & 0xFFFFFFFF)
    spent = top == torch.iinfo(torch.int64).min
    return torch.where(spent, torch.zeros_like(picks), picks).int()


def knn_indices(points: Tensor, k: int) -> Tensor:
    """K8: (B, N, D) points -> (B, N, k) int32 neighbour indices, nearest
    first, self included."""
    if points.dim() != 3:
        raise ValueError(f"expected points (B, N, D), got {tuple(points.shape)}")
    N = points.shape[1]
    if not 1 <= k <= N:
        raise ValueError(f"k must lie in [1, N = {N}], got {k}")
    where = _build.route([points], _KERNELS)
    if where == "meta":
        return points.new_empty((points.shape[0], N, k), dtype=torch.int32)
    if where == "cpu":
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
