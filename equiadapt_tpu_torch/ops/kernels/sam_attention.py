"""SAM's attention with its decomposed relative-position bias, fused.

For q, k, v (B, N, heads, hd) over an H x W token grid (N = H * W) and the
bias tables rel_h (B, heads, N, H) and rel_w (B, heads, N, W) (the two
einsums of `models.sam_encoder.SamAttention`, q . R_h and q . R_w of the
unscaled q), each head's output is

    softmax_j((q_i . k_j) / sqrt(hd) + rel_h[i, j // W] + rel_w[i, j % W]) v_j

written as (B, N, heads * hd), the layout `proj` reads. Without tables the
bias is left out.

`sam_attention` launches the hand-written CUDA kernel of
`csrc/sam_attention.cu` for CUDA tensors and raises for any other (on the
CPU the port writes this attention out, and `sam_attention_plain` is the
kernel's function written out for the tests and `chip_smoke.py`). The
kernel replaces no TPU kernel: the JAX package writes this attention out as
products and a softmax, and so does the port's written-out path
(`SamAttention._attend`), which keeps the (B, heads, N, N) scores in
memory: 3.2 GB of bf16 a global block of SAM ViT-B at 1024 px (B 8, 12
heads, N 4096), biased in place and read three more times. The kernel's
source says what bounds it and how it is built (FlashAttention-2's online
softmax on mma.sync; the keys in slots of a power-of-two row width, so the
bias needs no division; the block's rows of both tables staged in shared
memory, the bias the scores' initial value). `attention_path` decides between the kernel and the
written-out path for a call, from what the call can observe: its device,
dtype, whether autograd needs it, and whether the kernel takes its head
width and grid (`kernel_takes`).

Tile plans (`_plan`, from N and the head width): a block is 4 warps of
MT m-tiles of 16 query rows. "global": sequences of at least LONG_N tokens
(SAM's whole-image grids), MT 2 (128 rows a block), so each K and V
fragment read from shared memory feeds two m-tiles; "window": shorter ones
(SAM's 14 x 14 windows), MT 1 (64 rows), twice the blocks. `launches` counts
the launches by dtype, `path_launches` by dtype and plan.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from equiadapt_tpu_torch.ops.kernels import _build

Tensor = torch.Tensor

__all__ = ["sam_attention", "sam_attention_plain", "attention_path", "kernel_takes",
           "needs_grad", "launches", "path_launches", "reset_launches"]

_KERNELS = "the fused SAM attention kernel"
_DIFFERENTIABLE = (
    "SamAttention's written-out path is the differentiable one, and "
    "`attention_path` sends a call that needs a gradient there")

# head widths the kernel is instantiated for (SAM ViT-B's; others take the
# written-out path)
HEAD_DIMS = (64,)
# sequences of at least this many tokens take the "global" plan (two
# m-tiles a warp)
LONG_N = 1024
# the dynamic shared memory a block may take on the card (H100: 227 KB)
MAX_SMEM = 232448
# the grid's second dimension (query tiles)
MAX_GRID_Y = 65535
# the grid's first dimension (B x heads)
MAX_GRID_X = 2**31 - 1
# the shared memory of a block (`Layout` and `Slots` in the source): key
# slots a tile, the padding of a q/k/v row (bf16) and of a table column
# (fp32), the fewest slots a key row
_BLOCK_N, _ROW_PAD, _TABLE_PAD, _MIN_SLOTS = 64, 8, 4, 8

# kernel launches by dtype and by dtype and plan, e.g.
# launches["sam_attention/bfloat16"], path_launches["sam_attention/bfloat16/global"]
launches: Dict[str, int] = {}
path_launches: Dict[str, int] = {}


def reset_launches() -> None:
    launches.clear()
    path_launches.clear()


def needs_grad(*tensors: Optional[Tensor]) -> bool:
    """True when autograd would record the attention: grad mode is on and
    a tensor among `tensors` requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _plan(B: int, N: int, nh: int) -> Tuple[str, int, Tuple[int, int]]:
    """(plan, MT, grid) of a launch: MT m-tiles a warp, the grid (B x
    heads, query tiles of 64 MT rows)."""
    path, mt = ("global", 2) if N >= LONG_N else ("window", 1)
    return path, mt, (B * nh, -(-N // (64 * mt)))


def _slots(H: int, W: int) -> Tuple[int, int, int]:
    """(SW, tiles, HP) of the keys' slots (`Slots` in the source): SW the
    power of two at or above W (at least 8), the key tiles of 64 slots
    over H rows of SW, HP the slot rows they cover."""
    sw = max(_MIN_SLOTS, 1 << (W - 1).bit_length())
    tiles = -(-H * sw // _BLOCK_N)
    return sw, tiles, -(-tiles * _BLOCK_N // sw)


def _smem(hd: int, mt: int, H: int, W: int, bias: bool) -> int:
    """A block's shared memory in bytes (`Layout` in the source): two
    buffers of a K and a V tile (the q tile in the second until the loop
    starts) and the tables' HP + SW fp32 columns of 64 MT rows."""
    sw, _, hp = _slots(H, W)
    fixed = 4 * _BLOCK_N * (hd + _ROW_PAD) * 2
    return fixed + ((hp + sw) * (64 * mt + _TABLE_PAD) * 4 if bias else 0)


def kernel_takes(hd: int, H: int, W: int) -> bool:
    """True when the kernel takes a head width of `hd` over an H x W grid:
    hd in HEAD_DIMS, the tables in shared memory, the query tiles within
    the grid's second dimension."""
    _, mt, (_, tiles) = _plan(1, H * W, 1)
    return (hd in HEAD_DIMS and _smem(hd, mt, H, W, True) <= MAX_SMEM
            and tiles <= MAX_GRID_Y)


def attention_path(device: torch.device, dtype: torch.dtype, grad: bool,
                   hd: int, H: int, W: int) -> str:
    """"fused" (the kernel) for a bf16 call on a card that needs no
    gradient, at a head width and grid the kernel takes; "written" (the
    scores written out, then the softmax) for every other: fp32, the CPU
    (and meta), a call whose probabilities autograd needs, or a shape the
    kernel has no plan for."""
    if (torch.device(device).type == "cuda" and dtype == torch.bfloat16 and not grad
            and kernel_takes(hd, H, W)):
        return "fused"
    return "written"


def _check(q: Tensor, k: Tensor, v: Tensor, rel_h: Optional[Tensor],
           rel_w: Optional[Tensor], H: int, W: int) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v of one shape (B, N, heads, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, N, nh, hd = q.shape
    if N != H * W:
        raise ValueError(f"N = {N} tokens is not the grid's {H} x {W}")
    if (rel_h is None) != (rel_w is None):
        raise ValueError("rel_h and rel_w go together (both or neither)")
    if rel_h is not None and (rel_h.shape != (B, nh, N, H) or rel_w.shape != (B, nh, N, W)):
        raise ValueError(f"rel_h ({B}, {nh}, {N}, {H}) and rel_w ({B}, {nh}, {N}, {W}), got "
                         f"{tuple(rel_h.shape)}, {tuple(rel_w.shape)}")
    dtypes = {t.dtype for t in (q, k, v, rel_h, rel_w) if t is not None}
    if len(dtypes) != 1:
        raise TypeError(f"q, k, v and the tables in one dtype, got {sorted(map(str, dtypes))}")


def sam_attention_plain(q: Tensor, k: Tensor, v: Tensor, rel_h: Optional[Tensor],
                        rel_w: Optional[Tensor], H: int, W: int) -> Tensor:
    """The kernel's function written out: fp32 scores of q scaled by
    hd^-0.5, the tables added in fp32, the softmax in fp32, the
    probabilities in v's dtype, their product with v summed in fp32;
    (B, N, heads * hd) in q's dtype."""
    _check(q, k, v, rel_h, rel_w, H, W)
    B, N, nh, hd = q.shape
    qh, kh = (t.transpose(1, 2).float() for t in (q, k))  # (B, heads, N, hd)
    s = (qh * hd ** -0.5) @ kh.transpose(-2, -1)
    if rel_h is not None:
        s.view(B, nh, N, H, W).add_(rel_h.float()[..., :, None]).add_(
            rel_w.float()[..., None, :])
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    out = p @ v.transpose(1, 2).float()
    return out.transpose(1, 2).reshape(B, N, nh * hd).to(q.dtype)


def _fake(q, k, v, rel_h, rel_w, H, W):
    B, N, nh, hd = q.shape
    return q.new_empty((B, N, nh * hd))


def sam_attention(q: Tensor, k: Tensor, v: Tensor, rel_h: Optional[Tensor],
                  rel_w: Optional[Tensor], H: int, W: int) -> Tensor:
    """The fused attention (module docstring) on the card: q, k, v
    (B, N, heads, hd), any strides with the head width contiguous; rel_h
    (B, heads, N, H) and rel_w (B, heads, N, W), or both None;
    (B, N, heads * hd) in q's dtype. Meta tensors inside
    `_build.shapes_only()` give an empty result of that shape."""
    _check(q, k, v, rel_h, rel_w, H, W)
    tensors = [t for t in (q, k, v, rel_h, rel_w) if t is not None]
    where = _build.route(tensors, _KERNELS)
    if where == "meta":
        return _fake(q, k, v, rel_h, rel_w, H, W)
    if where == "cpu":
        raise RuntimeError(
            f"{_KERNELS} runs on the card only: on the CPU SamAttention writes the "
            f"attention out (`attention_path`), and `sam_attention_plain` is the "
            f"kernel's function written out")
    _build.refuse_grad(tensors, _KERNELS, _DIFFERENTIABLE)
    return _attention_op(q, k, v, rel_h, rel_w, H, W)


# the kernel as a registered operator around `_launch` (`_build.register_op`)
_attention_op = _build.register_op(
    "sam_attention(Tensor q, Tensor k, Tensor v, Tensor? rel_h, Tensor? rel_w, "
    "int H, int W) -> Tensor",
    lambda q, k, v, rel_h, rel_w, H, W: _launch(q, k, v, rel_h, rel_w, H, W),
    _fake)


def _validate_launch(q: Tensor, k: Tensor, v: Tensor, rel_h: Optional[Tensor],
                     rel_w: Optional[Tensor], H: int, W: int) -> None:
    """What the kernel takes beyond `_check`: bf16; a head width and grid
    it has a plan for (`kernel_takes`); the last dimension of every
    operand contiguous; q, k and v rows of whole 16-byte words (every other
    stride a multiple of 8 elements, 16-byte aligned starts); B x heads
    within the grid's first dimension."""
    B, N, nh, hd = q.shape
    if q.dtype != torch.bfloat16:
        raise TypeError(f"{_KERNELS} takes bfloat16, got {q.dtype}")
    if not kernel_takes(hd, H, W):
        raise ValueError(f"{_KERNELS} takes head widths {HEAD_DIMS} over grids whose "
                         f"tables fit its shared memory; got {hd} over {H} x {W}")
    for name, t in (("q", q), ("k", k), ("v", v), ("rel_h", rel_h), ("rel_w", rel_w)):
        if t is not None and t.stride(-1) != 1:
            raise ValueError(f"{_KERNELS} reads {name}'s last dimension contiguous, "
                             f"got strides {t.stride()}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if any(s % 8 for s in t.stride()[:-1]) or t.data_ptr() % 16:
            raise ValueError(f"{_KERNELS} copies {name} in 16-byte words: strides a "
                             f"multiple of 8 and a 16-byte aligned start, got strides "
                             f"{t.stride()}")
    if B * nh > MAX_GRID_X:
        raise ValueError(f"grid limit: B x heads <= {MAX_GRID_X}, got {B} x {nh}")


def _lib() -> ctypes.CDLL:
    lib = _build.load("sam_attention")
    fn = lib.eqt_sam_attention
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ctypes.POINTER(ctypes.c_longlong),
                       ci, ci, ci, ci, ci, ci, ci, ci, vp]  # ..., H, W, mt, grid, stream
        fn.restype = ci
    return lib


def _c_args(q: Tensor, k: Tensor, v: Tensor, rel_h: Optional[Tensor],
            rel_w: Optional[Tensor], out: Tensor, H: int, W: int, mt: int,
            grid: Tuple[int, int]) -> tuple:
    """`eqt_sam_attention`'s arguments but the stream: the pointers (None
    for absent tables), the 17 strides in the source's `Strides` order,
    heads, N, hd, H, W, MT and the grid."""
    B, N, nh, hd = q.shape
    th, tw = (rel_h, rel_w) if rel_h is not None else (q, q)  # unread without the bias
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *th.stride()[:3], *tw.stride()[:3], *out.stride()[:2])
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if rel_h is None else rel_h.data_ptr(),
            None if rel_w is None else rel_w.data_ptr(), out.data_ptr(),
            (ctypes.c_longlong * 17)(*strides), nh, N, hd, H, W, mt, *grid)


def _kernel(q: Tensor, k: Tensor, v: Tensor, rel_h: Optional[Tensor],
            rel_w: Optional[Tensor], out: Tensor, H: int, W: int, mt: int,
            grid: Tuple[int, int]) -> None:
    """One launch on q's current stream; raises on a launch error."""
    err = _lib().eqt_sam_attention(
        *_c_args(q, k, v, rel_h, rel_w, out, H, W, mt, grid),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sam_attention launch failed: cudaError {err}")


def _launch(q: Tensor, k: Tensor, v: Tensor, rel_h: Optional[Tensor],
            rel_w: Optional[Tensor], H: int, W: int) -> Tensor:
    _validate_launch(q, k, v, rel_h, rel_w, H, W)
    B, N, nh, hd = q.shape
    path, mt, grid = _plan(B, N, nh)
    out = torch.empty((B, N, nh * hd), dtype=q.dtype, device=q.device)
    _kernel(q, k, v, rel_h, rel_w, out, H, W, mt, grid)
    tag = str(q.dtype).removeprefix("torch.")
    launches[f"sam_attention/{tag}"] = launches.get(f"sam_attention/{tag}", 0) + 1
    key = f"sam_attention/{tag}/{path}"
    path_launches[key] = path_launches.get(key, 0) + 1
    return out
