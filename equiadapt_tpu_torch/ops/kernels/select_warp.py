"""Steered rotate-select (K1, K3) and fused rotate-select-roll (K2).

Counterpart of `equiadapt_tpu/ops/pallas/select_warp.py`. The eval warp of
`canonicalize` and the eval invert of a regular-rep feature map are both
per-sample permutations of one selected source image:

* K1 `select_planes`: out[b, c] = rot90^{k[b]}(S_{src[b]}[b, c]), NCHW;
* K3 `select_planes_nhwc`: K1's function on NHWC-contiguous sources
  (B, N, N, C), any C;
* K2 `select_planes_rolled`: K1 on the fiber-rolled channel, then a hflip
  for reflected samples (D_n).

The sources S are the batch and its static residual warps (`_c_n_decomposition`:
rotate(x, sign * theta_g) == rot90^{k_of[g]}(rotate(x, residues[src_of[g]]))).
Each wrapper launches the hand-written CUDA kernel of `csrc/select_warp.cu`
for CUDA tensors, takes the plain PyTorch version beside it for CPU
tensors, and raises for anything else; the launch is the registered
operator `eqt::select_warp` (`_select_op`, `_build.register_op`), whose
fake implementation gives `torch.export` the output's shape and dtype, so
an exported graph launches the kernel. Each wrapper is a
`torch.autograd.Function`: the select is linear in its sources, and its
backward is one more launch of the same kernel (the inverse permutation,
with the cotangent as the only source), then a mask per source. No gradient reaches the indices.
`launches` counts the kernel launches of each wrapper, by dtype, backward
launches included; `path_launches` counts them again by launch path (K1 and
K2: "word" or "element", `_rolled_path`; K3: "word" or "tile",
`_nhwc_path`).

`rotate_select` routes by memory layout: an NHWC-contiguous batch takes K3,
a (B, H, W, C) view of NCHW memory takes K1 with no copy.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence

import torch

from equiadapt_tpu_torch.ops.kernels import _build
from equiadapt_tpu_torch.ops.warp import (
    _static_rotate,
    _static_rotate_from_nchw,
    rotate_twopass,
    rotate_twopass_from_nchw,
)

Tensor = torch.Tensor

__all__ = [
    "rotate_select",
    "rotate_roll_select",
    "select_planes",
    "select_planes_nhwc",
    "select_planes_rolled",
    "select_planes_plain",
    "select_planes_nhwc_plain",
    "launches",
    "reset_launches",
]

MAX_SOURCES = 4

# kernel launches per wrapper and dtype, e.g. launches["select_planes/bfloat16"]
launches: Dict[str, int] = {}
# the same launches by path, e.g. path_launches["select_planes_rolled/bfloat16/word"]
path_launches: Dict[str, int] = {}


def reset_launches() -> None:
    launches.clear()
    path_launches.clear()


@functools.lru_cache(maxsize=None)
def _c_n_decomposition(n: int, sign: float):
    """Residual / quarter-turn decomposition of the C_n select angles.

    rotate(x, sign * theta_g) == rot90^{k_of[g]}(rotate(x, residues[src_of[g]]))
    on square images, residues in [0, 90) and residues[0] == 0. C8 needs two
    sources (0 and 45 degrees), C6/C12 three, C16 four.
    """
    residues = [0.0]
    src_of, k_of = [], []
    for g in range(n):
        ang = (sign * (360.0 * g / n)) % 360.0
        r = round(ang % 90.0, 6)
        k = int(round((ang - r) / 90.0)) % 4
        if r != 0.0 and r not in residues:
            residues.append(r)
        src_of.append(0 if r == 0.0 else residues.index(r))
        k_of.append(k)
    return tuple(residues), tuple(src_of), tuple(k_of)


def _lib() -> ctypes.CDLL:
    lib = _build.load("select_warp")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.eqt_select_warp
    if fn.argtypes is None:
        fn.argtypes = [ci, vp, vp, vp, vp, ci, vp, vp, vp, vp, vp,
                       ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
    fn = lib.eqt_select_warp_nhwc
    if fn.argtypes is None:
        fn.argtypes = [ci, vp, vp, vp, vp, ci, vp, vp, vp, ci, ci, ci, ci, vp]
        fn.restype = ci
    return lib


def _check(sources: Sequence[Tensor], idx: Sequence[Tensor],
           nhwc: bool = False) -> None:
    if not 1 <= len(sources) <= MAX_SOURCES:
        raise ValueError(f"1 to {MAX_SOURCES} sources, got {len(sources)}")
    if sources[0].dim() != 4:
        raise ValueError(f"select kernels take 4-d sources, got {sources[0].dim()}-d")
    B = sources[0].shape[0]
    H, W = sources[0].shape[1:3] if nhwc else sources[0].shape[2:4]
    if H != W:
        raise ValueError(f"select kernels need square planes, got {H}x{W}")
    for s in sources:
        if s.shape != sources[0].shape or s.dtype != sources[0].dtype:
            raise ValueError("sources must share shape and dtype")
    for t in idx:
        if t.shape != (B,):
            raise ValueError(f"per-sample index of shape ({B},), got {tuple(t.shape)}")
        if t.is_floating_point() or t.is_complex() or t.dtype == torch.bool:
            raise TypeError(f"per-sample indices must be integer tensors, got {t.dtype}")


def _selected(sources: Sequence[Tensor], src_idx: Tensor) -> Tensor:
    b = torch.arange(sources[0].shape[0], device=sources[0].device)
    src = src_idx.long().clamp(0, len(sources) - 1)
    return torch.stack(list(sources))[src, b]


def _rot90_per_sample(x: Tensor, k_idx: Tensor, dims) -> Tensor:
    k = torch.remainder(k_idx.long(), 4)
    out = torch.empty_like(x)
    for kk in range(4):
        m = k == kk
        out[m] = torch.rot90(x[m], kk, dims=dims)
    return out


def select_planes_plain(
    sources: Sequence[Tensor],
    src_idx: Tensor,
    k_idx: Tensor,
    shift: Optional[Tensor] = None,
    refl: Optional[Tensor] = None,
    num_group: int = 1,
    num_rotations: int = 1,
) -> Tensor:
    """Plain PyTorch version of K1 and K2 (same index semantics)."""
    B, C, H, W = sources[0].shape
    x = _selected(sources, src_idx)  # (B, C, H, W): selected planes
    if shift is not None:
        G, n = num_group, num_rotations
        p = torch.arange(C, device=x.device) % G
        s = shift.long()[:, None]
        q = torch.where(p < n, torch.remainder(p - s, n),
                        n + torch.remainder(p - n + s, n))
        chan = (torch.arange(C, device=x.device) // G) * G + q  # (B, C)
        x = torch.gather(x, 1, chan[:, :, None, None].expand(B, C, H, W))
    out = _rot90_per_sample(x, k_idx, (2, 3))
    if refl is not None:
        m = refl == 1
        out[m] = torch.flip(out[m], dims=(3,))
    return out


def select_planes_nhwc_plain(sources: Sequence[Tensor], src_idx: Tensor,
                             k_idx: Tensor) -> Tensor:
    """Plain PyTorch version of K3: a stack of the sources indexed per
    sample, then torch.rot90 over (H, W) per k."""
    return _rot90_per_sample(_selected(sources, src_idx), k_idx, (1, 2))


_NHWC = "select_planes_nhwc"


def _nhwc_path(sources: Sequence[Tensor], out: Tensor) -> str:
    """K3's launch path, as K5's (`shear_rotate._select_path`): "word"
    (16-byte words of a pixel) when a pixel is whole words and every source
    and the output start on a 16-byte boundary, "tile" (32 x 32 tiles
    through shared memory) otherwise."""
    return "word" if _build.whole_words(*sources, out) else "tile"


def _rolled_path(sources: Sequence[Tensor], out: Tensor) -> str:
    """K1's and K2's launch path: "word" (16-byte words, a block a plane)
    when a plane row is whole words (N * element size a multiple of 16),
    every source and the output start on a 16-byte boundary and a plane
    holds fewer than 2^24 words, "element" (one element a thread in 32 x 32
    tiles) otherwise."""
    N = out.shape[-1]
    small = N * N * out.element_size() < 16 * 2**24
    return "word" if small and _build.whole_words(*sources, out) else "element"


def _launch(name: str, sources, src_idx, k_idx, shift, refl, G, n) -> Tensor:
    s0 = sources[0]
    if s0.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"select kernels take float32 or bfloat16, got {s0.dtype}")
    if any(not s.is_contiguous() for s in sources):
        layout = "NHWC" if name == _NHWC else "NCHW"
        raise ValueError(f"{name} needs {layout}-contiguous sources")
    if name == _NHWC:
        B, N, _, C = s0.shape
    else:
        B, C, N, _ = s0.shape
    if B > 65535 or (name != _NHWC and C > 65535):
        raise ValueError(f"grid limit: B (and C for NCHW) must be <= 65535, "
                         f"got {tuple(s0.shape)}")
    if name == _NHWC and N * N * C >= 2**31:
        raise ValueError(f"{name} takes N * N * C < 2^31 a sample, got "
                         f"{tuple(s0.shape)}")
    idx = [t.to(torch.int32).contiguous() if t is not None else None
           for t in (src_idx, k_idx, shift, refl)]
    out = torch.empty_like(s0)
    ptrs = [s.data_ptr() for s in sources]
    ptrs += [ptrs[0]] * (MAX_SOURCES - len(ptrs))
    stream = torch.cuda.current_stream(s0.device).cuda_stream
    code = _build.DTYPE_CODES[s0.dtype]
    if name == _NHWC:
        path = _nhwc_path(sources, out)
        err = _lib().eqt_select_warp_nhwc(
            code, *ptrs, len(sources), out.data_ptr(), idx[0].data_ptr(),
            idx[1].data_ptr(), B, N, C, int(path == "word"), stream)
    else:
        path = _rolled_path(sources, out)
        err = _lib().eqt_select_warp(
            code, *ptrs, len(sources), out.data_ptr(),
            *[t.data_ptr() if t is not None else None for t in idx],
            B, C, N, G, n, int(path == "word"), stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    key = f"{name}/{str(s0.dtype).removeprefix('torch.')}"
    launches[key] = launches.get(key, 0) + 1
    path_launches[f"{key}/{path}"] = path_launches.get(f"{key}/{path}", 0) + 1
    return out


def _select_fake(name, sources, src_idx, k_idx, shift, refl, G, n):
    return sources[0].new_empty(sources[0].shape)


# K1 / K2 / K3 (`name`) as a registered operator around `_launch`, so that a
# `torch.export` graph keeps the launch
_select_op = _build.register_op(
    "select_warp(str name, Tensor[] sources, Tensor src_idx, Tensor k_idx, "
    "Tensor? shift, Tensor? refl, int G, int n) -> Tensor",
    lambda *args: _launch(*args), _select_fake)


def _select(name: str, sources, src_idx, k_idx, shift=None, refl=None,
            G: int = 1, n: int = 1) -> Tensor:
    """The kernel `name` on CUDA tensors, its plain version on CPU tensors."""
    tensors = list(sources) + [t for t in (src_idx, k_idx, shift, refl)
                               if t is not None]
    where = _build.route(tensors, "select kernels")
    if where == "meta":
        return torch.empty_like(sources[0])
    if where == "cpu":
        if name == _NHWC:
            return select_planes_nhwc_plain(sources, src_idx, k_idx)
        return select_planes_plain(sources, src_idx, k_idx, shift, refl, G, n)
    return _select_op(name, list(sources), src_idx, k_idx, shift, refl, G, n)


class _Select(torch.autograd.Function):
    """A select kernel as a linear map of its sources.

    out[b] = P_b(S_{src[b]}[b]) with P_b = hflip^{r} rot90^{k} roll_{shift}
    a permutation, so grad S_s[b] = [src[b] == s] P_b^{-1}(g[b]).
    P_b^{-1} is the same kernel's permutation with the shift negated and
    k' = -k, or k' = k under the hflip (rot90^{-k} hflip = hflip rot90^k).
    """

    @staticmethod
    def forward(ctx, name, src_idx, k_idx, shift, refl, G, n, *sources):
        ctx.name, ctx.G, ctx.n, ctx.num_sources = name, G, n, len(sources)
        ctx.save_for_backward(src_idx, k_idx, shift, refl)
        return _select(name, sources, src_idx, k_idx, shift, refl, G, n)

    @staticmethod
    def backward(ctx, grad):
        src_idx, k_idx, shift, refl = ctx.saved_tensors
        k_t = torch.remainder(-k_idx, 4)
        shift_t = None if shift is None else -shift
        if refl is not None:
            k_t = torch.where(refl == 1, k_idx, k_t)
        g = _select(ctx.name, [grad.contiguous()], torch.zeros_like(src_idx),
                    k_t, shift_t, refl, ctx.G, ctx.n)
        src = src_idx.long().clamp(0, ctx.num_sources - 1)
        grads = []
        for s in range(ctx.num_sources):
            if not ctx.needs_input_grad[7 + s]:
                grads.append(None)
            elif ctx.num_sources == 1:
                grads.append(g)
            else:
                grads.append(g.masked_fill((src != s).view(-1, 1, 1, 1), 0))
        return (None,) * 7 + tuple(grads)


def select_planes(sources: Sequence[Tensor], src_idx: Tensor,
                  k_idx: Tensor) -> Tensor:
    """K1: out[b, c] = rot90^{k[b]}(sources[src[b]][b, c]), NCHW."""
    sources = list(sources)
    _check(sources, (src_idx, k_idx))
    return _Select.apply("select_planes", src_idx, k_idx, None, None, 1, 1,
                         *sources)


def select_planes_nhwc(sources: Sequence[Tensor], src_idx: Tensor,
                       k_idx: Tensor) -> Tensor:
    """K3: out[b] = rot90^{k[b]}(sources[src[b]][b]) over (H, W), for
    NHWC-contiguous (B, N, N, C) sources; NHWC-contiguous output."""
    sources = list(sources)
    _check(sources, (src_idx, k_idx), nhwc=True)
    return _Select.apply(_NHWC, src_idx, k_idx, None, None, 1, 1, *sources)


def select_planes_rolled(
    sources: Sequence[Tensor],
    src_idx: Tensor,
    k_idx: Tensor,
    shift: Tensor,
    num_group: int,
    num_rotations: int,
    refl: Optional[Tensor] = None,
) -> Tensor:
    """K2: K1 on the regular-rep fiber-rolled channel, then hflip where
    refl[b] == 1. Fiber g of each field reads (g - shift) mod n, reflection
    fibers (D_n, num_group == 2 n) roll the other way."""
    sources = list(sources)
    extra = [shift] + ([refl] if refl is not None else [])
    _check(sources, [src_idx, k_idx] + extra)
    C = sources[0].shape[1]
    G, n = num_group, num_rotations
    if n < 1:
        raise ValueError(f"num_rotations must be >= 1, got {n}")
    if G not in (n, 2 * n) or C % G != 0:
        raise ValueError(f"regular rep: C={C} must divide by |G|={G} in (n, 2n)")
    if (refl is not None) != (G == 2 * n):
        raise ValueError("refl is given exactly for D_n (num_group == 2 n)")
    return _Select.apply("select_planes_rolled", src_idx, k_idx, shift, refl,
                         G, n, *sources)


def _select_tables(idx: Tensor, num_rotations: int, sign: float):
    residues, src_of, k_of = _c_n_decomposition(
        num_rotations, 1.0 if sign > 0 else -1.0
    )
    if len(residues) > MAX_SOURCES:
        raise ValueError(
            f"C{num_rotations} needs {len(residues)} residual sources, "
            f"the select kernels take at most {MAX_SOURCES}"
        )
    idx = torch.remainder(idx.long(), num_rotations)
    src_idx = torch.tensor(src_of, dtype=torch.int32, device=idx.device)[idx]
    k_idx = torch.tensor(k_of, dtype=torch.int32, device=idx.device)[idx]
    return residues, src_idx, k_idx


def _sources(x: Tensor, residues, padding_mode: str, mode: str,
             nhwc: bool):
    """The batch plus its residual warps, all in x's dtype and contiguous:
    x is (B, H, W, C) NHWC-contiguous with nhwc=True, else (B, C, H, W)."""
    if nhwc:
        warp = rotate_twopass if mode == "fast" else _static_rotate
    else:
        warp = rotate_twopass_from_nchw if mode == "fast" else _static_rotate_from_nchw
    return [x] + [
        warp(x, r, padding_mode).to(x.dtype).contiguous() for r in residues[1:]
    ]


def rotate_select(
    x: Tensor,
    idx: Tensor,
    num_rotations: int,
    sign: float = -1.0,
    padding_mode: str = "border",
    mode: str = "exact",
) -> Tensor:
    """out[b] = rotate(x[b], sign * theta_{idx[b]}) on square NHWC images.
    mode="exact" warps the residual sources with static taps, mode="fast"
    with the two-pass products. Routes by x's memory layout, with no switch:

    * NHWC memory (x.is_contiguous()): NHWC residual sources and K3; the
      output is NHWC-contiguous;
    * a view of NCHW memory (x.permute(0, 3, 1, 2).is_contiguous()): NCHW
      residual sources from that view, with no copy, and K1; the output is
      a (B, H, W, C) view of NCHW memory;
    * any other strides: one copy to NHWC memory, then K3.

    Differentiable in x through the kernels' backward; no gradient reaches
    idx."""
    B, H, W, C = x.shape
    if H != W:
        raise ValueError(f"rotate_select needs square images, got {H}x{W}")
    residues, src_idx, k_idx = _select_tables(idx, num_rotations, sign)
    if not x.is_contiguous() and x.permute(0, 3, 1, 2).is_contiguous():
        srcs = _sources(x.permute(0, 3, 1, 2), residues, padding_mode, mode,
                        nhwc=False)
        return select_planes(srcs, src_idx, k_idx).permute(0, 2, 3, 1)
    srcs = _sources(x.contiguous(), residues, padding_mode, mode, nhwc=True)
    return select_planes_nhwc(srcs, src_idx, k_idx)


def rotate_roll_select(
    x: Tensor,
    idx: Tensor,
    shift: Tensor,
    num_rotations: int,
    sign: float = 1.0,
    padding_mode: str = "zeros",
    refl: Optional[Tensor] = None,
    mode: str = "fast",
) -> Tensor:
    """Fused invert of a regular-rep NHWC feature map through K2: spatial
    rotate-select, hflip where refl == 1 (D_n) and the fiber roll by
    `shift`. C = fields * |G| in the C-major / G-minor layout. Returns NHWC
    (a view of the kernel's NCHW output); differentiable in x."""
    B, H, W, C = x.shape
    if H != W:
        raise ValueError(f"rotate_roll_select needs square images, got {H}x{W}")
    residues, src_idx, k_idx = _select_tables(idx, num_rotations, sign)
    num_group = num_rotations if refl is None else 2 * num_rotations
    srcs = _sources(x.permute(0, 3, 1, 2).contiguous(), residues, padding_mode,
                    mode, nhwc=False)
    out = select_planes_rolled(srcs, src_idx, k_idx, shift, num_group,
                               num_rotations, refl=refl)
    return out.permute(0, 2, 3, 1)
