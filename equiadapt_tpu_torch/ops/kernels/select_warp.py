"""Steered rotate-select (K1) and fused rotate-select-roll (K2).

Counterpart of `equiadapt_tpu/ops/pallas/select_warp.py`. The eval warp of
`canonicalize` and the eval invert of a regular-rep feature map are both
per-sample permutations of one selected source plane:

* K1 `select_planes`: out[b, c] = rot90^{k[b]}(S_{src[b]}[b, c]);
* K2 `select_planes_rolled`: K1 on the fiber-rolled channel, then a hflip
  for reflected samples (D_n).

The sources S are the batch and its static residual warps (`_c_n_decomposition`:
rotate(x, sign * theta_g) == rot90^{k_of[g]}(rotate(x, residues[src_of[g]]))).
Both wrappers launch the hand-written CUDA kernel of `csrc/select_warp.cu` for
CUDA tensors, take the plain PyTorch version beside them for CPU tensors, and
raise for anything else. `launches` counts the kernel launches of each
wrapper, by dtype.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence

import torch

from equiadapt_tpu_torch.ops.kernels import _build
from equiadapt_tpu_torch.ops.warp import (
    _static_rotate_from_nchw,
    rotate_twopass_from_nchw,
)

Tensor = torch.Tensor

__all__ = [
    "rotate_select",
    "rotate_roll_select",
    "select_planes",
    "select_planes_rolled",
    "select_planes_plain",
    "launches",
    "reset_launches",
]

MAX_SOURCES = 4

# kernel launches per wrapper and dtype, e.g. launches["select_planes/bfloat16"]
launches: Dict[str, int] = {}


def reset_launches() -> None:
    launches.clear()


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
    fn = lib.eqt_select_warp
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, vp, vp, vp, vp, ci, vp, vp, vp, vp, vp,
                       ci, ci, ci, ci, ci, vp]
        fn.restype = ci
    return lib


def _check(sources: Sequence[Tensor], idx: Sequence[Tensor]) -> None:
    if not 1 <= len(sources) <= MAX_SOURCES:
        raise ValueError(f"1 to {MAX_SOURCES} sources, got {len(sources)}")
    B, C, H, W = sources[0].shape
    if H != W:
        raise ValueError(f"select kernels need square planes, got {H}x{W}")
    for s in sources:
        if s.shape != sources[0].shape or s.dtype != sources[0].dtype:
            raise ValueError("sources must share shape and dtype")
    for t in idx:
        if t.shape != (B,):
            raise ValueError(f"per-sample index of shape ({B},), got {tuple(t.shape)}")


def select_planes_plain(
    sources: Sequence[Tensor],
    src_idx: Tensor,
    k_idx: Tensor,
    shift: Optional[Tensor] = None,
    refl: Optional[Tensor] = None,
    num_group: int = 1,
    num_rotations: int = 1,
) -> Tensor:
    """Plain PyTorch version of both kernels (same index semantics)."""
    B, C, H, W = sources[0].shape
    b = torch.arange(B, device=sources[0].device)
    src = src_idx.long().clamp(0, len(sources) - 1)
    x = torch.stack(list(sources))[src, b]  # (B, C, H, W): selected planes
    if shift is not None:
        G, n = num_group, num_rotations
        p = torch.arange(C, device=x.device) % G
        s = shift.long()[:, None]
        q = torch.where(p < n, torch.remainder(p - s, n),
                        n + torch.remainder(p - n + s, n))
        chan = (torch.arange(C, device=x.device) // G) * G + q  # (B, C)
        x = torch.gather(x, 1, chan[:, :, None, None].expand(B, C, H, W))
    k = torch.remainder(k_idx.long(), 4)
    out = torch.empty_like(x)
    for kk in range(4):
        m = k == kk
        out[m] = torch.rot90(x[m], kk, dims=(2, 3))
    if refl is not None:
        m = refl == 1
        out[m] = torch.flip(out[m], dims=(3,))
    return out


def _launch(name: str, sources, src_idx, k_idx, shift, refl, G, n) -> Tensor:
    s0 = sources[0]
    if s0.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"select kernels take float32 or bfloat16, got {s0.dtype}")
    B, C, N, _ = s0.shape
    if any(not s.is_contiguous() for s in sources):
        raise ValueError("select kernels need NCHW-contiguous sources")
    if B > 65535 or C > 65535:
        raise ValueError(f"grid limit: B and C must be <= 65535, got {B}, {C}")
    idx = [t.to(torch.int32).contiguous() if t is not None else None
           for t in (src_idx, k_idx, shift, refl)]
    out = torch.empty_like(s0)
    ptrs = [s.data_ptr() for s in sources]
    ptrs += [ptrs[0]] * (MAX_SOURCES - len(ptrs))
    err = _lib().eqt_select_warp(
        _build.DTYPE_CODES[s0.dtype], *ptrs, len(sources), out.data_ptr(),
        *[t.data_ptr() if t is not None else None for t in idx],
        B, C, N, G, n, torch.cuda.current_stream(s0.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"select_warp kernel launch failed: cudaError {err}")
    key = f"{name}/{str(s0.dtype).removeprefix('torch.')}"
    launches[key] = launches.get(key, 0) + 1
    return out


def select_planes(sources: Sequence[Tensor], src_idx: Tensor,
                  k_idx: Tensor) -> Tensor:
    """K1: out[b, c] = rot90^{k[b]}(sources[src[b]][b, c]), NCHW."""
    sources = list(sources)
    _check(sources, (src_idx, k_idx))
    if _build.route(sources + [src_idx, k_idx], "select kernels") == "cpu":
        return select_planes_plain(sources, src_idx, k_idx)
    return _launch("select_planes", sources, src_idx, k_idx, None, None, 1, 1)


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
    if G not in (n, 2 * n) or C % G != 0:
        raise ValueError(f"regular rep: C={C} must divide by |G|={G} in (n, 2n)")
    if (refl is not None) != (G == 2 * n):
        raise ValueError("refl is given exactly for D_n (num_group == 2 n)")
    if _build.route(sources + [src_idx, k_idx] + extra, "select kernels") == "cpu":
        return select_planes_plain(sources, src_idx, k_idx, shift, refl, G, n)
    return _launch("select_planes_rolled", sources, src_idx, k_idx, shift,
                   refl, G, n)


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


def _sources(x: Tensor, residues, padding_mode: str, mode: str):
    """NCHW batch plus its residual warps, all in x's dtype."""
    xn = x.permute(0, 3, 1, 2).contiguous()
    warp = rotate_twopass_from_nchw if mode == "fast" else _static_rotate_from_nchw
    return [xn] + [
        warp(xn, r, padding_mode).to(x.dtype).contiguous() for r in residues[1:]
    ]


def rotate_select(
    x: Tensor,
    idx: Tensor,
    num_rotations: int,
    sign: float = -1.0,
    padding_mode: str = "border",
    mode: str = "exact",
) -> Tensor:
    """out[b] = rotate(x[b], sign * theta_{idx[b]}) on square NHWC images,
    through K1. mode="exact" warps the residual sources with static taps,
    mode="fast" with the two-pass products. Returns NHWC (a view of the
    kernel's NCHW output)."""
    B, H, W, C = x.shape
    if H != W:
        raise ValueError(f"rotate_select needs square images, got {H}x{W}")
    residues, src_idx, k_idx = _select_tables(idx, num_rotations, sign)
    out = select_planes(_sources(x, residues, padding_mode, mode), src_idx, k_idx)
    return out.permute(0, 2, 3, 1)


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
    `shift`. C = fields * |G| in the C-major / G-minor layout."""
    B, H, W, C = x.shape
    if H != W:
        raise ValueError(f"rotate_roll_select needs square images, got {H}x{W}")
    residues, src_idx, k_idx = _select_tables(idx, num_rotations, sign)
    num_group = num_rotations if refl is None else 2 * num_rotations
    out = select_planes_rolled(
        _sources(x, residues, padding_mode, mode), src_idx, k_idx,
        shift, num_group, num_rotations, refl=refl,
    )
    return out.permute(0, 2, 3, 1)
