"""The exact D4 orbit (K4) and the |G|-orbit of the orbit-scoring paths.

Counterpart of `equiadapt_tpu/ops/pallas/orbit.py`. `rot90_flip_orbit` maps
a square NHWC batch (B, N, N, C) to its group-major orbit (G, B, N, N, C):

    out[g] = hflip^{f_g}(rot90^{k_g}(x)),

with k_g = (sign * (4 // n) * g) mod 4 for the n rotations (n in 1, 2, 4)
and, for D_n, the same k_g again with the hflip. rot90 is torch's (and
numpy's) counter-clockwise quarter turn over (H, W); the hflip reverses W
after it. The optimized canonicalizer takes sign = -1 (rotate(x, -theta_g)),
`group_inference` sign = +1.

The wrapper launches the hand-written CUDA kernel of `csrc/orbit.cu` for
CUDA tensors, takes the plain PyTorch version `rot90_flip_orbit_plain` (a
stack of `torch.rot90` / `torch.flip`, the JAX `_orbit_xla`) for CPU
tensors, and raises for anything else. Both are pure data movement and
bit-identical. The JAX package's `use_pallas` switch has no counterpart: a
CUDA tensor always takes the kernel. The kernel has three launch paths,
chosen by shape and alignment (`_orbit_path`): 16-byte words of a pixel,
32 x 32 tiles with C a template parameter (C <= 4), and tiles in 16-byte
chunks of a pixel (other C).

`materialize_orbit` is the entry point of the optimized canonicalizer and of
`group_inference`: the kernel when every element is a quarter turn of a
square image, per-element static warps (`ops/warp._residual_rotate`) and
`hflip` otherwise.

`launches` counts kernel launches by dtype, e.g.
`launches["rot90_flip_orbit/float32"]`; `path_launches` counts them again
by launch path, e.g. `path_launches["rot90_flip_orbit/float32/tile"]`.

The kernel has no backward: under grad mode, an input that requires grad
raises on the card (`_build.refuse_grad`) instead of returning a result
without a `grad_fn`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from equiadapt_tpu_torch.ops.kernels import _build
from equiadapt_tpu_torch.ops.warp import _residual_rotate, hflip

Tensor = torch.Tensor

__all__ = ["rot90_flip_orbit", "rot90_flip_orbit_plain", "materialize_orbit",
           "launches", "path_launches", "reset_launches", "MAX_B", "MAX_N"]

_KERNELS = "the orbit kernel"

# the kernel's limits: B is a grid dimension; offsets are 64-bit
MAX_B, MAX_N = 65535, 65535

# kernel launches by dtype, e.g. launches["rot90_flip_orbit/bfloat16"]
launches: Dict[str, int] = {}
# the same launches by path, e.g. path_launches["rot90_flip_orbit/bfloat16/word"]
path_launches: Dict[str, int] = {}
# the C interface's path codes
_PATH_CODES = {"tile": 0, "word": 1, "chunk": 2}


def reset_launches() -> None:
    launches.clear()
    path_launches.clear()


def _lib() -> ctypes.CDLL:
    lib = _build.load("orbit")
    fn = lib.eqt_rot90_flip_orbit
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, vp, vp, ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
    return lib


def _elements(num_rotations: int, reflections: bool,
              sign: float) -> Tuple[Tuple[int, ...], Tuple[bool, ...]]:
    """The orbit's (k_g, f_g) table, rotations first, then the hflip coset."""
    if num_rotations not in (1, 2, 4):
        raise ValueError(
            f"the exact orbit takes 1, 2 or 4 rotations (90-degree multiples), "
            f"got {num_rotations}")
    step = 4 // num_rotations
    s = 1 if sign > 0 else -1
    ks = tuple((s * step * i) % 4 for i in range(num_rotations))
    flips = (False,) * num_rotations
    if reflections:
        ks, flips = ks + ks, flips + (True,) * num_rotations
    return ks, flips


def _apply_d4(x: Tensor, k: int, flip: bool) -> Tensor:
    """One exact D4 element on (B, H, W, C): rot90^k, then the hflip."""
    y = torch.rot90(x, k, dims=(1, 2))
    return torch.flip(y, dims=(2,)) if flip else y


def rot90_flip_orbit_plain(x: Tensor, num_rotations: int = 4,
                           reflections: bool = False,
                           sign: float = -1.0) -> Tensor:
    """Plain version of K4: (B, N, N, C) -> (G, B, N, N, C)."""
    ks, flips = _elements(num_rotations, reflections, sign)
    return torch.stack([_apply_d4(x, k, f) for k, f in zip(ks, flips)])


def rot90_flip_orbit(x: Tensor, num_rotations: int = 4,
                     reflections: bool = False, sign: float = -1.0) -> Tensor:
    """K4: the exact C_n / D_n orbit (n in 1, 2, 4) of a square NHWC batch,
    (B, N, N, C) -> (G, B, N, N, C), group-major, G = n or 2 n."""
    if x.dim() != 4 or x.shape[1] != x.shape[2]:
        raise ValueError(
            f"the exact orbit takes square NHWC images, got {tuple(x.shape)}")
    ks, flips = _elements(num_rotations, reflections, sign)
    where = _build.route([x], _KERNELS)
    if where == "meta":
        return x.new_empty((len(ks),) + tuple(x.shape))
    if where == "cpu":
        return rot90_flip_orbit_plain(x, num_rotations, reflections, sign)
    _build.refuse_grad([x], "the orbit kernel (K4)",
                       "its callers (the optimized canonicalizer, in training "
                       "too, and group_inference) hand it data, which needs "
                       "no gradient")
    return _orbit_op(x.contiguous(), [int(k) for k in ks], [bool(f) for f in flips])


def _orbit_path(x: Tensor, out: Tensor) -> str:
    """K4's launch path, as K3's (`select_warp._nhwc_path`): "word"
    (16-byte words of a pixel) when a pixel is whole words and x and the
    output start on a 16-byte boundary; otherwise "tile" (32 x 32 tiles, C a
    template parameter) for C <= 4 and "chunk" (tiles in 16-byte chunks of a
    pixel) for other C."""
    if _build.whole_words(x, out):
        return "word"
    return "tile" if x.shape[-1] <= 4 else "chunk"


def _table(ks, flips) -> int:
    """The element table packed three bits an element: k_g in bits 3g and
    3g + 1, f_g in bit 3g + 2."""
    return sum((k | (int(f) << 2)) << (3 * g)
               for g, (k, f) in enumerate(zip(ks, flips)))


def _launch(x: Tensor, ks, flips) -> Tensor:
    B, N, _, C = x.shape
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{_KERNELS} takes float32 or bfloat16, got {x.dtype}")
    if not 1 <= B <= MAX_B or N > MAX_N:
        raise ValueError(
            f"{_KERNELS} takes 1 <= B <= {MAX_B} and N <= {MAX_N}; got "
            f"(B, N, N, C) = {tuple(x.shape)}")
    out = torch.empty((len(ks), B, N, N, C), dtype=x.dtype, device=x.device)
    path = _orbit_path(x, out)
    err = _lib().eqt_rot90_flip_orbit(
        _build.DTYPE_CODES[x.dtype], x.data_ptr(), out.data_ptr(), B, N, C,
        len(ks), _table(ks, flips), _PATH_CODES[path],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"rot90_flip_orbit launch failed: cudaError {err}")
    key = f"rot90_flip_orbit/{str(x.dtype).removeprefix('torch.')}"
    launches[key] = launches.get(key, 0) + 1
    path_launches[f"{key}/{path}"] = path_launches.get(f"{key}/{path}", 0) + 1
    return out


# K4 as a registered operator around `_launch` (`_build.register_op`)
_orbit_op = _build.register_op(
    "rot90_flip_orbit(Tensor x, int[] ks, bool[] flips) -> Tensor",
    lambda x, ks, flips: _launch(x, tuple(ks), tuple(flips)),
    lambda x, ks, flips: x.new_empty((len(ks),) + tuple(x.shape)))


def materialize_orbit(x: Tensor, num_rotations: int,
                      group_type: str = "rotation",
                      padding_mode: str = "border", sign: float = -1.0,
                      mode: str = "exact") -> Tensor:
    """The full |G|-orbit of an NHWC batch as (G * B, H, W, C), group-major:
    K4 when every angle is a 90-degree multiple and the images are square,
    one static warp per element otherwise (exact taps or, mode="fast", the
    two-pass products), the hflip coset after the rotations for
    roto-reflection groups."""
    refl = group_type == "roto-reflection"
    if num_rotations in (1, 2, 4) and x.shape[1] == x.shape[2]:
        orbit = rot90_flip_orbit(x, num_rotations, reflections=refl, sign=sign)
        return orbit.reshape((-1,) + tuple(x.shape[1:]))
    degrees = np.linspace(0.0, 360.0, num_rotations + 1)[:num_rotations]
    rot = torch.cat([
        x if (float(sign) * float(d)) % 360.0 == 0.0
        else _residual_rotate(x, float(sign) * float(d), padding_mode, mode)
        for d in degrees
    ])
    if refl:
        rot = torch.cat([rot, hflip(rot)])
    return rot
