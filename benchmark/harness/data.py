"""Everything a run makes from `--seed`: weights and inputs.

Weights follow the reference's parameter list (`param_spec`: name, shape,
initialisation) and are drawn on the device in one call, then cut and
scaled per leaf, so the program and the reference read the same numbers
and neither makes its own. Images are smooth, oriented pictures (a 6 x 6
Gaussian field, bicubically enlarged, times 4, plus white noise of 0.5): a
random energy network separates its top two elements clearly on them,
where white noise leaves margins near rounding. Each batch of the pool has
its own generator, so any batch can be made again alone.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterable, List, Sequence, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream `tag` of run `seed` (any integer)."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def _init(z: Tensor, shape: Sequence[int], kind: str) -> Tensor:
    """Standard normal draws `z` scaled to the leaf's initialisation."""
    if kind == "he":
        return z * math.sqrt(2.0 / math.prod(shape[1:]))
    if kind == "fan_in":
        return z * math.sqrt(1.0 / shape[1])
    if kind == "fan_in_last":
        return z * math.sqrt(1.0 / math.prod(shape[:-1]))
    if kind == "small":
        return 0.05 * z
    if kind == "bn_weight":
        return 1.0 + 0.1 * z
    if kind in ("bn_bias", "bn_mean"):
        return 0.1 * z
    if kind == "bn_var":
        return torch.exp(0.2 * z)
    if kind.startswith("normal:"):
        return z * float(kind.split(":", 1)[1])
    raise ValueError(f"unknown initialisation {kind!r}")


def make_weights(spec: Iterable[Tuple[str, tuple, str]], seed: int, device
                 ) -> Dict[str, Tensor]:
    """{name: fp32 tensor} for the parameter list, from `seed`."""
    spec = list(spec)
    total = sum(math.prod(s) for _, s, _ in spec)
    z = torch.randn(total, generator=generator(seed, "weights", device), device=device)
    out, at = {}, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        out[name] = _init(z[at:at + n].reshape(shape), shape, kind).contiguous()
        at += n
    return out


def load_weights(module: torch.nn.Module, weights: Dict[str, Tensor]) -> None:
    """Copy `weights` into the module's parameters and persistent buffers,
    each of which must be named there with its shape (step counters
    aside)."""
    state = module.state_dict()
    wanted = {k for k in state if not k.endswith("num_batches_tracked")}
    missing, extra = wanted - set(weights), set(weights) - wanted
    if missing or extra:
        raise KeyError(f"the program's leaves and the reference's differ: "
                       f"only in the program {sorted(missing)[:8]}, "
                       f"only in the reference {sorted(extra)[:8]}")
    with torch.no_grad():
        for k, v in weights.items():
            if tuple(state[k].shape) != tuple(v.shape):
                raise ValueError(f"{k}: program {tuple(state[k].shape)}, "
                                 f"reference {tuple(v.shape)}")
            state[k].copy_(v)


def smooth_images(gen: torch.Generator, b: int, size: int, channels: int = 3) -> Tensor:
    """(b, size, size, channels) NHWC-contiguous fp32 images on the
    generator's device."""
    dev = gen.device
    lo = torch.randn(b, channels, 6, 6, generator=gen, device=dev)
    up = F.interpolate(lo, size=(size, size), mode="bicubic", align_corners=False)
    noise = torch.randn(b, size, size, channels, generator=gen, device=dev)
    return (4.0 * up.permute(0, 2, 3, 1) + 0.5 * noise).contiguous()


def pool_batch(seed: int, i: int, b: int, size: int, num_classes: int, device
               ) -> Tuple[Tensor, Tensor]:
    """Batch i of the run's pool: (images, labels)."""
    gen = generator(seed, f"pool{i}", device)
    x = smooth_images(gen, b, size)
    y = torch.randint(0, num_classes, (b,), generator=gen, device=device)
    return x, y


def pool(seed: int, n: int, b: int, size: int, num_classes: int, device
         ) -> List[Tuple[Tensor, Tensor]]:
    return [pool_batch(seed, i, b, size, num_classes, device) for i in range(n)]
