"""What the tutorials share: seeded weights and fp32 arithmetic."""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def seeded(seed: int, device) -> Iterator[None]:
    """Modules built inside draw their weights from torch's default
    generators seeded with `seed`; the caller's generator states come back
    afterwards."""
    dev = torch.device(device)
    cuda = [dev.index or 0] if dev.type == "cuda" else []
    with torch.random.fork_rng(devices=cuda):
        torch.manual_seed(seed)
        yield


@contextlib.contextmanager
def fp32() -> Iterator[None]:
    """TF32 off for convolutions and matmuls inside; restored after."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
