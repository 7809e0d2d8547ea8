"""Synthetic datasets for tests and benchmarks (no downloads).

Counterpart of `equiadapt_tpu/data/synthetic.py`: the same learnable tasks
(class-dependent oriented blobs, class-dependent ellipsoid clouds), with
the draws taken from an explicit `torch.Generator`. The tensors are made
on the generator's device.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator

import torch

Tensor = torch.Tensor

__all__ = ["synthetic_image_batch", "synthetic_pointcloud_batch", "batch_iterator"]


def _blob_images(labels: Tensor, noise: Tensor) -> Tensor:
    """(B, size, size, C) images of `labels` plus `noise` (B, size, size, C):
    sin(3 f x) + cos(2 f y) over [-1, 1]^2 with f = label + 1."""
    size = noise.shape[1]
    grid = torch.linspace(-1, 1, size, device=noise.device)
    gy, gx = torch.meshgrid(grid, grid, indexing="ij")
    freq = (labels[:, None, None] + 1).float()
    base = torch.sin(freq * 3.0 * gx[None]) + torch.cos(freq * 2.0 * gy[None])
    return base[..., None] + noise


def synthetic_image_batch(generator: torch.Generator, batch: int, size: int = 32,
                          channels: int = 3,
                          num_classes: int = 10) -> Dict[str, Tensor]:
    """Class-dependent oriented blobs: learnable by both the canonicalizer
    and the classifier (the class sets a dominant spatial frequency).
    NHWC float32 images with N(0, 0.1^2) noise, int64 labels."""
    dev = generator.device
    labels = torch.randint(0, num_classes, (batch,), generator=generator, device=dev)
    noise = 0.1 * torch.randn(batch, size, size, channels, generator=generator,
                              device=dev)
    return {"image": _blob_images(labels, noise), "label": labels}


def synthetic_pointcloud_batch(generator: torch.Generator, batch: int,
                               num_points: int = 256,
                               num_classes: int = 8) -> Dict[str, Tensor]:
    """Class-dependent ellipsoid clouds: axes scaled (1 + l, 1, 1 / (1 + l))."""
    dev = generator.device
    labels = torch.randint(0, num_classes, (batch,), generator=generator, device=dev)
    pts = torch.randn(batch, num_points, 3, generator=generator, device=dev)
    lab = labels.float()
    scale = torch.stack([1.0 + lab, torch.ones_like(lab), 1.0 / (1.0 + lab)], dim=-1)
    return {"points": pts * scale[:, None, :] * 0.3, "label": labels}


def batch_iterator(generator: torch.Generator, gen: Callable[..., Dict[str, Tensor]],
                   num_batches: int, **kw) -> Iterator[Dict[str, Tensor]]:
    """`num_batches` batches of `gen(generator, **kw)`, drawn in turn."""
    for _ in range(num_batches):
        yield gen(generator, **kw)
