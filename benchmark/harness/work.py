"""The work a cell asks for, counted from the configuration and the shapes.

FLOPs (2 x multiply-accumulate of every convolution and matrix product)
are counted with `FlopCounterMode` on meta tensors run through the
benchmark's reference, never through the program: a hand kernel of the
program then cannot change the count, and work moved from a library call
into a hand kernel still counts. Byte floors count each input byte read
once and each output byte written once, at the dtypes the configuration
states.

Peaks: one NVIDIA H100 SXM (data sheet, dense): 989.4 TFLOP/s bf16,
3.35 TB/s HBM3.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

BF16_PEAK_FLOPS = 989.4e12
HBM_PEAK_BYTES = 3.35e12

_BYTES = {None: 4, "float32": 4, "bfloat16": 2, "float16": 2}


def _meta_weights(ref, settings: dict) -> dict:
    return {name: torch.empty(shape, device="meta")
            for name, shape, _ in ref.param_spec(settings)}


def serve_flops(ref, settings: dict, batch: int) -> int:
    """FLOPs of the reference's eval of one batch at the cell's shapes."""
    size = settings["dataset"]["image_size"]
    x = torch.empty(batch, size, size, settings["dataset"]["in_channels"], device="meta")
    w = _meta_weights(ref, settings)
    with FlopCounterMode(display=False) as counter:
        ref.serve(w, x, settings)
    return int(counter.get_total_flops())


def train_flops(ref, settings: dict, batch: int) -> int:
    """FLOPs of the reference's forward and backward of one step."""
    size = settings["dataset"]["image_size"]
    x = torch.empty(batch, size, size, settings["dataset"]["in_channels"], device="meta")
    y = torch.zeros(batch, dtype=torch.long, device="meta")
    w = _meta_weights(ref, settings)
    leaves = [w[k].requires_grad_(True) for k in ref.trainable(settings)]
    with FlopCounterMode(display=False) as counter:
        loss = ref.loss(w, x, y, None, settings)
        torch.autograd.grad(loss, leaves)
    return int(counter.get_total_flops())


def canon_bytes(settings: dict, batch: int) -> int:
    """The canonicalizer's data-movement floor of one batch: the input
    batch read once, the cropped and resized energy input written once in
    the compute dtype, the canonical batch written once in the output
    dtype."""
    d, c = settings["dataset"], settings["canonicalization"]
    size, ch, r = d["image_size"], d["in_channels"], c["resize_shape"]
    compute = _BYTES[c.get("compute_dtype")]
    out = compute if c.get("output_dtype") == "compute" else _BYTES[None]
    return batch * ch * (size * size * _BYTES[None] + r * r * compute + size * size * out)
