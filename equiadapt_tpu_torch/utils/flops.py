"""Analytic FLOP counting: the numerator of MFU.

Counterpart of `equiadapt_tpu/utils/flops.py`. `count_flops(fn, *args)`
runs `fn` once under `torch.utils.flop_counter.FlopCounterMode` on copies
of its arguments on the "meta" device: tensors and modules among the
arguments (in lists, tuples and dicts too) are copied there, so the call
propagates shapes only, reads no data and does no device work, and the
caller's tensors and modules are left as they were. Matmuls and
convolutions (forward and backward) count 2 x MAC, the JAX walker's
convention; elementwise work is left out, so MFU stays a matmul-unit
utilisation.

Within the count the kernel wrappers return an empty result of the
kernel's shape on meta tensors (`ops.kernels._build.shapes_only`), so the
hand-written kernels count 0, as Pallas calls do in the JAX walker.

A backward pass counts when `fn` runs one (`torch.autograd.grad` on the
loss): a training step's matmul work is its forward and backward; the
optimizer's update is elementwise. `train_step_flops(loss_fn, model,
*inputs)` counts that for any step whose loss is `loss_fn(model, *inputs)`
(the point-cloud classification and part-segmentation steps, for MFU).
"""

from __future__ import annotations

import copy
from typing import Any

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from equiadapt_tpu_torch.ops.kernels import _build

__all__ = ["count_flops", "train_step_flops", "resnet50_eval_flops"]


def _to_meta(tree: Any, memo: dict) -> Any:
    if isinstance(tree, nn.Module):
        for p in tree.parameters():
            memo.setdefault(id(p), nn.Parameter(p.detach().to("meta"),
                                                requires_grad=p.requires_grad))
        for b in tree.buffers():
            memo.setdefault(id(b), b.to("meta"))
        return copy.deepcopy(tree, memo)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("meta").requires_grad_(tree.requires_grad)
    if isinstance(tree, dict):
        return {k: _to_meta(v, memo) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_meta(v, memo) for v in tree)
    return tree


def count_flops(fn, *args, **kwargs) -> float:
    """Matmul + convolution FLOPs of one call of `fn(*args, **kwargs)`,
    run on meta copies of the tensors and modules among the arguments."""
    memo: dict = {}
    margs = _to_meta(args, memo)
    mkwargs = _to_meta(kwargs, memo)
    with _build.shapes_only(), FlopCounterMode(display=False) as counter:
        fn(*margs, **mkwargs)
    return float(counter.get_total_flops())


def train_step_flops(loss_fn, model: nn.Module, *inputs) -> float:
    """Matmul + convolution FLOPs of one training step's forward and
    backward: `loss_fn(model, *inputs)` -> scalar loss, then its gradient
    to every trainable parameter, on meta copies (grad mode on whatever
    the caller's)."""
    def fwd_bwd(m, *args):
        with torch.enable_grad():
            loss = loss_fn(m, *args)
            torch.autograd.grad(loss, [p for p in m.parameters() if p.requires_grad])

    return count_flops(fwd_bwd, model, *inputs)


def resnet50_eval_flops(batch: int, image: int = 224) -> float:
    """Closed-form anchor: a torchvision-style ResNet-50 forward is about
    4.09 GMAC an image at 224 px, 8.18 GFLOP in the 2 x MAC convention."""
    return 8.18e9 * batch * (image / 224.0) ** 2
