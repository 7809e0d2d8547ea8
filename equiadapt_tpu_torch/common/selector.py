"""Discrete group-element selection on (B, |G|) activations.

Counterpart of `equiadapt_tpu/common/selector.py`. Ties go to the first
maximum, as `jnp.argmax` and `torch.argmax` both pick. The Gumbel variant
takes its noise as a tensor (a test hands the JAX noise across), or draws
it from the `torch.Generator` given, as the JAX package draws it from its
"gumbel" rng (at the global batch's shape inside a batch shard,
`common.layers.sharded_draw`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from equiadapt_tpu_torch.common.layers import sharded_draw

Tensor = torch.Tensor

__all__ = [
    "gumbel_noise",
    "hard_onehot",
    "straight_through_onehot",
    "gumbel_softmax_onehot",
    "select_onehot",
]


def hard_onehot(group_activations: Tensor) -> Tensor:
    """Argmax one-hot over the last axis, in the activations' dtype."""
    idx = torch.argmax(group_activations, dim=-1)
    return F.one_hot(idx, group_activations.shape[-1]).to(group_activations.dtype)


def straight_through_onehot(
    group_activations: Tensor, beta: float = 1.0, training: bool = True
) -> Tensor:
    """Forward = argmax one-hot, backward = softmax(beta * activations);
    the hard one-hot alone outside training."""
    hard = hard_onehot(group_activations)
    if not training:
        return hard
    soft = torch.softmax(beta * group_activations, dim=-1)
    return hard + soft - soft.detach()


def gumbel_noise(shape, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32) -> Tensor:
    """Gumbel(0, 1) draws -log(-log(u)), u uniform in [tiny, 1), on the
    generator's device (`jax.random.gumbel`'s construction)."""
    tiny = torch.finfo(dtype).tiny
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def gumbel_softmax_onehot(
    group_activations: Tensor, gumbels: Tensor, tau: float = 1.0
) -> Tensor:
    """Hard Gumbel-softmax with the Gumbel(0, 1) noise `gumbels` given."""
    perturbed = (group_activations + gumbels) / tau
    soft = torch.softmax(perturbed, dim=-1)
    hard = hard_onehot(perturbed)
    return hard + soft - soft.detach()


def select_onehot(
    group_activations: Tensor,
    *,
    gradient_trick: str = "straight_through",
    beta: float = 1.0,
    training: bool = True,
    gumbels: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tensor:
    """Dispatch on the gradient trick, as the JAX package does. The
    Gumbel trick in training takes `gumbels`, or draws them from
    `generator`."""
    if gradient_trick == "straight_through":
        return straight_through_onehot(group_activations, beta=beta, training=training)
    if gradient_trick == "gumbel_softmax":
        if not training:
            return hard_onehot(group_activations)
        if gumbels is None:
            if generator is None:
                raise ValueError(
                    "gumbel_softmax needs its noise (gumbels=) or a generator "
                    "during training")
            gumbels = sharded_draw(
                lambda shape: gumbel_noise(shape, generator, group_activations.dtype),
                group_activations.shape)
        return gumbel_softmax_onehot(group_activations, gumbels)
    raise ValueError(f"Gradient trick {gradient_trick} not implemented")
