"""BatchNorm and Dropout with Flax's training semantics.

The JAX package's modules take `training` as an argument, and the port's
modules of the discrete main path do the same: these layers ignore the
torch module mode (`.train()` / `.eval()`).

* `BatchNorm` (a `torch.nn.BatchNorm2d`, so weights load by the usual
  renaming) normalizes a (B, C, ...) tensor per channel. In eval it reads
  the running statistics; in training it normalizes with the batch mean
  and biased variance and updates the running statistics as Flax does:
  ra = m * ra + (1 - m) * batch, with Flax's momentum m (torch's is 1 - m)
  and the *biased* batch variance. `F.batch_norm` computes the statistics
  once and updates with the unbiased variance, n / (n - 1) times the biased
  one; a per-channel correction afterwards turns that update into Flax's,
  so no second pass over the activations is made.
  Parameters and running statistics stay fp32 for any input dtype, and the
  output takes the input's dtype, as Flax's `param_dtype` / `dtype` split.
* `frozen_batch_stats(module)` suspends the update inside a block: the
  forward that `torch.utils.checkpoint` recomputes on the backward pass
  must not update the statistics a second time (Flax's `nn.remat` does
  not).
* `Dropout` draws its keep mask from an explicit `torch.Generator` (as
  Flax draws from its "dropout" rng) and scales the kept values by
  1 / (1 - rate); `F.dropout` takes no generator.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor

__all__ = ["BatchNorm", "Dropout", "frozen_batch_stats"]


class BatchNorm(nn.BatchNorm2d):
    """Flax-semantics BatchNorm over dim 1 of a (B, C, ...) tensor.

    Args:
        num_features: C.
        momentum: Flax's momentum (0.99 for Flax's default, 0.9 for the
            fiber BatchNorm of the GCNNs).
        epsilon: added to the variance.
    """

    def __init__(self, num_features: int, momentum: float = 0.99,
                 epsilon: float = 1e-5, device="cuda"):
        super().__init__(num_features, eps=epsilon, momentum=1.0 - momentum,
                         device=device)
        self.update_stats = True

    def forward(self, x: Tensor, training: bool = False) -> Tensor:
        if not training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        # F.batch_norm updates copies, which autograd keeps for the backward
        # (and which the recompute of `torch.utils.checkpoint` makes again)
        m = self.momentum
        rm, rv = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, rm, rv, self.weight, self.bias, True, m, self.eps)
        if self.update_stats:
            # rv = (1 - m) ra + m n / (n - 1) var  ->  (1 - m) ra + m var
            n = x.numel() // x.shape[1]
            with torch.no_grad():
                self.running_var.mul_((1.0 - m) / n).add_(rv, alpha=(n - 1) / n)
                self.running_mean.copy_(rm)
        return y


@contextlib.contextmanager
def frozen_batch_stats(module: nn.Module) -> Iterator[None]:
    """Within the block, training-mode `BatchNorm`s of `module` normalize
    with batch statistics but leave their running statistics as they are."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    before = [m.update_stats for m in norms]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m, flag in zip(norms, before):
            m.update_stats = flag


class Dropout(nn.Module):
    """Dropout whose mask comes from `generator` (on the input's device)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        if not training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError(
                f"dropout (rate {self.rate}) in training draws its mask from "
                "a generator: pass generator=")
        keep_prob = 1.0 - self.rate
        keep = torch.bernoulli(
            torch.full(x.shape, keep_prob, dtype=torch.float32, device=x.device),
            generator=generator).bool()
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))
