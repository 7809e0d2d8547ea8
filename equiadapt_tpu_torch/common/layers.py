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
* `CastLinear`, `CastConv2d`, `CastConvTranspose2d` and `CastLayerNorm`
  compute in their input's dtype: fp32 parameters cast on every call, as
  Flax's `param_dtype` / `dtype` split (a bf16 model keeps fp32 weights).

Batches split over ranks (`parallel/`): inside `batch_shard(shard)` this
rank holds the rows `shard.rows` of a global batch of `shard.size` rows.
Training-mode `BatchNorm` (and every layer built on it, and
`NormBatchNorm`) then normalizes with the statistics of the global batch,
all-reduced over `shard.group` in two passes (the mean, then the centred
sum of squares) by an autograd-aware all-reduce, and updates its running
statistics from them, as the unsharded program does; in a group of one
rank it takes the plain path. A training-mode BatchNorm outside a batch
shard in a world of more than one rank raises: it would normalize over
the local rows alone. Per-sample random draws (`sharded_draw`: dropout
masks, Gumbel noise, the optimized canonicalizer's artifact rotations)
are made at the global batch's shape from a generator seeded the same on
every rank, and each rank keeps its rows, so a world of N draws what one
rank draws for the whole batch.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from equiadapt_tpu_torch.utils.profiling import annotate

Tensor = torch.Tensor

__all__ = ["BatchNorm", "Dropout", "frozen_batch_stats", "BatchShard",
           "CastLinear", "CastConv2d", "CastConvTranspose2d", "CastLayerNorm",
           "batch_shard", "current_shard", "orbit_shard", "sharded_draw",
           "all_reduce_sum", "all_gather_rows", "global_mean", "stats_shard"]


def _group_size(group) -> int:
    if not dist.is_available() or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of `group`; the backward sums the cotangents
    the same way (each rank's loss is one term of the total)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: Tensor, group=None) -> Tensor:
    """x summed over the ranks of `group`, differentiable; x itself in a
    group of one rank."""
    if _group_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


class _AllGatherRows(torch.autograd.Function):
    """Rows of every rank of `group`, in rank order (rank i holds sizes[i]
    rows); the backward sums the cotangents over the ranks and keeps this
    rank's rows."""

    @staticmethod
    def forward(ctx, x, sizes, group):
        rank = dist.get_rank(group)
        ctx.group, ctx.lo = group, sum(sizes[:rank])
        ctx.hi = ctx.lo + sizes[rank]
        pad = max(sizes)
        buf = x.new_zeros((pad,) + tuple(x.shape[1:]))
        buf[: x.shape[0]] = x
        parts = [torch.empty_like(buf) for _ in sizes]
        dist.all_gather(parts, buf.contiguous(), group=group)
        return torch.cat([p[:n] for p, n in zip(parts, sizes)])

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.lo:ctx.hi], None, None


def all_gather_rows(x: Tensor, sizes: Sequence[int], group=None) -> Tensor:
    """The rows of every rank of `group` concatenated in rank order (rank i
    holds `sizes[i]` rows, possibly none), differentiable; x itself in a
    group of one rank."""
    if _group_size(group) == 1:
        return x
    return _AllGatherRows.apply(x, list(sizes), group)


@dataclass(frozen=True)
class BatchShard:
    """This rank's rows of a batch split over ranks.

    rows: (local rows,) int64, the global row of each local row, in order;
    size: rows of the global batch; group: the process group whose ranks
    hold the global batch between them (None: the default group), over
    which BatchNorm sums its statistics."""

    rows: Tensor
    size: int
    group: Any = None

    @property
    def whole(self) -> bool:
        """One rank holds the whole batch, in order."""
        return self.size == self.rows.numel() and _group_size(self.group) == 1


_SHARD: contextvars.ContextVar = contextvars.ContextVar("batch_shard", default=None)


def current_shard() -> Optional[BatchShard]:
    """The innermost active `batch_shard`, or None."""
    return _SHARD.get()


@contextlib.contextmanager
def batch_shard(shard: Optional[BatchShard]) -> Iterator[None]:
    """Within the block, per-sample draws and training-mode BatchNorm
    statistics treat the leading axis as `shard`'s rows of a global batch
    (None: the batch is whole)."""
    token = _SHARD.set(shard)
    try:
        yield
    finally:
        _SHARD.reset(token)


@contextlib.contextmanager
def orbit_shard(num_group: int, elements: Optional[Sequence[int]] = None,
                group: Any = "same") -> Iterator[None]:
    """Within the block, the leading axis is the group-major |G|-orbit of
    the active shard's rows, holding `elements`' copies (all |G| by
    default), its statistics over `group` (by default the active
    shard's). Nothing changes outside a batch shard."""
    shard = current_shard()
    if shard is None:
        yield
        return
    e = torch.arange(num_group) if elements is None else torch.as_tensor(
        list(elements), dtype=torch.int64)
    rows = (e[:, None] * shard.size + shard.rows[None, :]).reshape(-1)
    with batch_shard(BatchShard(rows, num_group * shard.size,
                                shard.group if group == "same" else group)):
        yield


def sharded_draw(draw: Callable[[tuple], Tensor], shape: Sequence[int]) -> Tensor:
    """`draw(shape)` for a batch whose leading axis is `shape[0]`; inside a
    batch shard, `draw` at the global batch's leading size, this rank's
    rows kept."""
    shard = current_shard()
    if shard is None or shard.whole:
        return draw(tuple(shape))
    if shard.rows.numel() != shape[0]:
        raise ValueError(f"a draw of {shape[0]} rows inside a shard of "
                         f"{shard.rows.numel()} rows")
    full = draw((shard.size,) + tuple(shape[1:]))
    return full.index_select(0, shard.rows.to(full.device))


def stats_shard(training: bool, what: str) -> Optional[BatchShard]:
    """The shard whose statistics a training-mode layer must sum, None
    for the plain path; raises where a world of several ranks has no
    shard."""
    if not training:
        return None
    shard = current_shard()
    if shard is None:
        if _group_size(None) > 1:
            raise RuntimeError(
                f"{what} in training in a world of {_group_size(None)} ranks "
                "normalizes the local rows only: run the step inside a batch "
                "shard (parallel.data_parallel_jit sets one)")
        return None
    return None if shard.whole else shard


def global_mean(x: Tensor, dims: Sequence[int], shard: BatchShard) -> Tensor:
    """The mean of x over `dims` (the batch axis among them) over the
    global batch of `shard`, differentiable."""
    local = x.sum(dim=tuple(dims))
    total = torch.tensor([float(x.numel() // max(local.numel(), 1))],
                         dtype=torch.float64, device=x.device)
    dist.all_reduce(total, group=shard.group)
    return all_reduce_sum(local, shard.group) / total.to(local.dtype)


class _SyncBatchNormFn(torch.autograd.Function):
    """Training BatchNorm over a batch split over the ranks of `group`:
    the global mean, then the global centred sum of squares (two
    all-reduces; the biased variance), in fp32 at least whatever x's dtype;
    the backward all-reduces the two per-channel sums it needs."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        C = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        stats = torch.cat([xf.sum(dims), torch.full((1,), float(x.numel() // C),
                                                    dtype=xf.dtype, device=x.device)])
        with annotate("dist/sync_bn"):
            dist.all_reduce(stats, group=group)
        n = stats[-1]
        mean = stats[:C] / n
        shape = [1, C] + [1] * (x.dim() - 2)
        m2 = ((xf - mean.view(shape)) ** 2).sum(dims)
        with annotate("dist/sync_bn"):
            dist.all_reduce(m2, group=group)
        var = m2 / n
        invstd = torch.rsqrt(var + eps)
        y = (xf - mean.view(shape)) * (invstd * weight).view(shape) + bias.view(shape)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.group, ctx.n = group, n
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, g, _gm, _gv):
        x, weight, mean, invstd = ctx.saved_tensors
        C = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        shape = [1, C] + [1] * (x.dim() - 2)
        gf = g.to(mean.dtype)
        xhat = (x.to(mean.dtype) - mean.view(shape)) * invstd.view(shape)
        db = gf.sum(dims)
        dw = (gf * xhat).sum(dims)
        sums = torch.cat([db * weight, dw * weight])
        with annotate("dist/sync_bn"):
            dist.all_reduce(sums, group=ctx.group)
        sum_dy, sum_dy_xhat = sums[:C] / ctx.n, sums[C:] / ctx.n
        dx = (gf * weight.view(shape) - sum_dy.view(shape)
              - xhat * sum_dy_xhat.view(shape)) * invstd.view(shape)
        return dx.to(x.dtype), dw, db, None, None


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
        shard = stats_shard(training, "BatchNorm")
        if shard is not None:
            return self._synced_forward(x, shard)
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

    def _synced_forward(self, x: Tensor, shard: BatchShard) -> Tensor:
        y, mean, var = _SyncBatchNormFn.apply(x, self.weight, self.bias,
                                              self.eps, shard.group)
        if self.update_stats:
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m)
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
    """Dropout whose mask comes from `generator` (on the input's device).

    The mask is a per-sample draw (`sharded_draw`). With `feature_index`
    set (a tensor-parallel slice of the last axis), the mask is drawn at
    the full width `feature_size` and the slice kept, so every rank drops
    what the unsharded layer drops."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.feature_index: Optional[Tensor] = None
        self.feature_size = 0

    def forward(self, x: Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        if not training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError(
                f"dropout (rate {self.rate}) in training draws its mask from "
                "a generator: pass generator=")
        keep_prob = 1.0 - self.rate
        shape = tuple(x.shape)
        if self.feature_index is not None:
            shape = shape[:-1] + (self.feature_size,)
        keep = sharded_draw(lambda s: torch.bernoulli(
            torch.full(s, keep_prob, dtype=torch.float32, device=x.device),
            generator=generator), shape)
        if self.feature_index is not None:
            keep = keep.index_select(-1, self.feature_index.to(x.device))
        keep = keep.bool()
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def _cast(t: Optional[Tensor], x: Tensor) -> Optional[Tensor]:
    return None if t is None else t.to(x.dtype)


class CastLinear(nn.Linear):
    """Linear that computes in its input's dtype (weights cast per call)."""

    def forward(self, x: Tensor) -> Tensor:
        return F.linear(x, _cast(self.weight, x), _cast(self.bias, x))


class CastConv2d(nn.Conv2d):
    """Conv2d that computes in its input's dtype (weights cast per call)."""

    def forward(self, x: Tensor) -> Tensor:
        return self._conv_forward(x, _cast(self.weight, x), _cast(self.bias, x))


class CastConvTranspose2d(nn.ConvTranspose2d):
    """ConvTranspose2d that computes in its input's dtype (weights cast per
    call)."""

    def forward(self, x: Tensor) -> Tensor:
        return F.conv_transpose2d(x, _cast(self.weight, x), _cast(self.bias, x),
                                  self.stride, self.padding)


class CastLayerNorm(nn.LayerNorm):
    """LayerNorm with its weights cast per call to its input's dtype (the
    CUDA kernel takes one dtype; the statistics are fp32 either way)."""

    def forward(self, x: Tensor) -> Tensor:
        return F.layer_norm(x, self.normalized_shape, _cast(self.weight, x),
                            _cast(self.bias, x), self.eps)
