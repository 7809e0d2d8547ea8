"""Pipeline parallelism (GPipe) over a "stage" mesh of ranks.

Counterpart of `equiadapt_tpu/parallel/pp.py`. A trunk of L identical
blocks, its parameters stacked on a leading L axis (`stack_layer_params`),
runs as S stages of L / S consecutive blocks, one stage a rank, on M
microbatches: stage s takes microbatch m from stage s - 1 (stage 0 from
the queue), applies its blocks and sends the result to stage s + 1 by
point-to-point sends (`dist.isend` / `dist.irecv`); each rank goes
through the microbatches in order, which is GPipe's fill and drain, with
the bubble (S - 1) / (M + S - 1). Stage S - 1's outputs are broadcast, so
every rank returns the whole (B, ...) result, equal to the blocks applied
in order.

The backward runs through the sends, in reverse (as the transpose of the
JAX ppermute does): `pipeline_apply` is an autograd function whose
backward goes through the microbatches from the last, each stage
recomputing its blocks on the input it kept, taking the cotangent of its
output from stage s + 1 (stage S - 1: the caller's, the same on every
rank) and sending its input's cotangent to stage s - 1. Each rank's
gradient of the stacked parameters is non-zero in its own stage's layers
only (the JAX result is sharded over the stages the same way); the
cotangent of x reaches every rank.

Training: with `rng` (an integer seed) each block's generator is seeded
from (rng, global layer, microbatch), the counterpart of the JAX
`fold_in`, so dropout is a function of (layer, microbatch) whatever the
schedule, and the recompute of the backward draws the same masks.

`shard_queue=True` keeps only each rank's M / S microbatches of the queue
(the owner sends each to stage 0 when it is due) and of the outputs
(stage S - 1 sends each output microbatch to its owner); the whole result
is then all-gathered, numerically the same as the broadcast.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from equiadapt_tpu_torch.parallel.mesh import axis_size, make_grid

Tensor = torch.Tensor

__all__ = [
    "stack_layer_params",
    "make_mesh_stage",
    "pipeline_apply",
    "vit_pipeline_apply",
    "fold_in",
]


def make_mesh_stage(n_stage: int, axis_name: str = "stage"):
    """1-D pipeline mesh over the world's ranks (n_stage of them)."""
    return make_grid((n_stage,), (axis_name,))


def _flat(params: Any, prefix: str = "") -> Dict[str, Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    out = {}
    for k, v in params.items():
        name = f"{prefix}{k}"
        if isinstance(v, (dict, nn.Module)):
            out.update({f"{name}.{kk}": vv for kk, vv in _flat(v).items()})
        else:
            out[name] = v
    return out


def stack_layer_params(params: Any, prefix: str) -> Dict[str, Tensor]:
    """The parameters of blocks `{prefix}0 .. {prefix}{L-1}` stacked on a
    leading L axis, {name within a block: (L, ...)}. `params`: a module
    (its named parameters), or a dict of tensors, of dicts or of modules
    keyed like the Flax tree (`{"Block_0": {"w": ...}, ...}`)."""
    flat = _flat(params)
    n = 0
    while any(k.startswith(f"{prefix}{n}.") for k in flat):
        n += 1
    if n == 0:
        raise ValueError(f"no '{prefix}*' subtrees in params")
    layers = []
    for i in range(n):
        head = f"{prefix}{i}."
        layers.append({k[len(head):]: v for k, v in flat.items() if k.startswith(head)})
    return {k: torch.stack([layer[k] for layer in layers]) for k in layers[0]}


def fold_in(seed: int, *ints: int) -> int:
    """A generator seed from `seed` and `ints` (numpy's SeedSequence)."""
    return int(np.random.SeedSequence([int(seed) & 0xFFFFFFFF, *map(int, ints)])
               .generate_state(1, np.uint64)[0] >> 1)


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, x, *values):
        S, s, group, M = cfg["S"], cfg["s"], cfg["group"], cfg["M"]
        params = dict(zip(cfg["keys"], values))
        B = x.shape[0]
        mbq = x.detach().reshape(M, B // M, *x.shape[1:])
        chunk = M // S
        peer = lambda k: dist.get_global_rank(group, k)
        sends, kept, outs = [], [], []
        if cfg["shard_queue"]:
            # owners hand stage 0 their microbatches, in order
            mine = range(s * chunk, (s + 1) * chunk)
            if s > 0:
                sends += [dist.isend(mbq[m].contiguous(), peer(0), group=group)
                          for m in mine]
        for m in range(M):
            if s == 0:
                owner = m // chunk if cfg["shard_queue"] else 0
                if owner == 0:
                    h = mbq[m]
                else:
                    h = torch.empty_like(mbq[m])
                    dist.recv(h, peer(owner), group=group)
            else:
                h = torch.empty_like(mbq[m])
                dist.recv(h, peer(s - 1), group=group)
            kept.append(h)
            with torch.no_grad():
                y = _stage(cfg, params, h, m)
            if s < S - 1:
                sends.append(dist.isend(y.contiguous(), peer(s + 1), group=group))
            outs.append(y)  # kept alive until its send is done
        for w in sends:
            w.wait()
        if cfg["shard_queue"]:
            out = _collect_sharded(cfg, outs, mbq)
        else:
            out = torch.stack(outs) if s == S - 1 else torch.empty_like(mbq)
            if S > 1:
                dist.broadcast(out, peer(S - 1), group=group)
        ctx.cfg = cfg
        ctx.save_for_backward(*values)
        ctx.kept = kept
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, grad_out):
        cfg = ctx.cfg
        S, s, group, M = cfg["S"], cfg["s"], cfg["group"], cfg["M"]
        values = ctx.saved_tensors
        peer = lambda k: dist.get_global_rank(group, k)
        gmb = grad_out.reshape(M, -1, *grad_out.shape[1:])
        lo, hi = s * cfg["L_loc"], (s + 1) * cfg["L_loc"]
        grads = [torch.zeros_like(v) for v in values]
        gx = torch.zeros_like(gmb)
        sends = []
        for m in reversed(range(M)):
            if s == S - 1:
                g = gmb[m]
            else:
                g = torch.empty_like(ctx.kept[m])
                dist.recv(g, peer(s + 1), group=group)
            h = ctx.kept[m].detach().requires_grad_()
            local = [v[lo:hi].detach().requires_grad_() for v in values]
            with torch.enable_grad():
                y = _stage(cfg, dict(zip(cfg["keys"], local)), h, m, sliced=True)
                got = torch.autograd.grad(y, [h] + local, g, allow_unused=True)
            for acc, d in zip(grads, got[1:]):
                if d is not None:
                    acc[lo:hi] += d
            if s > 0:
                sends.append(dist.isend(got[0].contiguous(), peer(s - 1), group=group))
                ctx.kept[m] = got[0]  # alive until its send is done
            else:
                gx[m] = got[0]
        for w in sends:
            w.wait()
        if S > 1:
            dist.broadcast(gx, peer(0), group=group)
        ctx.kept = None
        return (None, gx.reshape(grad_out.shape), *grads)


def _stage(cfg, params: Dict[str, Tensor], h: Tensor, m: int, sliced: bool = False) -> Tensor:
    """Stage s's blocks on microbatch m's activations."""
    L_loc, s = cfg["L_loc"], cfg["s"]
    for li in range(L_loc):
        layer = s * L_loc + li
        p = {k: v[li] if sliced else v[layer] for k, v in params.items()}
        if cfg["rng"] is None:
            h = cfg["block_fn"](p, h)
        else:
            gen = torch.Generator(device=h.device).manual_seed(fold_in(cfg["rng"], layer, m))
            h = cfg["block_fn"](p, h, gen)
    return h


def _collect_sharded(cfg, outs: List[Tensor], mbq: Tensor) -> Tensor:
    """shard_queue: stage S - 1 sends output microbatch m to its owner
    (m // (M / S)); the owners' chunks are then all-gathered."""
    S, s, group, M = cfg["S"], cfg["s"], cfg["group"], cfg["M"]
    chunk = M // S
    peer = lambda k: dist.get_global_rank(group, k)
    mine = torch.empty_like(mbq[:chunk])
    sends = []
    if s == S - 1:
        for m, y in enumerate(outs):
            if m // chunk == s:
                mine[m % chunk] = y
            else:
                sends.append(dist.isend(y.contiguous(), peer(m // chunk), group=group))
    else:
        for i in range(chunk):
            dist.recv(mine[i], peer(S - 1), group=group)
    for w in sends:
        w.wait()
    parts = [torch.empty_like(mine) for _ in range(S)]
    dist.all_gather(parts, mine, group=group)
    return torch.cat(parts)


def pipeline_apply(
    block_fn: Callable[..., Tensor],
    stacked_params: Dict[str, Tensor],
    x: Tensor,
    mesh,
    *,
    num_microbatches: int,
    axis: str = "stage",
    rng: Optional[int] = None,
    shard_queue: bool = False,
) -> Tensor:
    """Run a stacked block trunk as a pipeline of the `axis` ranks.

    Args:
        block_fn: (one layer's parameters {name: tensor}, activations) ->
            activations of the same shape; with `rng`, (parameters,
            activations, generator) -> activations.
        stacked_params: {name: (L, ...)} (`stack_layer_params`); L must
            split into the stage count.
        x: (B, ...) trunk input, the same on every rank; B must split into
            `num_microbatches`.
        mesh: a mesh with the pipeline axis (`make_mesh_stage`).
        rng: an integer seed; each block's generator is seeded from (rng,
            global layer, microbatch) (`fold_in`).
        shard_queue: each rank keeps M / S microbatches of the queue and of
            the outputs (M must be divisible by the stage count).

    Returns:
        (B, ...) trunk output on every rank, equal to the blocks applied in
        order; differentiable in x and the stacked parameters.
    """
    S = axis_size(mesh, axis)
    keys = list(stacked_params)
    L = stacked_params[keys[0]].shape[0]
    if L % S:
        raise ValueError(f"{L} layers do not split into {S} stages")
    M = num_microbatches
    if x.shape[0] % M:
        raise ValueError(f"batch {x.shape[0]} does not split into {M} microbatches")
    if shard_queue and M % S:
        raise ValueError(
            f"shard_queue needs num_microbatches ({M}) divisible by the "
            f"stage count ({S})")
    cfg = {"S": S, "s": mesh.get_local_rank(axis), "group": mesh.get_group(axis),
           "M": M, "L_loc": L // S, "keys": keys, "block_fn": block_fn,
           "rng": rng, "shard_queue": shard_queue}
    return _GPipe.apply(cfg, x, *[stacked_params[k] for k in keys])


def vit_pipeline_apply(
    vit: nn.Module,
    variables: Optional[Dict[str, Tensor]],
    x: Tensor,
    mesh,
    *,
    num_microbatches: int,
    axis: str = "stage",
    training: bool = False,
    rng: Optional[int] = None,
    shard_queue: bool = False,
) -> Tensor:
    """`models.ViT`'s forward with its encoder trunk pipelined.

    The patch convolution, CLS token and position embeddings, the final
    LayerNorm and the head run on every rank; the `EncoderBlock_i` stack is
    `pipeline_apply`'d. `variables`: {torch name: tensor} of the ViT's
    parameters, or None for the module's own. With training=True pass
    `rng`: each block's dropout generator is seeded from (rng, layer,
    microbatch). As the JAX function, no dropout is applied to the
    embeddings."""
    p = dict(vit.named_parameters()) if variables is None else variables
    B = x.shape[0]
    conv = vit.Conv_0
    h = F.conv2d(x.permute(0, 3, 1, 2), p["Conv_0.weight"], p["Conv_0.bias"],
                 stride=conv.stride).flatten(2).transpose(1, 2)
    h = torch.cat([p["cls_token"].expand(B, -1, -1), h], dim=1) + p["pos_embedding"]
    block = vit.EncoderBlock_0
    stacked = stack_layer_params(p, "EncoderBlock_")
    if training:
        if rng is None:
            raise ValueError("training=True needs an rng for dropout")

        def block_fn(bp, hh, gen):
            return torch.func.functional_call(block, bp, (hh, True, gen))
    else:
        rng = None

        def block_fn(bp, hh):
            return torch.func.functional_call(block, bp, (hh, False))

    h = pipeline_apply(block_fn, stacked, h, mesh, num_microbatches=num_microbatches,
                       axis=axis, rng=rng, shard_queue=shard_queue)
    ln = vit.LayerNorm_0
    h = F.layer_norm(h, ln.normalized_shape, p["LayerNorm_0.weight"],
                     p["LayerNorm_0.bias"], ln.eps)
    return F.linear(h[:, 0], p["Dense_0.weight"], p["Dense_0.bias"])
