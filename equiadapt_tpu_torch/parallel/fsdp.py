"""FSDP sharding of parameters and optimizer moments over the data mesh.

Counterpart of `equiadapt_tpu/parallel/fsdp.py`, on FSDP2 (`fully_shard`).
The rule is the JAX package's, applied to each parameter's Flax leaf
(`utils.jax_weights.flax_leaf_layouts`): a leaf of at least
`min_shard_bytes` is split along its largest dimension that the mesh size
divides; smaller or indivisible leaves are replicated. The chosen Flax
dimension is split along the torch dimension it runs along
(`shard_placement_fn`), and replicated leaves are left out of FSDP
(`ignored_params`), so their gradients are averaged by
`parallel.data_parallel_jit`'s all-reduce while FSDP reduce-scatters the
sharded ones. Inside the forward FSDP all-gathers the sharded parameters.

`shard_state_fsdp` shards the model of a train state and moves its
optimizers onto the sharded parameters, so their moments are sharded the
same way (a parameter group holding both kinds is split in two, since the
multi-tensor updates take DTensors and plain tensors apart); BatchNorm
statistics (buffers) and the step count stay replicated.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, Optional

import torch
from torch import nn

from equiadapt_tpu_torch.parallel.mesh import axis_size, rebind_optimizers
from equiadapt_tpu_torch.utils.jax_weights import flax_leaf_layouts

__all__ = ["fsdp_sharding", "shard_params_fsdp", "shard_state_fsdp"]


def fsdp_sharding(x: Any, mesh, axis_name: str = "data",
                  min_shard_bytes: int = 1 << 17) -> Optional[int]:
    """The dimension of x (anything with `.shape` and `.dtype`: a tensor,
    a numpy array) to split over `axis_name`, or None to replicate it: the
    largest dimension that the axis size divides, for a leaf of at least
    `min_shard_bytes` (ties to the first)."""
    shape = tuple(x.shape)
    size = 1
    for s in shape:
        size *= int(s)
    itemsize = getattr(getattr(x, "dtype", None), "itemsize", 4)
    n = axis_size(mesh, axis_name)
    if size * itemsize >= min_shard_bytes:
        for d in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if shape[d] >= n and shape[d] % n == 0:
                return d
    return None


def fsdp_placements(module: nn.Module, mesh, axis_name: str = "data",
                    min_shard_bytes: int = 1 << 17) -> Dict[str, Optional[int]]:
    """{parameter name: the torch dimension to split, or None} by
    `fsdp_sharding` of each parameter's Flax leaf."""
    params = dict(module.named_parameters())
    out = {}
    for leaf in flax_leaf_layouts(module):
        if leaf.name not in params:
            continue  # BatchNorm statistics stay replicated
        d = fsdp_sharding(SimpleNamespace(shape=leaf.shape, dtype=params[leaf.name].dtype),
                          mesh, axis_name, min_shard_bytes)
        out[leaf.name] = None if d is None else leaf.dims[d]
    return out


def shard_params_fsdp(tree: nn.Module, mesh, axis_name: str = "data",
                      min_shard_bytes: int = 1 << 17) -> nn.Module:
    """`fully_shard` the module (in place; returned) with per-parameter
    placements from `fsdp_placements`; replicated parameters are left out
    of FSDP."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    placements = fsdp_placements(tree, mesh, axis_name, min_shard_bytes)
    params = dict(tree.named_parameters())
    shard = {id(params[n]): Shard(d) for n, d in placements.items() if d is not None}
    if not shard:
        return tree
    ignored = {p for p in params.values() if id(p) not in shard}
    sub = mesh[axis_name] if len(mesh.mesh_dim_names or ()) > 1 else mesh
    fully_shard(tree, mesh=sub, shard_placement_fn=lambda p: shard[id(p)],
                ignored_params=ignored)
    return tree


def shard_state_fsdp(state: Any, mesh, axis_name: str = "data",
                     min_shard_bytes: int = 1 << 17) -> Any:
    """Shard a `TrainState` (in place; returned): the model's parameters by
    `shard_params_fsdp`, its optimizers' moments along with them."""
    from torch.distributed.tensor import DTensor

    def moment(value: torch.Tensor, old: torch.Tensor, new: torch.Tensor):
        if not isinstance(new, DTensor) or value.shape != old.shape:
            return value
        local = new.to_local()
        (dim,) = [p.dim for p in new.placements]
        k = new.device_mesh.get_local_rank()
        part = value.chunk(new.device_mesh.size(), dim)[k]
        assert part.shape == local.shape, (part.shape, local.shape)
        return DTensor.from_local(part.clone(), new.device_mesh, new.placements,
                                  run_check=False)

    with rebind_optimizers(state, moment):
        shard_params_fsdp(state.model, mesh, axis_name, min_shard_bytes)
    _split_mixed_groups(state)
    return state


def _split_mixed_groups(state: Any) -> None:
    """Each optimizer parameter group that holds sharded (DTensor) and
    replicated parameters becomes two groups with the same options: the
    fused multi-tensor (foreach) updates take one kind at a time. A
    scheduler's per-group lists follow the split."""
    from torch.distributed.tensor import DTensor

    for opt in state.optimizers:
        n = len(opt.param_groups)
        groups, origin = [], []
        for i, g in enumerate(opt.param_groups):
            for sharded in (True, False):
                params = [p for p in g["params"] if isinstance(p, DTensor) == sharded]
                if params:
                    groups.append({**g, "params": params})
                    origin.append(i)
        if len(groups) == n:
            continue
        opt.param_groups = groups
        for sched in state.schedulers:
            if getattr(sched, "optimizer", None) is opt:
                for name, value in vars(sched).items():
                    if isinstance(value, list) and len(value) == n:
                        setattr(sched, name, [value[i] for i in origin])
