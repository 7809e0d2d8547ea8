"""Process groups and data-parallel training over `torch.distributed`.

Counterpart of `equiadapt_tpu/parallel/mesh.py`. The JAX package runs one
SPMD program over a device mesh; here each rank is one process (one GPU,
or one CPU process for the tests) and a mesh is a `DeviceMesh` of the
ranks: NCCL on the card, gloo on the CPU. The rank's processes are made
by `parallel.launch.spawn` or by torchrun.

* `init_distributed` joins the process group (the arguments, else
  torchrun's `MASTER_ADDR` / `MASTER_PORT` / `WORLD_SIZE` / `RANK`); a
  single process with nothing to join is a no-op.
* `make_mesh` is the 1-D "data" mesh of the world.
* `shard_batch` keeps this rank's slice of a global batch, `replicate`
  makes every rank hold rank 0's values (and checks that they already
  did: states built from one seed agree).
* `data_parallel_jit(step_fn, mesh)` runs a step data-parallel. Nothing
  is compiled; the name is the JAX package's. The batch is split over the
  data axis; the step runs inside a `common.layers.batch_shard`, so
  training-mode BatchNorm normalizes with the global batch's statistics
  and per-sample random draws are this rank's rows of the global draw, as
  in the unsharded program; the gradients are averaged over the ranks by
  one all-reduce of a flat buffer per process group and dtype, after the
  backward and before the optimizers (`TrainState.grad_sync`), and the
  returned metrics are means over the global batch.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import datetime
import os
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from equiadapt_tpu_torch.common.layers import BatchShard, batch_shard
from equiadapt_tpu_torch.utils.profiling import annotate

__all__ = [
    "init_distributed",
    "make_mesh",
    "shard_batch",
    "replicate",
    "data_parallel_jit",
    "PartitionSpec",
    "current_mesh",
    "use_mesh",
]

DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


class PartitionSpec(tuple):
    """A leaf's split over mesh axes, one entry per dimension (an axis
    name, or None for a whole dimension): the JAX `PartitionSpec`."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def world_size() -> int:
    """Ranks in the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def device_type() -> str:
    """"cuda" under NCCL, "cpu" otherwise."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return "cuda"
    return "cpu"


def local_device() -> torch.device:
    """This rank's device: its GPU under NCCL, the CPU otherwise."""
    if device_type() == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    expected_processes: Optional[int] = None,
) -> int:
    """Join the process group of a run of several processes; returns the
    world size.

    `coordinator_address` ("host:port"), `num_processes` and `process_id`
    fall back to torchrun's MASTER_ADDR / MASTER_PORT, WORLD_SIZE and RANK.
    With none of them and no `expected_processes` > 1 this is a no-op
    returning 1 (or the size of a group already joined). NCCL when CUDA is
    available (the rank takes GPU LOCAL_RANK, by default its rank), gloo
    otherwise; a collective times out after DEFAULT_TIMEOUT. Raises if the world does not have
    `expected_processes` ranks (`experiment.num_nodes`), rather than going
    on as a divergent partial job, as the JAX function does."""
    if dist.is_initialized():
        count = dist.get_world_size()
    else:
        env = os.environ
        if coordinator_address is None and "MASTER_ADDR" in env:
            coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        if num_processes is None and "WORLD_SIZE" in env:
            num_processes = int(env["WORLD_SIZE"])
        if process_id is None and "RANK" in env:
            process_id = int(env["RANK"])
        if coordinator_address is None and num_processes is None:
            count = 1  # a single process, nothing to join
        else:
            if coordinator_address is None or num_processes is None or process_id is None:
                raise ValueError(
                    "init_distributed needs the coordinator address, the number "
                    "of processes and this process's id (or MASTER_ADDR, "
                    "WORLD_SIZE and RANK)")
            backend = "nccl" if torch.cuda.is_available() else "gloo"
            device = None
            if backend == "nccl":
                device = torch.device("cuda", int(env.get("LOCAL_RANK", process_id)))
                torch.cuda.set_device(device)
            dist.init_process_group(
                backend, init_method=f"tcp://{coordinator_address}",
                world_size=num_processes, rank=process_id, timeout=DEFAULT_TIMEOUT,
                device_id=device)
            count = dist.get_world_size()
    if expected_processes is not None and count != expected_processes:
        raise RuntimeError(
            f"multi-host init produced {count} processes but the run was "
            f"configured for {expected_processes} (experiment.num_nodes) — "
            "refusing to continue as a divergent partial job")
    return count


def _require_group(what: str) -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            f"{what} needs a process group: init_distributed, torchrun or "
            "parallel.launch.spawn first")
    return dist.get_world_size()


def make_grid(shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
    """A DeviceMesh of `shape` over every rank of the world, in rank
    order (the last axis the innermost)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = _require_group("a mesh")
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"mesh {'x'.join(map(str, shape))} needs {n} ranks, "
                         f"the world has {world}")
    return init_device_mesh(device_type(), tuple(shape), mesh_dim_names=tuple(axis_names))


def make_mesh(num_devices: Optional[int] = None, axis_name: str = "data"):
    """1-D data-parallel mesh over the ranks of the world (`num_devices`,
    when given, must be the world size: each rank is one device)."""
    world = _require_group("make_mesh")
    return make_grid((world if num_devices is None else num_devices,), (axis_name,))


def axis_size(mesh, axis_name: str) -> int:
    """Ranks along `axis_name` of a DeviceMesh, or of a {axis: size}
    mapping (the JAX `mesh.shape`, so a rule can be asked without a
    process group)."""
    if isinstance(mesh, dict):
        return int(mesh[axis_name])
    return mesh.size(mesh.mesh_dim_names.index(axis_name))


def _multi_node() -> bool:
    local = os.environ.get("LOCAL_WORLD_SIZE")
    return local is not None and int(local) < world_size()


def axis_slice(n: int, mesh, axis_name: str) -> slice:
    """This rank's rows of a leading axis of n split evenly over `axis_name`."""
    k, r = axis_size(mesh, axis_name), mesh.get_local_rank(axis_name)
    if n % k:
        raise ValueError(f"a batch of {n} does not split over {k} ranks of "
                         f"the {axis_name!r} axis")
    return slice(r * (n // k), (r + 1) * (n // k))


def shard_batch(batch: Any, mesh, axis_name: str = "data") -> Any:
    """This rank's slice of a global batch along the leading axis of every
    tensor leaf (the batch must split evenly). On more than one node each
    rank passes the data it loaded itself, which is taken as it is."""
    if _multi_node():
        return batch

    def take(x):
        return x[axis_slice(x.shape[0], mesh, axis_name)] if torch.is_tensor(x) else x

    return pytree.tree_map(take, batch)


def _state_tensors(tree: Any) -> List[torch.Tensor]:
    """The tensors of a module, a train state (its model and optimizer
    states) or a pytree of tensors."""
    from torch import nn

    if isinstance(tree, nn.Module):
        return list(tree.state_dict().values())
    if hasattr(tree, "model") and hasattr(tree, "optimizers"):
        out = _state_tensors(tree.model)
        for opt in tree.optimizers:
            for st in opt.state.values():
                out += [v for v in st.values() if torch.is_tensor(v)]
        return out
    return [x for x in pytree.tree_leaves(tree) if torch.is_tensor(x)]


def replicate(tree: Any, mesh=None) -> Any:
    """Make every rank hold rank 0's values of a module, train state or
    pytree of tensors (in place; returned). Raises if a rank held other
    values: ranks build their states from the same seed, so a difference
    means diverged inputs."""
    if world_size() == 1:
        return tree
    bad = 0
    for t in _state_tensors(tree):
        if isinstance(t, torch.distributed.tensor.DTensor):
            continue  # sharded, not replicated
        ref = t.detach().clone()
        dist.broadcast(ref, src=0)
        if not torch.equal(ref, t.detach()):
            bad += 1
            with torch.no_grad():
                t.copy_(ref)
    flag = torch.tensor([bad], dtype=torch.int64, device=local_device())
    dist.all_reduce(flag)
    if int(flag.item()):
        raise ValueError(f"replicate: {int(flag.item())} tensors differed from "
                         "rank 0's (states built from different seeds or data?)")
    return tree


@contextlib.contextmanager
def rebind_optimizers(state: Any, convert: Callable) -> Iterator[None]:
    """Within the block the model of train state `state` gets new
    parameter tensors (same names); after it each optimizer holds the new
    ones, its per-parameter state `convert(value, old, new)`'d."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    yield
    new = dict(state.model.named_parameters())
    for opt in state.optimizers:
        moved = collections.defaultdict(dict)
        for g in opt.param_groups:
            params = []
            for p in g["params"]:
                q = new[names[id(p)]]
                if p in opt.state:
                    moved[q] = {k: convert(v, p, q) if torch.is_tensor(v) else v
                                for k, v in opt.state[p].items()}
                params.append(q)
            g["params"] = params
        opt.state = moved


_MESH: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)


def current_mesh():
    """The mesh of the innermost `data_parallel_jit` step or `use_mesh`
    block, or None."""
    return _MESH.get()


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[None]:
    """Within the block, `current_mesh()` is `mesh` (as `jax.set_mesh`)."""
    token = _MESH.set(mesh)
    try:
        yield
    finally:
        _MESH.reset(token)


def data_shard(mesh, axis_name: str, local_rows: int) -> BatchShard:
    """The batch shard of this rank's slice of the data axis."""
    k, r = axis_size(mesh, axis_name), mesh.get_local_rank(axis_name)
    rows = torch.arange(r * local_rows, (r + 1) * local_rows)
    return BatchShard(rows, k * local_rows, mesh.get_group(axis_name))


def grad_sync(mesh, axis_name: str = "data") -> Callable[[Any], None]:
    """The gradient reduction of a data-parallel step: each parameter's
    gradient averaged over the ranks that hold copies of it. A parameter
    split by tensor parallelism (`tp_shard`) is averaged over the data
    axis; one managed by FSDP (a DTensor) is left to FSDP's
    reduce-scatter; every other one over the whole world (ranks off the
    data axis hold identical copies, so the world's mean is the data
    axis's). One all-reduce of a flat buffer per process group and dtype;
    the gradients become views of it; a parameter no rank has a gradient
    for keeps None."""
    data_group = mesh.get_group(axis_name)

    def sync(model) -> None:
        with annotate("dist/grad_sync"):
            buckets: Dict[Tuple[Any, torch.dtype], List[torch.nn.Parameter]] = {}
            for p in model.parameters():
                if not p.requires_grad or isinstance(p, torch.distributed.tensor.DTensor):
                    continue
                group = data_group if getattr(p, "tp_shard", None) is not None else None
                buckets.setdefault((group, p.dtype), []).append(p)
            for (group, dtype), params in buckets.items():
                n = dist.get_world_size(group)
                present = [p.grad is not None for p in params]
                dev = params[0].device
                flags = (torch.ones(len(params), dtype=dtype, device=dev) if all(present)
                         else torch.tensor(present, dtype=dtype, device=dev))
                flat = torch.cat(
                    [(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                     for p in params] + [flags])
                dist.all_reduce(flat, group=group)
                if n > 1:
                    flat.div_(n)
                # every rank took some gradient where this one did; read the
                # counts (a host sync) only where this one took none
                has = [True] * len(params) if all(present) else (flat[-len(params):] > 0).tolist()
                off = 0
                for p, h in zip(params, has):
                    p.grad = flat[off:off + p.numel()].view_as(p) if h else None
                    off += p.numel()

    return sync


def _mean_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each scalar metric's mean over the world's ranks (every rank's is a
    mean over equal shares of the global batch, or a copy)."""
    n = world_size()
    keys = [k for k, v in metrics.items() if torch.is_tensor(v) and v.dim() == 0]
    if n == 1 or not keys:
        return metrics
    vals = torch.stack([metrics[k].float() for k in keys]).to(local_device())
    dist.all_reduce(vals)
    vals = vals / n
    out = dict(metrics)
    for k, v in zip(keys, vals):
        out[k] = v.to(metrics[k].device, metrics[k].dtype)
    return out


def data_parallel_jit(
    step_fn,
    mesh,
    axis_name: str = "data",
    donate_state: bool = True,
    num_extra_args: int = 0,
):
    """`step_fn(state, batch, *extra)` run data-parallel over `mesh`.

    Nothing is compiled (the name is the JAX package's): the step runs
    eagerly on each rank, on the rank's slice of the global `batch` along
    the `axis_name` axis (`shard_batch`), inside a `batch_shard` of that
    slice and with `mesh` as the current mesh. A train step
    (`pipelines.classification.make_train_step`) gets its gradients
    averaged by `grad_sync` before its optimizers step. The step may
    return `(state, metrics)` or `metrics` (an eval step); each scalar
    metric comes back as its mean over the global batch. State and extra
    arguments (a generator seeded the same on every rank) are the ranks'
    own copies; `donate_state` and `num_extra_args` are kept for the JAX
    signature."""
    del donate_state, num_extra_args
    sync = grad_sync(mesh, axis_name)

    def step(state, batch, *extra):
        local = shard_batch(batch, mesh, axis_name)
        rows = next(x for x in pytree.tree_leaves(local) if torch.is_tensor(x)).shape[0]
        has_sync = hasattr(state, "grad_sync")
        if has_sync:
            before, state.grad_sync = state.grad_sync, sync
        try:
            with use_mesh(mesh), batch_shard(data_shard(mesh, axis_name, rows)):
                out = step_fn(state, local, *extra)
        finally:
            if has_sync:
                state.grad_sync = before
        if isinstance(out, tuple) and len(out) == 2 and isinstance(out[1], dict):
            return out[0], _mean_metrics(out[1])
        return _mean_metrics(out)

    return step
