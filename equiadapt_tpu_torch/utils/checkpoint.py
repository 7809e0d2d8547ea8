"""Checkpoints of a train state, with the config beside them.

Counterpart of `equiadapt_tpu/utils/checkpoint.py`, on torch files instead
of Orbax. A checkpoint directory holds `state.pt` (the module's state dict,
each optimizer's and scheduler's state dict, and the step) and, when a
config is given, `config.json` in the JAX package's format, so
`restore_config` reads a config saved by either package. Tensors are loaded
onto the CPU and copied into the state's own tensors, so a state restores
on the device it lives on.

A state sharded over ranks (`parallel.shard_state_fsdp`'s DTensors,
`parallel.shard_state_tp`'s slices) is saved whole: every rank takes part
in gathering each sharded parameter and moment, and rank 0 alone writes
(the other ranks wait for it). Restoring reads the whole tensors on every
rank and keeps each rank's shard, so the restored tensors have the
template's placements.
"""

from __future__ import annotations

import collections
import concurrent.futures
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from equiadapt_tpu_torch.utils.config import Config

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "restore_config",
    "load_prediction_params_from",
    "best_metric_saver",
    "AsyncTrainCheckpointer",
]

_STATE = "state.pt"


def _config_path(path: str) -> str:
    return os.path.join(path, "config.json")


def _write_config(path: str, config: Config) -> None:
    with open(_config_path(path), "w") as f:
        json.dump(config.to_dict(), f, indent=2)


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _tp_gather(t: torch.Tensor, shard) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in shard.indices]
    dist.all_gather(parts, t.detach().contiguous(), group=shard.group)
    shape = list(t.shape)
    shape[shard.dim] = shard.size
    full = t.new_empty(shape)
    for idx, part in zip(shard.indices, parts):
        full.index_copy_(shard.dim, idx.to(t.device), part)
    return full


def _whole(t: Any, param: Any) -> Any:
    """t (a parameter, or an optimizer state of `param`) as a whole
    tensor: a DTensor's full tensor, a tensor-parallel slice gathered."""
    if isinstance(t, DTensor):
        return t.full_tensor()
    shard = getattr(param, "tp_shard", None)
    if shard is not None and torch.is_tensor(t) and t.shape == param.shape:
        return _tp_gather(t, shard)
    return t


def _shard_of(full: Any, like: Any, param: Any) -> Any:
    """The inverse of `_whole`: this rank's shard of `full`, laid out
    as `like` (the state's own tensor) and `param`."""
    if isinstance(like, DTensor):
        (dim,) = [p.dim for p in like.placements]
        mesh = like.device_mesh
        part = full.chunk(mesh.size(), dim)[mesh.get_local_rank()]
        return DTensor.from_local(part.to(like.device, like.dtype).clone(), mesh,
                                  like.placements, run_check=False)
    shard = getattr(param, "tp_shard", None)
    if shard is not None and torch.is_tensor(full) and full.dim() == param.dim() \
            and full.shape[shard.dim] == shard.size != param.shape[shard.dim]:
        return full.index_select(shard.dim, shard.index)
    return full


def _opt_params(opt) -> List[Any]:
    """An optimizer's parameters in its state dict's numbering."""
    return [p for g in opt.param_groups for p in g["params"]]


def _snapshot(state: Any) -> Dict[str, Any]:
    """The state as a dict of CPU copies (training may go on changing the
    state's tensors in place while the snapshot is written); sharded
    tensors whole (every rank must call it)."""
    params = dict(state.model.named_parameters())
    model = {k: _whole(v, params.get(k)) for k, v in state.model.state_dict().items()}
    optimizers = []
    for opt in state.optimizers:
        sd = opt.state_dict()
        ps = _opt_params(opt)
        sd["state"] = {i: {k: _whole(v, ps[i]) for k, v in st.items()}
                       for i, st in sd["state"].items()}
        optimizers.append(sd)

    def cpu(tree):
        if isinstance(tree, torch.Tensor):
            return tree.detach().to("cpu", copy=True)
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(cpu(v) for v in tree)
        return tree

    return cpu({
        "model": model,
        "optimizers": optimizers,
        "schedulers": [s.state_dict() for s in state.schedulers],
        "step": int(state.step),
    })


def _write(file: str, snapshot: Dict[str, Any]) -> None:
    """Write through a temporary name, so a file under its own name is whole."""
    tmp = file + ".tmp"
    torch.save(snapshot, tmp)
    os.replace(tmp, file)


def _read(file: str) -> Dict[str, Any]:
    # MultiStepLR's state holds its milestones as a Counter
    with torch.serialization.safe_globals([collections.Counter]):
        return torch.load(file, map_location="cpu", weights_only=True)


def _local_model(state: Any, donor: Dict[str, Any]) -> Dict[str, Any]:
    """Each tensor of a whole state dict as this rank's shard of it."""
    ours = state.model.state_dict()
    params = dict(state.model.named_parameters())
    return {k: _shard_of(v, ours[k], params.get(k)) if k in ours else v
            for k, v in donor.items()}


def _load_into(state: Any, raw: Dict[str, Any]) -> Any:
    state.model.load_state_dict(_local_model(state, raw["model"]), strict=True)
    for opt, sd in zip(state.optimizers, raw["optimizers"], strict=True):
        ps = _opt_params(opt)
        ours = opt.state_dict()["state"]
        sd = dict(sd, state={i: {k: _shard_of(v, ours.get(i, {}).get(k), ps[i])
                                 for k, v in st.items()}
                             for i, st in sd["state"].items()})
        opt.load_state_dict(sd)
    for sched, sd in zip(state.schedulers, raw["schedulers"], strict=True):
        sched.load_state_dict(sd)
    state.step = raw["step"]
    return state


def save_checkpoint(path: str, state: Any, config: Optional[Config] = None) -> None:
    """Save a `TrainState` (and the config) to the directory `path`."""
    path = os.path.abspath(path)
    snapshot = _snapshot(state)
    if _rank() == 0:
        os.makedirs(path, exist_ok=True)
        _write(os.path.join(path, _STATE), snapshot)
        if config is not None:
            _write_config(path, config)
    _barrier()


def restore_checkpoint(path: str, state: Any, strict: bool = True) -> Any:
    """Restore into `state` (same module tree) and return it.

    strict=False (the reference's `strict_loading`): module tensors missing
    from the checkpoint or of another shape keep the state's values, and
    the optimizers, schedulers and step are left as they are (Lightning's
    strict=False covers the module's state dict only)."""
    raw = _read(os.path.join(os.path.abspath(path), _STATE))
    if strict:
        return _load_into(state, raw)
    ours = state.model.state_dict()
    donor = _local_model(state, raw["model"])
    merged = {k: donor[k] if k in donor and donor[k].shape == v.shape else v
              for k, v in ours.items()}
    state.model.load_state_dict(merged, strict=True)
    return state


def restore_config(path: str) -> Config:
    """The Config stored with a checkpoint (by this package or the JAX one)."""
    with open(_config_path(os.path.abspath(path))) as f:
        return Config.from_dict(json.load(f))


def load_prediction_params_from(path: str, state: Any,
                                subtree: str = "prediction_network") -> Any:
    """Replace only the `subtree` module's tensors with another checkpoint's.
    The donor's other modules and its optimizers may differ arbitrarily;
    the subtree's names and shapes must match ours."""
    raw = _read(os.path.join(os.path.abspath(path), _STATE))
    prefix = subtree + "."
    donor = {k[len(prefix):]: v for k, v in raw["model"].items() if k.startswith(prefix)}
    module = state.model.get_submodule(subtree)
    ours = module.state_dict()
    donor_shapes = {k: tuple(v.shape) for k, v in donor.items()}
    our_shapes = {k: tuple(v.shape) for k, v in ours.items()}
    if donor_shapes != our_shapes:
        raise ValueError(
            f"prediction subtree '{subtree}' shape mismatch between donor "
            f"checkpoint and current state:\n{donor_shapes}\nvs\n{our_shapes}")
    module.load_state_dict(donor, strict=True)
    return state


class AsyncTrainCheckpointer:
    """Step-indexed checkpoints written in a background thread, the newest
    `max_to_keep` kept, and `restore_latest` to resume an interrupted run
    from the newest complete step. `save` copies the state to the CPU before
    it returns, so training may go on at once; `wait` blocks until the
    writes are done and raises what a write raised."""

    def __init__(self, path: str, max_to_keep: int = 3,
                 config: Optional[Config] = None):
        self.path = os.path.abspath(path)
        self.max_to_keep = max_to_keep
        self._steps_dir = os.path.join(self.path, "steps")
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: List[concurrent.futures.Future] = []
        if _rank() == 0:
            os.makedirs(self._steps_dir, exist_ok=True)
            if config is not None:
                _write_config(self.path, config)
        _barrier()

    def _steps(self) -> List[int]:
        """Complete steps, oldest first."""
        return sorted(int(d) for d in os.listdir(self._steps_dir)
                      if d.isdigit() and os.path.isfile(
                          os.path.join(self._steps_dir, d, _STATE)))

    def _save(self, step: int, snapshot: Dict[str, Any]) -> None:
        d = os.path.join(self._steps_dir, str(step))
        os.makedirs(d, exist_ok=True)
        _write(os.path.join(d, _STATE), snapshot)
        for old in self._steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self._steps_dir, str(old)))

    def save(self, step: int, state: Any) -> None:
        """Queue a save of `state` at `step` (returns after the CPU copy;
        rank 0 alone writes)."""
        snapshot = _snapshot(state)
        if _rank() == 0:
            self._pending.append(self._pool.submit(self._save, int(step), snapshot))

    def restore_latest(self, state: Any) -> Tuple[Any, Optional[int]]:
        """(state, step) from the newest complete checkpoint, or
        (state, None) if the directory holds none."""
        self.wait()
        _barrier()
        steps = self._steps()
        if not steps:
            return state, None
        latest = steps[-1]
        raw = _read(os.path.join(self._steps_dir, str(latest), _STATE))
        return _load_into(state, raw), latest

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)


class best_metric_saver:
    """Keep-best checkpointing on a monitored metric
    (ModelCheckpoint(monitor=..., mode="max" | "min"))."""

    def __init__(self, path: str, mode: str = "max"):
        self.path = path
        self.mode = mode
        self.best: Optional[float] = None

    def maybe_save(self, metric: float, state: Any,
                   config: Optional[Config] = None) -> bool:
        better = (
            self.best is None
            or (self.mode == "max" and metric > self.best)
            or (self.mode == "min" and metric < self.best)
        )
        if better:
            self.best = float(metric)
            save_checkpoint(self.path, state, config)
        return better
