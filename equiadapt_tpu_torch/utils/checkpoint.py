"""Checkpoints of a train state, with the config beside them.

Counterpart of `equiadapt_tpu/utils/checkpoint.py`, on torch files instead
of Orbax. A checkpoint directory holds `state.pt` (the module's state dict,
each optimizer's and scheduler's state dict, and the step) and, when a
config is given, `config.json` in the JAX package's format, so
`restore_config` reads a config saved by either package. Tensors are loaded
onto the CPU and copied into the state's own tensors, so a state restores
on the device it lives on.
"""

from __future__ import annotations

import collections
import concurrent.futures
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

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


def _snapshot(state: Any) -> Dict[str, Any]:
    """The state as a dict of CPU copies (training may go on changing the
    state's tensors in place while the snapshot is written)."""
    def cpu(tree):
        if isinstance(tree, torch.Tensor):
            return tree.detach().to("cpu", copy=True)
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(cpu(v) for v in tree)
        return tree

    return cpu({
        "model": state.model.state_dict(),
        "optimizers": [opt.state_dict() for opt in state.optimizers],
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


def _load_into(state: Any, raw: Dict[str, Any]) -> Any:
    state.model.load_state_dict(raw["model"], strict=True)
    for opt, sd in zip(state.optimizers, raw["optimizers"], strict=True):
        opt.load_state_dict(sd)
    for sched, sd in zip(state.schedulers, raw["schedulers"], strict=True):
        sched.load_state_dict(sd)
    state.step = raw["step"]
    return state


def save_checkpoint(path: str, state: Any, config: Optional[Config] = None) -> None:
    """Save a `TrainState` (and the config) to the directory `path`."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    _write(os.path.join(path, _STATE), _snapshot(state))
    if config is not None:
        _write_config(path, config)


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
    donor = raw["model"]
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
        os.makedirs(self._steps_dir, exist_ok=True)
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: List[concurrent.futures.Future] = []
        if config is not None:
            _write_config(self.path, config)

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
        """Queue a save of `state` at `step` (returns after the CPU copy)."""
        self._pending.append(self._pool.submit(self._save, int(step), _snapshot(state)))

    def restore_latest(self, state: Any) -> Tuple[Any, Optional[int]]:
        """(state, step) from the newest complete checkpoint, or
        (state, None) if the directory holds none."""
        self.wait()
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
