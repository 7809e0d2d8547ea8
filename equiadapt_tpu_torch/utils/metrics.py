"""Metric aggregation and JSONL logging, early stopping, the NaN guard,
canonized-image grids and gradient statistics.

Counterpart of `equiadapt_tpu/utils/metrics.py`, with the same keys and
results. Values may be torch tensors on any device, numpy arrays or Python
numbers; they are read on the host.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = ["MetricLogger", "EarlyStopping", "assert_finite_loss",
           "save_canonized_images", "gradient_watch"]


def _host(v: Any) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


class MetricLogger:
    def __init__(self, log_path: Optional[str] = None, use_wandb: bool = False):
        """JSONL-first logger; `use_wandb=True` mirrors flushes to a wandb
        run if the package is importable and a run is active."""
        self.log_path = log_path
        self._sums: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                if wandb.run is not None:
                    self._wandb = wandb
            except ImportError:
                pass
        if log_path:
            os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)

    def update(self, metrics: Dict[str, Any]) -> None:
        """Accumulate the scalar metrics (others are skipped)."""
        for k, v in metrics.items():
            arr = _host(v)
            if arr.ndim == 0:
                self._sums[k] += float(arr)
                self._counts[k] += 1

    def flush(self, step: int, prefix: str = "") -> Dict[str, float]:
        """The means since the last flush; appends them as a JSONL row."""
        means = {
            (prefix + k): self._sums[k] / max(self._counts[k], 1) for k in self._sums
        }
        self._sums.clear()
        self._counts.clear()
        if self.log_path:
            with open(self.log_path, "a") as f:
                f.write(json.dumps({"step": step, "time": time.time(), **means}) + "\n")
        if self._wandb is not None:
            self._wandb.log(means, step=step)
        return means


class EarlyStopping:
    """Stop when the monitored metric hasn't improved for `patience` checks."""

    def __init__(self, patience: int = 10, mode: str = "max", min_delta: float = 0.0):
        self.patience = patience
        self.mode = mode
        self.min_delta = min_delta
        self.best: Optional[float] = None
        self.bad = 0

    def update(self, value: float) -> bool:
        """Returns True if training should stop."""
        improved = (
            self.best is None
            or (self.mode == "max" and value > self.best + self.min_delta)
            or (self.mode == "min" and value < self.best - self.min_delta)
        )
        if improved:
            self.best = float(value)
            self.bad = 0
        else:
            self.bad += 1
        return self.bad >= self.patience


def assert_finite_loss(metrics) -> None:
    """Raise FloatingPointError unless every `loss/finite` flag is set (the
    reference's `assert not torch.isnan(loss)`)."""
    flag = metrics.get("loss/finite")
    if flag is None:
        return
    if not bool(np.all(_host(flag) > 0.5)):
        raise FloatingPointError(f"Loss is NaN/Inf: {metrics}")


def save_canonized_images(path: str, originals, canonized, max_images: int = 8) -> str:
    """Write an (original | canonicalized) side-by-side PNG grid of NHWC
    float images (grayscale or RGB), each panel min-max normalized."""
    from PIL import Image

    def norm(a):
        a = _host(a).astype(np.float32)
        lo, hi = a.min(), a.max()
        a = (a - lo) / (hi - lo + 1e-8)
        return (a * 255).astype(np.uint8)

    n = min(max_images, np.shape(originals)[0])
    rows = []
    for i in range(n):
        o, c = norm(originals[i]), norm(canonized[i])
        if o.shape[-1] == 1:
            o, c = o[..., 0], c[..., 0]
        rows.append(np.concatenate([o, np.full_like(o[:, :2], 255), c], axis=1))
    grid = np.concatenate(rows, axis=0)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(grid).save(path)
    return path


def _named_leaves(grads, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    for key in sorted(grads):  # the order of JAX's tree flattening
        value = grads[key]
        if isinstance(value, Mapping):
            yield from _named_leaves(value, prefix + (str(key),))
        else:
            yield "/".join(prefix + (str(key),)), value


def gradient_watch(grads, max_bins: int = 16) -> Dict[str, Any]:
    """Per-tensor gradient statistics (the `wandb.watch(model, log="all")`
    analog): `grad/<path>/{norm,absmax,log10_hist}` and `grad/global_norm`.

    `grads` is a nested mapping of tensors or arrays, such as
    `{name: p.grad for name, p in model.named_parameters()}`; paths join
    the keys with "/", walked in sorted order as JAX flattens a dict. The
    histogram counts log10 |g| of the nonzero elements in `max_bins` fixed
    bins over [-12, 4)."""
    out: Dict[str, Any] = {}
    sq_total = 0.0
    for name, leaf in _named_leaves(grads):
        a = np.abs(_host(leaf).astype(np.float32))
        if a.size == 0:
            continue
        n = float(np.sqrt((a.astype(np.float64) ** 2).sum()))
        sq_total += n * n
        out[f"grad/{name}/norm"] = n
        out[f"grad/{name}/absmax"] = float(a.max())
        lg = np.log10(np.clip(a[a > 0], 1e-12, 1e4 - 1e-9)) if (a > 0).any() else np.array([])
        hist, _ = np.histogram(lg, bins=max_bins, range=(-12.0, 4.0))
        out[f"grad/{name}/log10_hist"] = hist.tolist()
    out["grad/global_norm"] = float(np.sqrt(sq_total))
    return out
