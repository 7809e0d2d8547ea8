"""The program under test, reached through its normal entry points only.

The pipeline is built as the port's classification CLIs build it
(`cli.classification_serve.build_serving_pipeline` for serving,
`cli.classification_train.build_pipeline` for training) from the
configuration's full settings; no example YAML is read. Training takes
`pipelines.classification.make_train_step` with AdamW on each of the two
parameter groups. Spans are taken from here, around the calls into each
layer, with CUDA events recorded by forward hooks; nothing inside the
program is changed.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

Tensor = torch.Tensor


def _config(settings: dict):
    from equiadapt_tpu_torch.utils.config import Config

    return Config.from_dict(settings)


def build_pipeline(settings: dict, mode: str, device):
    """The pipeline of `settings`: the serving build (fast warps, bf16)
    for mode "serve", the training build otherwise."""
    cfg = _config(settings)
    if mode == "serve":
        from equiadapt_tpu_torch.cli.classification_serve import build_serving_pipeline

        return build_serving_pipeline(cfg, device)
    from equiadapt_tpu_torch.cli.classification_train import build_pipeline as build

    return build(cfg, device)


def train_state(pipe, optimizer: dict):
    """A train state of `pipe` with AdamW on the canonicalizer's parameters
    and AdamW on the prediction network's, as the configuration states."""
    from equiadapt_tpu_torch.pipelines.classification import create_train_state

    if optimizer["name"] != "adamw":
        raise ValueError(f"optimizer {optimizer['name']!r} is not AdamW")
    canon, pred = [], []
    for name, p in pipe.named_parameters():
        if p.requires_grad:
            (canon if name.startswith("canonicalizer.") else pred).append(p)
    opts = [torch.optim.AdamW(g, lr=optimizer["lr"], weight_decay=optimizer["weight_decay"])
            for g in (pred, canon) if g]
    return create_train_state(pipe, (opts, []))


def train_step(settings: dict):
    from equiadapt_tpu_torch.pipelines.classification import make_train_step

    lw = settings["experiment"]["loss"]
    return make_train_step({
        "task_weight": lw["task_weight"], "prior_weight": lw["prior_weight"],
        "group_contrast_weight": lw["group_contrast_weight"],
        "canonicalization_type": settings["canonicalization"]["canonicalization_type"],
    })


def element(info) -> Tensor:
    """The selected element of a canonicalization info: the angle in
    degrees (discrete groups) or the rotation matrix (continuous)."""
    el = info.element
    return el.rotation_deg if hasattr(el, "rotation_deg") else el.rotation


def energies(info) -> Optional[Tensor]:
    """The (B, |G|) energies of a discrete canonicalization info, or None."""
    return getattr(info, "group_activations", None)


class Spans:
    """Per-call durations of modules, from forward pre- and post-hooks.

    On the card each call records a pair of CUDA events, read once the
    window has closed; on the CPU (the benchmark's own tests) the host
    clock stands in."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.events: Dict[str, List[list]] = {}
        self.handles = []

    def _now(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def begin(self, name: str) -> None:
        self.events.setdefault(name, []).append([self._now(), None])

    def end(self, name: str) -> None:
        self.events[name][-1][1] = self._now()

    def watch(self, name: str, module: torch.nn.Module) -> None:
        self.handles.append(module.register_forward_pre_hook(
            lambda *_: self.begin(name)))
        self.handles.append(module.register_forward_hook(
            lambda *_: self.end(name)))

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []

    def durations_ms(self) -> Dict[str, List[float]]:
        """Every closed span in milliseconds, by name (synchronizes)."""
        if self.cuda:
            torch.cuda.synchronize()
        out = {}
        for name, pairs in self.events.items():
            out[name] = [(a.elapsed_time(b) if self.cuda else (b - a) * 1e3)
                         for a, b in pairs if b is not None]
        return out


def watch_pipeline(spans: Spans, pipe, training: bool) -> None:
    spans.watch("canonicalizer", pipe.canonicalizer)
    spans.watch("canonicalization_network", pipe.canonicalizer.canonicalization_network)
    spans.watch("prediction_network", pipe.prediction_network)
    if training:
        spans.watch("pipeline", pipe)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
