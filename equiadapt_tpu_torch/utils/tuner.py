"""Auto-tuning: the learning-rate range finder (`experiment.run_mode=auto_tune`).

Counterpart of `equiadapt_tpu/utils/tuner.py`: the learning rate ramps
exponentially from `min_lr` to `max_lr` over a short run (a scheduler on
the optimizer, stepped once per train step, with the values of
`optax.exponential_decay`), the loss of every step is recorded, and the
suggestion is the learning rate at the steepest descent of the smoothed
curve (Lightning's heuristic).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch
from torch import nn

from equiadapt_tpu_torch.pipelines.classification import create_train_state

__all__ = ["lr_find", "LRFindResult"]


class LRFindResult:
    """Loss-vs-LR curve and the suggestion (Lightning's LRFinder shape)."""

    def __init__(self, lrs: np.ndarray, losses: np.ndarray, suggestion: float):
        self.lrs = lrs
        self.losses = losses
        self.suggestion = suggestion

    def __repr__(self) -> str:
        return f"LRFindResult(suggestion={self.suggestion:.3e}, steps={len(self.lrs)})"


def _suggest(lrs: np.ndarray, losses: np.ndarray, smooth: float = 0.7) -> float:
    """Steepest-descent point of the EMA-smoothed loss curve, excluding the
    divergence tail (loss > 4x running min), matching Lightning's heuristic."""
    ema = np.zeros_like(losses)
    run = 0.0
    for i, v in enumerate(losses):
        run = smooth * run + (1 - smooth) * v
        ema[i] = run / (1 - smooth ** (i + 1))  # bias-corrected from zero init
    run_min = np.minimum.accumulate(ema)
    valid = ema <= 4.0 * run_min + 1e-12
    last = int(np.argmin(valid)) if (~valid).any() else len(ema)
    ema, lrs_v = ema[: max(last, 3)], lrs[: max(last, 3)]
    grads = np.gradient(ema, np.log(lrs_v))
    return float(lrs_v[int(np.argmin(grads))])


def _ramp(min_lr: float, max_lr: float, num_steps: int) -> Callable[[int], float]:
    """step -> min_lr * rate^step, rate = (max_lr / min_lr)^(1 / (num_steps - 1))."""
    rate = (max_lr / min_lr) ** (1.0 / max(num_steps - 1, 1))
    return lambda step: min_lr * rate ** step


def lr_find(
    model: nn.Module,
    make_step: Callable[[Any], Callable],
    batches: Iterator[Dict[str, Any]],
    generator: Optional[torch.Generator] = None,
    min_lr: float = 1e-6,
    max_lr: float = 1.0,
    num_steps: int = 60,
) -> LRFindResult:
    """Exponential learning-rate range test.

    Trains `model` in place (pass a fresh one) for up to `num_steps` steps
    with AdamW (optax's default decay, 1e-4) over its trainable parameters,
    its learning rate on the ramp; `make_step(state)` gives the
    train step `step(state, batch, generator) -> (state, metrics)`, and
    `batches` yields the batches. Stops at the first non-finite loss.

    Returns the (lr, loss) curve of the finite steps and the suggestion.
    """
    ramp = _ramp(min_lr, max_lr, num_steps)
    params = [p for p in model.parameters() if p.requires_grad]
    opt = torch.optim.AdamW(params, lr=min_lr, weight_decay=1e-4)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda i: ramp(i) / min_lr)
    state = create_train_state(model, ([opt], [sched]))
    step_fn = make_step(state)
    lrs, losses = [], []
    for i in range(num_steps):
        batch = next(batches)
        state, metrics = step_fn(state, batch, generator)
        loss = float(metrics["loss/total"] if "loss/total" in metrics
                     else metrics["loss/task"])
        lrs.append(ramp(i))
        losses.append(loss)
        if not np.isfinite(loss):
            break
    lrs_a, losses_a = np.asarray(lrs), np.asarray(losses)
    finite = np.isfinite(losses_a)
    return LRFindResult(
        lrs_a[finite], losses_a[finite], _suggest(lrs_a[finite], losses_a[finite])
    )
