"""N-body training pipeline: canonicalize -> predict -> invert -> MSE.

Counterpart of `equiadapt_tpu/pipelines/nbody.py`, with the evaluation
MSE of the JAX package's n-body CLI (`nbody_eval_mse`). The train state is
the port's `TrainState` with one AdamW over every parameter (optax's
`adamw(lr, weight_decay=wd)`, as the JAX CLI builds it); the step updates
it in place.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from equiadapt_tpu_torch.pipelines.classification import TrainState

Tensor = torch.Tensor

__all__ = ["NBodyPipeline", "create_nbody_state", "make_nbody_train_step",
           "nbody_eval_mse"]


class NBodyPipeline(nn.Module):
    """Canonicalize (loc, vel) -> predict canonical future positions ->
    map them back to the input frame."""

    def __init__(self, canonicalizer: nn.Module, prediction_network: nn.Module):
        super().__init__()
        self.canonicalizer = canonicalizer
        self.prediction_network = prediction_network

    def forward(self, loc: Tensor, vel: Tensor, charges: Tensor,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        # the reference's node scalars: unused by the canonicalizer, and kept
        # out of the graph (the norm's gradient at 0 is NaN)
        nodes = torch.linalg.vector_norm(vel.detach(), dim=-1, keepdim=True)
        kw = dict(training=training, generator=generator)
        (c_loc, c_vel), info = self.canonicalizer(
            nodes, loc=loc, vel=vel, charges=charges, **kw)
        pred = self.prediction_network(c_loc, c_vel, charges, **kw)
        return self.canonicalizer.invert_canonicalization(info, pred)


def create_nbody_state(pipeline: NBodyPipeline, learning_rate: float = 1e-3,
                       weight_decay: float = 1e-4) -> TrainState:
    """A `TrainState` at step 0 with one AdamW over every parameter."""
    opt = torch.optim.AdamW(pipeline.parameters(), lr=learning_rate,
                            weight_decay=weight_decay)
    return TrainState(model=pipeline, optimizers=[opt])


def make_nbody_train_step():
    """train_step(state, batch, generator=None) -> (state, metrics): the MSE
    of the predicted against the true future positions, its backward and
    one optimizer step; dropout masks come from `generator`."""

    def train_step(state: TrainState, batch: Dict[str, Tensor],
                   generator: Optional[torch.Generator] = None):
        for opt in state.optimizers:
            opt.zero_grad(set_to_none=True)
        pred = state.model(batch["loc"], batch["vel"], batch["charges"],
                           training=True, generator=generator)
        loss = torch.mean((pred - batch["loc_end"]) ** 2)
        loss.backward()
        state.apply_gradients()
        loss = loss.detach()
        return state, {"loss/task": loss,
                       "loss/finite": torch.isfinite(loss).float()}

    return train_step


def nbody_eval_mse(model: nn.Module, batch: Dict[str, Tensor]) -> Tensor:
    """MSE of the eval-mode prediction against `loc_end`."""
    with torch.no_grad():
        pred = model(batch["loc"], batch["vel"], batch["charges"], training=False)
        return torch.mean((pred - batch["loc_end"]) ** 2)
