"""Point-cloud classification and part-segmentation pipelines.

Counterpart of `equiadapt_tpu/pipelines/pointcloud.py`: the augmentations
(`random_rotate`, the test-time and training z / SO(3) rotations;
`random_point_dropout`; `random_scale_shift`), the pipelines
(canonicalize -> classify, canonicalize -> per-point part logits),
`classification_metrics`, and the training half: `create_pointcloud_state`
(the port's `TrainState` with AdamW, `make_optimizer`) and
`make_pointcloud_train_step` (augment -> canonicalize -> classify -> cross
entropy + prior).

Each random function draws from a `torch.Generator` on the points'
device, or takes its draws handed in (`draws`), so a test can give both
packages the same numbers. The train step draws, in order, the rotation,
the point dropout, the scale and shift, then the dropout masks of the
forward pass from the step's generator.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from equiadapt_tpu_torch.common.info import (
    IdentityCanonicalizationInfo,
    prior_regularization_loss,
)
from equiadapt_tpu_torch.common.lie import son_rep
from equiadapt_tpu_torch.pipelines.classification import (
    TrainState,
    create_train_state,
    make_optimizer,
)

Tensor = torch.Tensor

__all__ = ["random_rotate", "random_point_dropout", "random_scale_shift",
           "PointcloudClassificationPipeline", "PointcloudPartSegPipeline",
           "classification_metrics", "pointcloud_loss", "create_pointcloud_state",
           "make_pointcloud_train_step"]


def _uniform(shape, generator, points: Tensor) -> Tensor:
    return torch.rand(shape, generator=generator, device=points.device)


def random_rotate(points: Tensor, mode: str,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[Tensor] = None) -> Tensor:
    """Rotate each cloud (B, N, 3) by a random z-axis ("z") or SO(3)
    ("so3") rotation, points @ R; any other mode returns the points.

    `draws`: (B,) uniforms in [0, 1) for "z", (B, 3) standard normals for
    "so3"; drawn from `generator` on the points' device when not given."""
    if mode not in ("z", "so3"):
        return points
    B = points.shape[0]
    if draws is None:
        draw = torch.rand if mode == "z" else torch.randn
        shape = (B,) if mode == "z" else (B, 3)
        draws = draw(shape, generator=generator, device=points.device)
    draws = draws.to(points.device, points.dtype)
    if mode == "z":
        theta = draws * 2 * math.pi
        c, s = torch.cos(theta), torch.sin(theta)
        zero, one = torch.zeros_like(c), torch.ones_like(c)
        R = torch.stack([c, -s, zero, s, c, zero, zero, zero, one],
                        dim=-1).reshape(B, 3, 3)
    else:
        R = son_rep(draws * math.pi, 3)
    return torch.einsum("bnd,bdw->bnw", points, R)


def random_point_dropout(points: Tensor, max_dropout_ratio: float = 0.875,
                         generator: Optional[torch.Generator] = None,
                         draws: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
    """Replace each cloud's dropped points by its first point (the shape
    stays (B, N, 3)): cloud b drops point n where u[b, n] <= r[b] *
    max_dropout_ratio.

    `draws`: (r (B, 1), u (B, N)), uniforms in [0, 1); drawn from
    `generator` when not given."""
    B, N, _ = points.shape
    if draws is None:
        draws = (_uniform((B, 1), generator, points),
                 _uniform((B, N), generator, points))
    r, u = (d.to(points.device) for d in draws)
    drop = u <= r * max_dropout_ratio
    return torch.where(drop[..., None], points[:, :1, :], points)


def random_scale_shift(points: Tensor, scale_low: float = 0.8,
                       scale_high: float = 1.25, shift_range: float = 0.1,
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
    """Anisotropic scale in [scale_low, scale_high) and a shift in
    [-shift_range, shift_range) per cloud and axis: points * scale + shift.

    `draws`: (u_scale (B, 1, 3), u_shift (B, 1, 3)), uniforms in [0, 1);
    drawn from `generator` when not given."""
    B = points.shape[0]
    if draws is None:
        draws = (_uniform((B, 1, 3), generator, points),
                 _uniform((B, 1, 3), generator, points))
    u_scale, u_shift = (d.to(points.device, points.dtype) for d in draws)
    scale = u_scale * (scale_high - scale_low) + scale_low
    shift = u_shift * (2 * shift_range) - shift_range
    return points * scale + shift


class PointcloudClassificationPipeline(nn.Module):
    """canonicalize -> classify: (B, N, 3) -> (logits, info)."""

    def __init__(self, canonicalizer: nn.Module, prediction_network: nn.Module):
        super().__init__()
        self.canonicalizer = canonicalizer
        self.prediction_network = prediction_network

    def forward(self, points: Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None):
        kw = dict(training=training, generator=generator)
        points_c, info = self.canonicalizer(points, **kw)
        return self.prediction_network(points_c, **kw), info


class PointcloudPartSegPipeline(nn.Module):
    """canonicalize -> per-point part logits conditioned on the object
    category: (B, N, 3) points and (B, num_categories) one-hots ->
    ((B, N, num_parts) logits, info)."""

    def __init__(self, canonicalizer: nn.Module, prediction_network: nn.Module):
        super().__init__()
        self.canonicalizer = canonicalizer
        self.prediction_network = prediction_network

    def forward(self, points: Tensor, category_onehot: Tensor,
                training: bool = False,
                generator: Optional[torch.Generator] = None):
        kw = dict(training=training, generator=generator)
        points_c, info = self.canonicalizer(points, **kw)
        return self.prediction_network(points_c, category_onehot, **kw), info


def classification_metrics(logits: Tensor, labels: Tensor,
                           num_classes: int) -> Dict[str, Tensor]:
    """Accuracy, and accuracy balanced over the classes present."""
    hit = (torch.argmax(logits, dim=-1) == labels).float()
    onehot = F.one_hot(labels.long(), num_classes).float()
    per_class = torch.sum(onehot * hit[:, None], 0) / torch.clamp(
        torch.sum(onehot, 0), min=1.0)
    present = (torch.sum(onehot, 0) > 0).float()
    balanced = torch.sum(per_class * present) / torch.clamp(torch.sum(present), min=1.0)
    return {"metric/acc": torch.mean(hit), "metric/balanced_acc": balanced}


def pointcloud_loss(logits: Tensor, labels: Tensor, info, *, num_classes: int,
                    prior_weight: float = 1.0, label_smoothing: float = 0.0,
                    ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The classification step's loss: cross entropy (against labels
    smoothed by `label_smoothing`) plus `prior_weight` times the prior
    loss (none for the identity canonicalizer); (loss, metrics)."""
    task = F.cross_entropy(logits, labels.long(), label_smoothing=label_smoothing)
    loss = task
    metrics = {"loss/task": task}
    if prior_weight and not isinstance(info, IdentityCanonicalizationInfo):
        prior = prior_regularization_loss(info)
        loss = loss + prior_weight * prior
        metrics["loss/prior"] = prior
    metrics.update(classification_metrics(logits, labels, num_classes))
    metrics["loss/total"] = loss
    metrics["loss/finite"] = torch.isfinite(loss).float()
    return loss, metrics


def create_pointcloud_state(pipeline: nn.Module,
                            learning_rate: float = 1e-3) -> TrainState:
    """A `TrainState` at step 0: AdamW at `learning_rate` with weight decay
    1e-4 over every parameter (optax's `adamw(lr)`, as the JAX CLIs build
    it), through `make_optimizer`."""
    return create_train_state(pipeline, make_optimizer(
        pipeline, architecture="pointcloud", learning_rate=learning_rate,
        canonicalization_learning_rate=learning_rate))


def make_pointcloud_train_step(*, num_classes: int, prior_weight: float = 1.0,
                               label_smoothing: float = 0.0,
                               train_rotation: str = "z", augment: bool = True):
    """train_step(state, batch, generator=None) -> (state, metrics): the
    batch's points rotated (`train_rotation`), then with `augment` point
    dropout and scale and shift; the forward in training mode (BatchNorm
    statistics updated, dropout masks from `generator`); `pointcloud_loss`;
    the backward pass and one optimizer step. The state is updated in
    place and returned."""

    def train_step(state: TrainState, batch: Dict[str, Tensor],
                   generator: Optional[torch.Generator] = None):
        model = state.model
        for opt in state.optimizers:
            opt.zero_grad(set_to_none=True)
        pts = random_rotate(batch["points"], train_rotation, generator)
        if augment:
            pts = random_point_dropout(pts, generator=generator)
            pts = random_scale_shift(pts, generator=generator)
        logits, info = model(pts, training=True, generator=generator)
        loss, metrics = pointcloud_loss(
            logits, batch["label"], info, num_classes=num_classes,
            prior_weight=prior_weight, label_smoothing=label_smoothing)
        loss.backward()
        state.apply_gradients()
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step
