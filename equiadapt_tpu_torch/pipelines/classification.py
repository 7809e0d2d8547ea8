"""Image-classification pipeline, eval half.

Counterpart of `equiadapt_tpu/pipelines/classification.py`:

* `ImageClassifierPipeline`: canonicalize -> predict, returning
  `(logits, info)`;
* `classification_loss`: the task cross-entropy plus the prior and the
  optimization-specific (group-contrast) terms with their weights, and the
  metrics;
* `make_eval_step`, `vanilla_inference` and `group_inference`, the
  test-time evaluators. `group_inference` sweeps every group element as one
  batched orbit (`ops.kernels.orbit.materialize_orbit`: kernel K4 for
  quarter turns) through one call of the model.

The JAX functions take a `TrainState`; these take the pipeline module, which
holds its own weights, and run it under `torch.no_grad()`. Call `.eval()`
on it first (training is not ported). Not ported yet, with the training
slice (ROADMAP.md item 9): `TrainState`, `make_optimizer`,
`create_train_state`, `make_train_step` and the pipeline's `remat`.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from equiadapt_tpu_torch.common.info import (
    IdentityCanonicalizationInfo,
    identity_metric,
    prior_regularization_loss,
)
from equiadapt_tpu_torch.images.canonicalization.discrete_group import (
    optimization_specific_loss,
)
from equiadapt_tpu_torch.ops.kernels.orbit import materialize_orbit

Tensor = torch.Tensor

__all__ = ["ImageClassifierPipeline", "classification_loss", "make_eval_step",
           "vanilla_inference", "group_inference"]


class ImageClassifierPipeline(nn.Module):
    """canonicalize -> predict: NHWC images -> (logits, info)."""

    def __init__(self, canonicalizer: nn.Module, prediction_network: nn.Module,
                 remat: bool = False):
        super().__init__()
        if remat:
            raise NotImplementedError(
                "remat (activation rematerialization) is for training, which "
                "is not ported yet (ROADMAP.md item 9)")
        self.canonicalizer = canonicalizer
        self.prediction_network = prediction_network

    def forward(self, x: Tensor, training: bool = False):
        x_canon, info = self.canonicalizer(x, training=training)
        return self.prediction_network(x_canon), info

    def invert(self, info, y: Tensor, **kw: Any) -> Tensor:
        return self.canonicalizer.invert_canonicalization(info, y, **kw)

    def canonicalize(self, x: Tensor, training: bool = False):
        """(x_canon, info) without the prediction pass."""
        return self.canonicalizer(x, training=training)


def classification_loss(
    logits: Tensor,
    labels: Tensor,
    info,
    *,
    task_weight: float = 1.0,
    prior_weight: float = 100.0,
    group_contrast_weight: float = 0.0,
    canonicalization_type: str = "group_equivariant",
    out_vector_size: int = 128,
    artifact_err_wt: float = 0.0,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Weighted sum of the task cross-entropy, the prior loss and the
    optimization-specific loss; (loss, metrics)."""
    task = F.cross_entropy(logits, labels.long())
    loss = task_weight * task
    metrics = {"loss/task": task}
    if not isinstance(info, IdentityCanonicalizationInfo):
        if prior_weight:
            prior = prior_regularization_loss(info)
            loss = loss + prior_weight * prior
            metrics["loss/prior"] = prior
            metrics["metric/identity"] = identity_metric(info)
        if group_contrast_weight and canonicalization_type == "opt_group_equivariant":
            opt = optimization_specific_loss(
                info, out_vector_size=out_vector_size,
                artifact_err_wt=artifact_err_wt)
            loss = loss + group_contrast_weight * opt
            metrics["loss/group_contrast"] = opt
        if group_contrast_weight and canonicalization_type == "opt_steerable":
            raise NotImplementedError(
                "steerable_optimization_loss (the optimized steerable "
                "canonicalizer) is not ported yet (ROADMAP.md item 11)")
    metrics["metric/acc"] = torch.mean(
        (torch.argmax(logits, -1) == labels).float())
    metrics["loss/total"] = loss
    # NaN guard of the reference's `assert not torch.isnan(loss)`
    metrics["loss/finite"] = torch.isfinite(loss).float()
    return loss, metrics


def make_eval_step(loss_kwargs: Dict[str, Any]):
    """eval_step(model, batch) -> the metrics of `classification_loss`."""

    def eval_step(model: nn.Module, batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
        with torch.no_grad():
            logits, info = model(batch["image"], training=False)
            _, metrics = classification_loss(logits, batch["label"], info,
                                             **loss_kwargs)
        return metrics

    return eval_step


def vanilla_inference(model: nn.Module, batch: Dict[str, Tensor],
                      num_classes: int) -> Dict[str, Tensor]:
    """Accuracy and per-class accuracy."""
    with torch.no_grad():
        logits, _ = model(batch["image"], training=False)
    pred = torch.argmax(logits, -1)
    labels = batch["label"].to(pred.device)
    hit = (pred == labels).float()
    onehot = F.one_hot(labels.long(), num_classes).float()
    per_class = torch.sum(onehot * hit[:, None], 0) / torch.clamp(
        torch.sum(onehot, 0), min=1.0)
    return {"test/acc": torch.mean(hit), "test/per_class_acc": per_class}


def group_inference(model: nn.Module, batch: Dict[str, Tensor], *,
                    num_rotations: int = 4, group_type: str = "rotation",
                    grayscale: bool = False) -> Dict[str, Tensor]:
    """Per-group-element robustness sweep: every element g applies
    rotate(x, +theta_g) (then the hflip for the reflection coset) to the
    batch, all |G| copies go through the model in one call, and the
    accuracy of each element and their mean are reported."""
    x, labels = batch["image"], batch["label"]
    B = x.shape[0]
    mode = "zeros" if grayscale else "border"
    orbit = materialize_orbit(x, num_rotations, group_type=group_type,
                              padding_mode=mode, sign=1.0)
    G = orbit.shape[0] // B
    with torch.no_grad():
        logits, _ = model(orbit, training=False)
    pred = torch.argmax(logits, -1).reshape(G, B)
    accs = torch.mean((pred == labels.to(pred.device)[None]).float(), dim=1)
    out = {f"test/acc_element_{g}": accs[g] for g in range(G)}
    out["test/group_acc"] = torch.mean(accs)
    out["test/acc"] = accs[0]
    return out
