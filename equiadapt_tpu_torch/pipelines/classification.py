"""Image-classification pipeline: training and evaluation.

Counterpart of `equiadapt_tpu/pipelines/classification.py`:

* `ImageClassifierPipeline`: canonicalize -> predict, returning
  `(logits, info)`; `training` and the `generator` of the random draws are
  arguments, and `remat=True` recomputes the prediction network's
  activations on the backward pass (`torch.utils.checkpoint`). The batch
  is first put in the memory the prediction network runs fastest on
  (`to_network_layout`), so the canonicalizer works in that memory and
  hands its canonical image over with no conversion;
* `classification_loss`: the task cross-entropy plus the prior and the
  optimization-specific (group-contrast) terms with their weights, and the
  metrics;
* the training half: `TrainState` (the pipeline module, its optimizers
  and schedulers, the step count), `make_optimizer` (the per-architecture
  policy), `create_train_state` and `make_train_step`;
* `make_eval_step`, `vanilla_inference` and `group_inference`, the
  test-time evaluators. `group_inference` sweeps every group element as one
  batched orbit (`ops.kernels.orbit.materialize_orbit`: kernel K4 for
  quarter turns) through one call of the model.

The JAX evaluators take a `TrainState`; these take the pipeline module,
which holds its own weights, and run it under `torch.no_grad()`.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from equiadapt_tpu_torch.common.layers import frozen_batch_stats
from equiadapt_tpu_torch.common.info import (
    IdentityCanonicalizationInfo,
    identity_metric,
    prior_regularization_loss,
)
from equiadapt_tpu_torch.images.canonicalization.continuous_group import (
    steerable_optimization_loss,
)
from equiadapt_tpu_torch.images.canonicalization.discrete_group import (
    optimization_specific_loss,
)
from equiadapt_tpu_torch.ops.kernels.orbit import materialize_orbit
from equiadapt_tpu_torch.utils.profiling import annotate

Tensor = torch.Tensor

__all__ = ["ImageClassifierPipeline", "to_network_layout", "TrainState",
           "classification_loss",
           "make_optimizer", "create_train_state", "make_train_step",
           "make_eval_step", "vanilla_inference", "group_inference", "orbit_logits"]


def to_network_layout(x: Tensor, network: nn.Module) -> Tensor:
    """The NHWC batch x in the memory `network.input_layout` names: an
    NHWC-contiguous batch becomes a (B, H, W, C) view of NCHW memory (one
    copy) for a network that runs fastest on NCHW (ResNet in fp32); x is
    returned as it is otherwise. The canonicalizer's select routes by that
    memory (`ops.kernels.select_warp.rotate_select`: K1 on NCHW, K3 on
    NHWC), and its canonical image keeps it."""
    if getattr(network, "input_layout", "nhwc") == "nchw" and x.is_contiguous():
        return x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    return x


class ImageClassifierPipeline(nn.Module):
    """canonicalize -> predict: NHWC images -> (logits, info).

    With `remat=True` the prediction network's activations are recomputed
    on the backward pass in training (`torch.utils.checkpoint`, not
    reentrant); the recomputation leaves the BatchNorm statistics alone,
    as Flax's `nn.remat` does."""

    def __init__(self, canonicalizer: nn.Module, prediction_network: nn.Module,
                 remat: bool = False):
        super().__init__()
        self.canonicalizer = canonicalizer
        self.prediction_network = prediction_network
        self.remat = remat

    def forward(self, x: Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None):
        with annotate("pipeline"):
            kw = {} if generator is None else {"generator": generator}
            x = to_network_layout(x, self.prediction_network)
            x_canon, info = self.canonicalizer(x, training=training, **kw)
            with annotate("predict"):
                if not training:
                    return self.prediction_network(x_canon), info
                net = self.prediction_network
                if not self.remat:
                    return net(x_canon, training=True), info
                logits = checkpoint(
                    lambda xc: net(xc, training=True), x_canon, use_reentrant=False,
                    context_fn=lambda: (contextlib.nullcontext(), frozen_batch_stats(net)))
                return logits, info

    def invert(self, info, y: Tensor, **kw: Any) -> Tensor:
        return self.canonicalizer.invert_canonicalization(info, y, **kw)

    def canonicalize(self, x: Tensor, training: bool = False):
        """(x_canon, info) without the prediction pass, in the network's
        memory layout."""
        x = to_network_layout(x, self.prediction_network)
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
            opt = steerable_optimization_loss(info)
            loss = loss + group_contrast_weight * opt
            metrics["loss/group_contrast"] = opt
    metrics["metric/acc"] = torch.mean(
        (torch.argmax(logits, -1) == labels).float())
    metrics["loss/total"] = loss
    # NaN guard of the reference's `assert not torch.isnan(loss)`
    metrics["loss/finite"] = torch.isfinite(loss).float()
    return loss, metrics


@dataclass
class TrainState:
    """The port's train state: the pipeline module (parameters and
    BatchNorm statistics), the optimizers of its parameter groups, the
    schedulers stepped once per train step, and the step count.
    `grad_sync(model)`, when set (by `parallel.data_parallel_jit` for its
    step), reduces the gradients over the ranks after the backward."""

    model: nn.Module
    optimizers: Sequence[torch.optim.Optimizer]
    schedulers: Sequence[Any] = ()
    step: int = 0
    grad_sync: Optional[Callable[[nn.Module], None]] = None
    _synced: bool = field(default=False, repr=False)

    def sync_gradients(self) -> None:
        """`grad_sync(model)` once between a backward and the optimizer
        step (a no-op without one)."""
        if self.grad_sync is not None and not self._synced:
            self.grad_sync(self.model)
            self._synced = True

    def apply_gradients(self) -> None:
        """One optimizer step of every group (the gradients reduced over
        the ranks first, `sync_gradients`), then the schedulers."""
        self.sync_gradients()
        self._synced = False
        for opt in self.optimizers:
            opt.step()
        for sched in self.schedulers:
            sched.step()
        self.step += 1


def _groups(model: nn.Module) -> Dict[str, List[nn.Parameter]]:
    """Trainable parameters by top-level module name: "canonicalizer" or
    "prediction" (everything else), the JAX package's labels."""
    groups: Dict[str, List[nn.Parameter]] = {"canonicalizer": [], "prediction": []}
    for name, p in model.named_parameters():
        if p.requires_grad:
            top = name.split(".")[0]
            groups["canonicalizer" if top == "canonicalizer" else "prediction"].append(p)
    return groups


def make_optimizer(
    model: nn.Module,
    *,
    architecture: str = "resnet50",
    dataset_name: str = "cifar10",
    learning_rate: float = 1e-3,
    canonicalization_learning_rate: float = 1e-3,
    weight_decay: float = 1e-4,
    freeze_prediction: bool = False,
    milestones: Tuple[int, ...] = (),
    decay_factor: float = 0.1,
) -> Tuple[List[torch.optim.Optimizer], List[Any]]:
    """The JAX package's per-architecture policy as (optimizers, schedulers).

    ResNet-50 off MNIST: SGD with momentum 0.9 and `weight_decay` added to
    the gradient (optax.chain(add_decayed_weights, sgd)), its learning rate
    scaled by `decay_factor` at each milestone step (MultiStepLR, stepped
    once per train step). Otherwise AdamW with `weight_decay`. The
    canonicalizer takes AdamW at `canonicalization_learning_rate` with
    optax's default decay, 1e-4 (torch's default is 1e-2). A frozen
    prediction network is left out of the optimizers: AdamW would still
    decay a parameter whose update optax sets to zero."""
    groups = _groups(model)
    optimizers: List[torch.optim.Optimizer] = []
    schedulers: List[Any] = []
    pred = groups["prediction"]
    if pred and not freeze_prediction:
        if architecture == "resnet50" and "mnist" not in dataset_name:
            opt = torch.optim.SGD(pred, lr=learning_rate, momentum=0.9,
                                  weight_decay=weight_decay)
            if milestones:
                schedulers.append(torch.optim.lr_scheduler.MultiStepLR(
                    opt, milestones=list(milestones), gamma=decay_factor))
        else:
            opt = torch.optim.AdamW(pred, lr=learning_rate,
                                    weight_decay=weight_decay)
        optimizers.append(opt)
    if groups["canonicalizer"]:
        optimizers.append(torch.optim.AdamW(
            groups["canonicalizer"], lr=canonicalization_learning_rate,
            weight_decay=1e-4))
    return optimizers, schedulers


def create_train_state(
    model: nn.Module,
    tx: Tuple[Sequence[torch.optim.Optimizer], Sequence[Any]],
) -> TrainState:
    """A `TrainState` at step 0 for `model` (which holds its weights) and
    `tx` = (optimizers, schedulers), as `make_optimizer` returns."""
    optimizers, schedulers = tx
    return TrainState(model=model, optimizers=list(optimizers),
                      schedulers=list(schedulers))


def make_train_step(loss_kwargs: Dict[str, Any], watch_gradients: bool = False):
    """train_step(state, batch, generator=None) -> (state, metrics).

    One forward in training mode (BatchNorm statistics updated, dropout
    masks and Gumbel noise drawn from `generator`), `classification_loss`,
    the backward pass and one optimizer step; the state is updated in
    place and returned. Its spans: `train/step` around the call, with
    `train/forward`, `train/loss`, `train/backward` (the gradients' sync
    over the ranks included) and `train/optimizer` under it
    (`utils.profiling`). watch_gradients=True adds `grad/<subtree>/norm`
    for each top-level module and `grad/global_norm` (of the reduced
    gradients under `parallel.data_parallel_jit`)."""

    def train_step(state: TrainState, batch: Dict[str, Tensor],
                   generator: Optional[torch.Generator] = None):
        with annotate("train/step"):
            model = state.model
            for opt in state.optimizers:
                opt.zero_grad(set_to_none=True)
            with annotate("train/forward"):
                logits, info = model(batch["image"], training=True, generator=generator)
            with annotate("train/loss"):
                loss, metrics = classification_loss(logits, batch["label"], info,
                                                    **loss_kwargs)
            with annotate("train/backward"):
                loss.backward()
                state.sync_gradients()
            if watch_gradients:
                total = torch.zeros((), device=loss.device)
                for name, child in model.named_children():
                    sq = torch.zeros((), device=loss.device)
                    for p in child.parameters():
                        if p.grad is not None:
                            g = p.grad
                            if hasattr(g, "full_tensor"):  # an FSDP-sharded gradient
                                g = g.full_tensor()
                            sq = sq + torch.sum(torch.square(g.float()))
                    metrics[f"grad/{name}/norm"] = torch.sqrt(sq)
                    total = total + sq
                metrics["grad/global_norm"] = torch.sqrt(total)
            with annotate("train/optimizer"):
                state.apply_gradients()
            return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


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


def orbit_logits(model: nn.Module, x: Tensor, *, num_rotations: int = 4,
                 group_type: str = "rotation", grayscale: bool = False):
    """The batch's orbit through the model in eval: element g applies
    rotate(x, +theta_g) (then the hflip for the reflection coset), the
    |G| copies group-major in one call (`materialize_orbit`: K4 where every
    element is a quarter turn of a square image). Returns (logits (|G| B,
    classes), info). Span: `group/orbit` around the orbit's making."""
    with annotate("group/orbit"):
        orbit = materialize_orbit(x, num_rotations, group_type=group_type,
                                  padding_mode="zeros" if grayscale else "border", sign=1.0)
    return model(orbit, training=False)


def group_inference(model: nn.Module, batch: Dict[str, Tensor], *,
                    num_rotations: int = 4, group_type: str = "rotation",
                    grayscale: bool = False) -> Dict[str, Tensor]:
    """Per-group-element robustness sweep: every element g applies
    rotate(x, +theta_g) (then the hflip for the reflection coset) to the
    batch, all |G| copies go through the model in one call, and the
    accuracy of each element and their mean are reported."""
    x, labels = batch["image"], batch["label"]
    B = x.shape[0]
    with torch.no_grad():
        logits, _ = orbit_logits(model, x, num_rotations=num_rotations,
                                 group_type=group_type, grayscale=grayscale)
    G = logits.shape[0] // B
    pred = torch.argmax(logits, -1).reshape(G, B)
    accs = torch.mean((pred == labels.to(pred.device)[None]).float(), dim=1)
    out = {f"test/acc_element_{g}": accs[g] for g in range(G)}
    out["test/group_acc"] = torch.mean(accs)
    out["test/acc"] = accs[0]
    return out
