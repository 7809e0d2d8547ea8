"""ShapeNet-Part part-segmentation training CLI: train, then test from the
checkpoint.

The port's counterpart of `examples/pointcloud/part_segmentation/train.py`,
with the same overrides, choices and printouts. The config is composed from
the CLI's default (`continuous_group` canonicalization), `config=<yaml>`,
group selectors (read from the checkout's
`examples/pointcloud/part_segmentation/configs/`) and `a.b=value`
overrides:

    python -m equiadapt_tpu_torch.cli.partseg_train experiment.num_epochs=2 \\
        checkpoint.checkpoint_path=./checkpoints
    python -m equiadapt_tpu_torch.cli.partseg_train experiment.run_mode=test \\
        checkpoint.checkpoint_path=./checkpoints

As the JAX CLI does, whatever the yaml says: the predictor is
`DGCNNPartSeg(k=8, emb_dims=128)`, a batch holds 8 clouds, an epoch is 10
steps, and the prior loss has weight 1. Data: ShapeNet-Part HDF5 under
`dataset.data_path` when the tree is there (random clouds of a split, the
part and category counts the data's), else `synthetic_partseg_batch`
(min(num_points, 256) points, 4 categories, the 8 octants as parts). Train
mode prints `epoch i: {...} val miou=...` after each epoch and keeps the
checkpoint of the best validation mIoU; test mode restores the config and
the weights and prints `{'test/acc': ..., 'test/miou': ...}`.

The step (`make_partseg_train_step`) and the metrics (`eval_metrics`:
point accuracy and the mean over the part classes of their IoU) are
module-level functions, so a caller can drive the CLI's step at any width.
`main(argv, device="cuda")` runs on the card unless asked for the CPU; it
returns the train state (train mode) or the test metrics (test mode).
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from equiadapt_tpu_torch.cli import generator
from equiadapt_tpu_torch.common.info import (
    IdentityCanonicalizationInfo,
    prior_regularization_loss,
)
from equiadapt_tpu_torch.models.pointnet import DGCNNPartSeg
from equiadapt_tpu_torch.pipelines.classification import TrainState
from equiadapt_tpu_torch.pipelines.pointcloud import (
    PointcloudPartSegPipeline,
    create_pointcloud_state,
    random_rotate,
)
from equiadapt_tpu_torch.utils.checkpoint import (
    best_metric_saver,
    restore_checkpoint,
    restore_config,
)
from equiadapt_tpu_torch.utils.config import Config, compose_config
from equiadapt_tpu_torch.utils.metrics import MetricLogger
from equiadapt_tpu_torch.utils.registry import get_pointcloud_canonicalizer

Tensor = torch.Tensor

CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "examples", "pointcloud", "part_segmentation", "configs")
# the JAX CLI's choices: batch, steps an epoch, the predictor's k and width,
# the synthetic task's categories, parts and largest cloud
BATCH, STEPS_PER_EPOCH, K, EMB_DIMS = 8, 10, 8, 128
SYNTHETIC_CATEGORIES, SYNTHETIC_PARTS, SYNTHETIC_MAX_POINTS = 4, 8, 256
# generator streams: batch `fold` takes stream fold; the steps' draws
STEP_STREAM, VAL_FOLD, TEST_FOLD = 1_000_000, 10_000, 777


def synthetic_partseg_batch(gen: torch.Generator, batch: int, num_points: int = 256,
                            num_categories: int = 4) -> Dict[str, Tensor]:
    """Gaussian clouds (scale 0.4) with a random category each; a point's
    part is its octant (4 [x > 0] + 2 [y > 0] + [z > 0]), which a rotation
    changes, so canonicalization helps."""
    dev = gen.device
    pts = torch.randn(batch, num_points, 3, generator=gen, device=dev) * 0.4
    cat = torch.randint(0, num_categories, (batch,), generator=gen, device=dev)
    parts = ((pts[..., 0] > 0).long() * 4 + (pts[..., 1] > 0).long() * 2
             + (pts[..., 2] > 0).long())
    return {"points": pts, "category": cat, "part_label": parts}


def compose(argv) -> Config:
    """The run's config: the CLI's default, then `argv`; in test mode with
    a checkpoint, the config saved with it."""
    cfg = compose_config(argv, config_dir=CONFIG_DIR, base=[
        "canonicalization.canonicalization_type=continuous_group"])
    if cfg.checkpoint.checkpoint_name and cfg.checkpoint.checkpoint_path:
        cfg = cfg.override(
            "checkpoint.checkpoint_path="
            f"{cfg.checkpoint.checkpoint_path}/{cfg.checkpoint.checkpoint_name}")
    if cfg.experiment.run_mode == "test" and cfg.checkpoint.checkpoint_path:
        cfg = restore_config(cfg.checkpoint.checkpoint_path).override(
            "experiment.run_mode=test")
    return cfg


def shapenet_splits(cfg: Config):
    """(train, test) ShapeNet-Part dicts of numpy arrays if the HDF5 tree
    exists, else None."""
    root = os.path.join(cfg.dataset.data_path, "shapenet_part_seg_hdf5_data")
    if not os.path.isdir(root):
        return None
    from equiadapt_tpu_torch.data.pointcloud import load_shapenet_part

    return (load_shapenet_part(cfg.dataset.data_path, "train", cfg.dataset.num_points),
            load_shapenet_part(cfg.dataset.data_path, "test", cfg.dataset.num_points))


def get_batch(cfg: Config, fold: int, split: Optional[Dict[str, np.ndarray]],
              num_categories: int, device) -> Dict[str, Tensor]:
    """Batch `fold`: BATCH random clouds of the split (drawn with
    replacement), or a synthetic draw."""
    gen = generator(cfg.experiment.seed, fold, device)
    if split is not None:
        n = split["points"].shape[0]
        idx = torch.randint(0, n, (min(BATCH, n),), generator=gen,
                            device=device).cpu().numpy()
        return {k: torch.as_tensor(v[idx]).to(device) for k, v in split.items()}
    return synthetic_partseg_batch(
        gen, BATCH, num_points=min(cfg.dataset.num_points, SYNTHETIC_MAX_POINTS),
        num_categories=num_categories)


def eval_metrics(logits: Tensor, part_label: Tensor,
                 num_parts: int) -> Tuple[Tensor, Tensor]:
    """(point accuracy, mIoU): the mean over all `num_parts` classes of
    |pred = p and label = p| / max(|pred = p or label = p|, 1), a class
    absent from both counting 0."""
    pred = torch.argmax(logits, -1)
    acc = torch.mean((pred == part_label).float())
    parts = torch.arange(num_parts, device=pred.device)
    is_pred = (pred[..., None] == parts).reshape(-1, num_parts)
    is_label = (part_label[..., None] == parts).reshape(-1, num_parts)
    inter = torch.sum(is_pred & is_label, dim=0)
    union = torch.sum(is_pred | is_label, dim=0)
    return acc, torch.mean(inter / torch.clamp(union, min=1))


def partseg_loss(logits: Tensor, part_label: Tensor, info,
                 num_parts: int) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Per-point cross entropy plus the prior loss (weight 1; none for the
    identity canonicalizer); (loss, metrics)."""
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           part_label.reshape(-1).long())
    if not isinstance(info, IdentityCanonicalizationInfo):
        loss = loss + prior_regularization_loss(info)
    acc, miou = eval_metrics(logits, part_label, num_parts)
    return loss, {"loss/total": loss, "metric/acc": acc, "metric/miou": miou}


def make_partseg_train_step(num_categories: int, num_parts: int):
    """train_step(state, batch, generator=None) -> (state, metrics): the
    batch's clouds turned by random z rotations, the forward in training
    mode (dropout masks from `generator`), `partseg_loss`, the backward
    pass and one optimizer step; the state is updated in place."""

    def train_step(state: TrainState, batch: Dict[str, Tensor],
                   generator: Optional[torch.Generator] = None):
        model = state.model
        for opt in state.optimizers:
            opt.zero_grad(set_to_none=True)
        pts = random_rotate(batch["points"], "z", generator)
        onehot = F.one_hot(batch["category"].long(), num_categories).to(pts.dtype)
        logits, info = model(pts, onehot, training=True, generator=generator)
        loss, metrics = partseg_loss(logits, batch["part_label"], info, num_parts)
        loss.backward()
        state.apply_gradients()
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def eval_step(model, batch: Dict[str, Tensor], num_categories: int,
              num_parts: int) -> Dict[str, float]:
    """Point accuracy and mIoU of the eval-mode model on the batch."""
    with torch.no_grad():
        onehot = F.one_hot(batch["category"].long(), num_categories).to(
            batch["points"].dtype)
        logits, _ = model(batch["points"], onehot, training=False)
        acc, miou = eval_metrics(logits, batch["part_label"], num_parts)
    return {"test/acc": float(acc), "test/miou": float(miou)}


def build_state(cfg: Config, num_parts: int, num_categories: int, device):
    """The CLI's pipeline (weights drawn from the run's seed) in a train
    state with AdamW at the config's learning rate."""
    torch.manual_seed(cfg.experiment.seed)
    pipe = PointcloudPartSegPipeline(
        get_pointcloud_canonicalizer(cfg.canonicalization, device=device),
        DGCNNPartSeg(num_parts=num_parts, num_categories=num_categories, k=K,
                     emb_dims=EMB_DIMS, device=device))
    return create_pointcloud_state(pipe, cfg.experiment.learning_rate)


def main(argv, device="cuda"):
    """Run the CLI; returns the train state (train mode) or the test
    metrics (test mode)."""
    cfg = compose(argv)
    data = shapenet_splits(cfg)
    if data is not None:
        train, test = data
        num_parts = int(train["part_label"].max()) + 1
        num_cats = int(train["category"].max()) + 1
    else:
        train = test = None
        num_parts, num_cats = SYNTHETIC_PARTS, SYNTHETIC_CATEGORIES
    state = build_state(cfg, num_parts, num_cats, device)

    if cfg.experiment.run_mode == "test":
        state = restore_checkpoint(cfg.checkpoint.checkpoint_path, state,
                                   strict=cfg.checkpoint.strict_loading)
        out = eval_step(state.model, get_batch(cfg, TEST_FOLD, test, num_cats, device),
                        num_cats, num_parts)
        print(out)
        return out

    step = make_partseg_train_step(num_cats, num_parts)
    draws = generator(cfg.experiment.seed, STEP_STREAM, device)
    logger = MetricLogger(None)
    path = cfg.checkpoint.checkpoint_path
    saver = best_metric_saver(path) if path else None
    for epoch in range(cfg.experiment.num_epochs):
        for i in range(STEPS_PER_EPOCH):
            batch = get_batch(cfg, epoch * 100 + i, train, num_cats, device)
            state, metrics = step(state, batch, draws)
            logger.update(metrics)
        vm = eval_step(state.model, get_batch(cfg, VAL_FOLD + epoch, test, num_cats,
                                              device), num_cats, num_parts)
        print(f"epoch {epoch}: {logger.flush(epoch)} val miou={vm['test/miou']:.4f}")
        if saver is not None:
            saver.maybe_save(vm["test/miou"], state, cfg)
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
