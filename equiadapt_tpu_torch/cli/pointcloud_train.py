"""Point-cloud classification training CLI: train, then test from the
checkpoint.

The port's counterpart of `examples/pointcloud/classification/train.py`,
with the same overrides, defaults and printouts. The config is composed
from the CLI's defaults (`continuous_group` canonicalization, PointNet,
8 classes), `config=<yaml>`, group selectors such as
`canonicalization=group_equivariant_fused` (read from the checkout's
`examples/pointcloud/classification/configs/`) and `a.b=value` overrides:

    python -m equiadapt_tpu_torch.cli.pointcloud_train \\
        config=examples/pointcloud/classification/configs/default.yaml \\
        canonicalization=group_equivariant_fused experiment.num_epochs=1 \\
        checkpoint.checkpoint_path=./checkpoints
    python -m equiadapt_tpu_torch.cli.pointcloud_train \\
        experiment.run_mode=test checkpoint.checkpoint_path=./checkpoints

Data: ModelNet40 HDF5 under `dataset.data_path` when
`dataset.dataset_name=modelnet40` and the tree is there (then the number of
classes is the data's), else `synthetic_pointcloud_batch` drawn on the
device (20 steps an epoch). Train mode runs `make_pointcloud_train_step`
(z rotation, point dropout, scale and shift, prior weight 1 as the JAX CLI
sets it, whatever the yaml's loss weights), prints `epoch i: {...} val
z-rot acc=...` after each epoch and keeps the checkpoint of the best
validation accuracy. Test mode restores the config and the weights from
the checkpoint and prints the accuracy under no, z and SO(3) test-time
rotations (`test/acc_none`, `test/acc_z`, `test/acc_so3`).
`main(argv, device="cuda")` runs on the card unless asked for the CPU; it
returns the train state (train mode) or the test metrics (test mode).
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from equiadapt_tpu_torch.cli import generator
from equiadapt_tpu_torch.data import synthetic_pointcloud_batch
from equiadapt_tpu_torch.pipelines.pointcloud import (
    PointcloudClassificationPipeline,
    classification_metrics,
    create_pointcloud_state,
    make_pointcloud_train_step,
    random_rotate,
)
from equiadapt_tpu_torch.utils.checkpoint import (
    best_metric_saver,
    restore_checkpoint,
    restore_config,
)
from equiadapt_tpu_torch.utils.config import Config, compose_config
from equiadapt_tpu_torch.utils.metrics import MetricLogger
from equiadapt_tpu_torch.utils.registry import (
    get_pointcloud_canonicalizer,
    get_pointcloud_prediction_network,
)

Tensor = torch.Tensor

CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "examples", "pointcloud", "classification", "configs")
SYNTHETIC_STEPS = 20
# generator streams of a run: epoch e's batches take stream e (its shuffle
# too, on a dataset)
STEP_STREAM, VAL_STREAM, ROTATION_STREAM = 1_000_000, 99_999, 7_000


def compose(argv) -> Config:
    """The run's config: the CLI's defaults, then `argv`; in test mode with
    a checkpoint, the config saved with it."""
    cfg = compose_config(argv, config_dir=CONFIG_DIR, base=[
        "canonicalization.canonicalization_type=continuous_group",
        "prediction.architecture=pointnet",
        "dataset.num_classes=8",
    ])
    if cfg.checkpoint.checkpoint_name and cfg.checkpoint.checkpoint_path:
        cfg = cfg.override(
            "checkpoint.checkpoint_path="
            f"{cfg.checkpoint.checkpoint_path}/{cfg.checkpoint.checkpoint_name}")
    if cfg.experiment.run_mode == "test" and cfg.checkpoint.checkpoint_path:
        cfg = restore_config(cfg.checkpoint.checkpoint_path).override(
            "experiment.run_mode=test")
    return cfg


def modelnet_splits(cfg: Config):
    """(train, test) ModelNet40 dicts of numpy arrays if the HDF5 tree
    exists, else None."""
    root = os.path.join(cfg.dataset.data_path, "modelnet40_ply_hdf5_2048")
    if cfg.dataset.dataset_name != "modelnet40" or not os.path.isdir(root):
        return None
    from equiadapt_tpu_torch.data.pointcloud import load_modelnet40

    return load_modelnet40(cfg.dataset.data_path, cfg.dataset.num_points)


def _on(split: Dict[str, np.ndarray], idx, device) -> Dict[str, Tensor]:
    return {k: torch.as_tensor(v[idx]).to(device) for k, v in split.items()}


def get_batches(cfg: Config, split: Optional[Dict[str, np.ndarray]], num_classes: int,
                epoch: int, device) -> Iterator[Dict[str, Tensor]]:
    """One epoch's batches: shuffled minibatches of the loaded split (as
    many as it holds), or SYNTHETIC_STEPS synthetic draws."""
    bs = cfg.experiment.batch_size
    gen = generator(cfg.experiment.seed, epoch, device)
    if split is not None:
        n = split["points"].shape[0]
        perm = torch.randperm(n, generator=gen, device=device).cpu().numpy()
        for i in range(n // bs):
            yield _on(split, perm[i * bs:(i + 1) * bs], device)
    else:
        for _ in range(SYNTHETIC_STEPS):
            yield synthetic_pointcloud_batch(gen, bs, num_points=cfg.dataset.num_points,
                                             num_classes=num_classes)


def val_batch(cfg: Config, test: Optional[Dict[str, np.ndarray]], num_classes: int,
              device) -> Dict[str, Tensor]:
    """The validation and test batch: the test split's first batch, or a
    synthetic draw of its own stream."""
    if test is not None:
        return _on(test, slice(0, cfg.experiment.batch_size), device)
    return synthetic_pointcloud_batch(
        generator(cfg.experiment.seed, VAL_STREAM, device), cfg.experiment.batch_size,
        num_points=cfg.dataset.num_points, num_classes=num_classes)


def build_state(cfg: Config, num_classes: int, device):
    """The pipeline of `cfg` (weights drawn from the run's seed) in a train
    state with AdamW at the config's learning rate."""
    torch.manual_seed(cfg.experiment.seed)
    pipe = PointcloudClassificationPipeline(
        get_pointcloud_canonicalizer(cfg.canonicalization, device=device),
        get_pointcloud_prediction_network(cfg.prediction.architecture, num_classes,
                                          device=device))
    return create_pointcloud_state(pipe, cfg.experiment.learning_rate)


def eval_metrics(model, batch: Dict[str, Tensor], num_classes: int, rotation: str,
                 gen: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
    """`classification_metrics` of the eval-mode model on the batch turned
    by a random `rotation` ("none", "z" or "so3") drawn from `gen`."""
    with torch.no_grad():
        pts = random_rotate(batch["points"], rotation, gen)
        logits, _ = model(pts, training=False)
        return classification_metrics(logits, batch["label"], num_classes)


def robustness_eval(model, batch: Dict[str, Tensor], num_classes: int, seed: int,
                    device) -> Dict[str, float]:
    """Accuracy under no, z and SO(3) test-time rotations, each drawn from
    a stream of its own."""
    out = {}
    for fold, mode in enumerate(("none", "z", "so3")):
        m = eval_metrics(model, batch, num_classes, mode,
                         generator(seed, ROTATION_STREAM + fold, device))
        out[f"test/acc_{mode}"] = float(m["metric/acc"])
    return out


def main(argv, device="cuda"):
    """Run the CLI; returns the train state (train mode) or the test
    metrics (test mode)."""
    cfg = compose(argv)
    seed = cfg.experiment.seed
    num_classes = cfg.dataset.num_classes
    data = modelnet_splits(cfg)
    train, test = data if data is not None else (None, None)
    if train is not None:
        num_classes = int(train["label"].max()) + 1
    state = build_state(cfg, num_classes, device)

    if cfg.experiment.run_mode == "test":
        state = restore_checkpoint(cfg.checkpoint.checkpoint_path, state,
                                   strict=cfg.checkpoint.strict_loading)
        out = robustness_eval(state.model, val_batch(cfg, test, num_classes, device),
                              num_classes, seed, device)
        print(out)
        return out

    step = make_pointcloud_train_step(num_classes=num_classes, train_rotation="z")
    draws = generator(seed, STEP_STREAM, device)
    logger = MetricLogger(None)
    path = cfg.checkpoint.checkpoint_path
    saver = best_metric_saver(path) if path else None
    for epoch in range(cfg.experiment.num_epochs):
        for batch in get_batches(cfg, train, num_classes, epoch, device):
            state, metrics = step(state, batch, draws)
            logger.update(metrics)
        vm = eval_metrics(state.model, val_batch(cfg, test, num_classes, device),
                          num_classes, "z", generator(seed, VAL_STREAM + 1 + epoch, device))
        acc = float(vm["metric/acc"])
        print(f"epoch {epoch}: {logger.flush(epoch)} val z-rot acc={acc:.4f}")
        if saver is not None:
            saver.maybe_save(acc, state, cfg)
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
