"""Instance-segmentation training CLI: the prior-regularized promptable model.

The port's counterpart of `examples/images/segmentation/train.py`, with the
same overrides, cuts and printouts. The config is composed from
`examples/images/segmentation/configs/` (read as YAML) over the JAX CLI's
base (`dataset.image_size=128`, the canonicalizer's out_channels 8); the
model is `SAMLite(embed_dim=128, encoder_depth=2, decoder_depth=2,
num_heads=4)`, as the JAX CLI builds it: like the JAX CLI, it reads
neither `prediction.architecture` nor `prediction.freeze_encoder`. The
data is the synthetic rectangles task (batches of 4 images, 4 box prompts
each), drawn on the device.

    python -m equiadapt_tpu_torch.cli.segmentation_train experiment.num_epochs=2 \\
        experiment.loss.prior_weight=100 checkpoint.checkpoint_path=./checkpoints
    python -m equiadapt_tpu_torch.cli.segmentation_train experiment.run_mode=test \\
        checkpoint.checkpoint_path=./checkpoints

Train mode runs 10 steps an epoch (AdamW at the config's learning rate),
prints `epoch i: {...}`, keeps the checkpoint of the best `test/group_map`
of a validation sweep after each epoch, and prints the final sweep; test
mode restores the config and the weights from the checkpoint and prints
the sweep (`segmentation_group_inference`: the mAP of each group element
and their mean). `main(argv, device="cuda")` runs on the card unless asked
for the CPU.
"""

from __future__ import annotations

import os
import sys

import torch

from equiadapt_tpu_torch.cli import generator
from equiadapt_tpu_torch.data.coco import synthetic_coco_batch
from equiadapt_tpu_torch.models.segmentation import SAMLite
from equiadapt_tpu_torch.pipelines.segmentation import (
    ImageSegmentationPipeline,
    create_segmentation_state,
    make_segmentation_train_step,
    segmentation_group_inference,
)
from equiadapt_tpu_torch.utils.checkpoint import (
    best_metric_saver,
    restore_checkpoint,
    restore_config,
)
from equiadapt_tpu_torch.utils.config import Config, compose_config
from equiadapt_tpu_torch.utils.metrics import MetricLogger
from equiadapt_tpu_torch.utils.registry import (
    get_image_canonicalization_network,
    get_image_canonicalizer,
)

CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "examples", "images", "segmentation", "configs")
BATCH, STEPS_PER_EPOCH = 4, 10
# generator streams (the JAX CLI's fold-ins): training batch i of an epoch
# is epoch * 100 + i, its validation sweep VALID_STREAM + epoch; the
# canonicalization network's dropout masks come from DROPOUT_STREAM
VALID_STREAM, TEST_STREAM, DROPOUT_STREAM = 10_000, 777, 3


def compose(argv) -> Config:
    """The run's config: the CLI's base, then `argv`; in test mode with a
    checkpoint, the config saved with it."""
    cfg = compose_config(argv, config_dir=CONFIG_DIR, base=[
        "dataset.image_size=128",
        "canonicalization.network_hyperparams.out_channels=8",
    ])
    if cfg.checkpoint.checkpoint_name and cfg.checkpoint.checkpoint_path:
        cfg = cfg.override(
            "checkpoint.checkpoint_path="
            f"{cfg.checkpoint.checkpoint_path}/{cfg.checkpoint.checkpoint_name}")
    if cfg.experiment.run_mode == "test" and cfg.checkpoint.checkpoint_path:
        cfg = restore_config(cfg.checkpoint.checkpoint_path).override(
            "experiment.run_mode=test")
    return cfg


def build_pipeline(cfg: Config, device) -> ImageSegmentationPipeline:
    """The canonicalizer of `cfg` and the CLI's SAMLite, weights drawn from
    the run's seed."""
    torch.manual_seed(cfg.experiment.seed)
    size = cfg.dataset.image_size
    in_shape = (size, size, 3)
    net = get_image_canonicalization_network(cfg.canonicalization, in_shape,
                                             device=device)
    canon = get_image_canonicalizer(cfg.canonicalization, net, in_shape,
                                    device=device)
    sam = SAMLite(size, embed_dim=128, encoder_depth=2, decoder_depth=2,
                  num_heads=4, device=device)
    return ImageSegmentationPipeline(canonicalizer=canon, prediction_network=sam)


def group_sweep(cfg: Config, model: ImageSegmentationPipeline, stream: int, device):
    """The mAP sweep over the canonicalizer's rotations on one fresh batch."""
    val = synthetic_coco_batch(generator(cfg.experiment.seed, stream, device), BATCH,
                               image_size=cfg.dataset.image_size)
    return segmentation_group_inference(
        model, val,
        num_rotations=cfg.canonicalization.network_hyperparams.num_rotations)


def main(argv, device="cuda"):
    """Run the CLI; returns the train state (train mode) or the test sweep's
    metrics as floats (test mode)."""
    cfg = compose(argv)
    seed = cfg.experiment.seed
    state = create_segmentation_state(build_pipeline(cfg, device),
                                      cfg.experiment.learning_rate)

    if cfg.experiment.run_mode == "test":
        state = restore_checkpoint(cfg.checkpoint.checkpoint_path, state,
                                   strict=cfg.checkpoint.strict_loading)
        out = {k: float(v) for k, v in
               group_sweep(cfg, state.model, TEST_STREAM, device).items()}
        print(out)
        return out

    step = make_segmentation_train_step(prior_weight=cfg.experiment.loss.prior_weight)
    logger = MetricLogger(None)
    saver = (best_metric_saver(cfg.checkpoint.checkpoint_path)
             if cfg.checkpoint.checkpoint_path else None)
    dropout = generator(seed, DROPOUT_STREAM, device)
    for epoch in range(cfg.experiment.num_epochs):
        for i in range(STEPS_PER_EPOCH):
            batch = synthetic_coco_batch(generator(seed, epoch * 100 + i, device),
                                         BATCH, image_size=cfg.dataset.image_size)
            state, metrics = step(state, batch, dropout)
            logger.update(metrics)
        print(f"epoch {epoch}: {logger.flush(epoch)}")
        if saver is not None:
            gm = group_sweep(cfg, state.model, VALID_STREAM + epoch, device)
            saver.maybe_save(float(gm["test/group_map"]), state, cfg)
    print({k: float(v) for k, v in
           group_sweep(cfg, state.model, TEST_STREAM, device).items()})
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
