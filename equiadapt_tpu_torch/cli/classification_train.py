"""Image-classification training CLI: train, test, dry-run, auto-tune.

The port's counterpart of `examples/images/classification/train.py`, with
the same dotted overrides, run modes and printouts. The config is composed
from the dataclass defaults, `config=<yaml>`, group selectors such as
`canonicalization=opt_group_equivariant` (read from the checkout's
`examples/images/classification/configs/`) and `a.b=value` overrides:

    python -m equiadapt_tpu_torch.cli.classification_train \\
        config=examples/images/classification/configs/default.yaml \\
        dataset.data_path=./data experiment.num_epochs=2
    python -m equiadapt_tpu_torch.cli.classification_train \\
        experiment.run_mode=test checkpoint.checkpoint_path=./checkpoints

Run modes (`experiment.run_mode`):
* `train`: `steps_per_epoch` steps an epoch (20 on synthetic data, 400 on
  a dataset, fewer when its split runs out), then a validation batch,
  `epoch i: {...} val/acc=...`, the checkpoint of the best val/acc (with
  `checkpoint.resume`, step-indexed saves and `resumed from epoch N`),
  early stopping after 10 epochs without a gain;
* `test`: the config and weights restored from the checkpoint, one test
  batch through `vanilla_inference` or `group_inference`
  (`experiment.inference_method`), the metrics printed;
* `dryrun`: one train step and one eval batch, `dryrun ok: ...`;
* `auto_tune`: the learning-rate range test (`utils.tuner.lr_find`), then
  training at the suggested rate.

`main(argv, device="cuda")` runs on the card unless asked for the CPU; it
returns the train state (train modes) or the test metrics (test mode).
Random draws come from one `torch.Generator` per stream of a run seeded
`experiment.seed`. `prediction.pretrained=true` loads the torchvision
checkpoint at `prediction.pretrained_path` into the prediction network
through `models.convert` (`prediction.freeze_encoder` then leaves it out of
the optimizer), as the JAX CLI does. Not ported yet, and refused: more than
one device or node (`parallel/`, ROADMAP.md item 16).
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Iterator

import torch

from equiadapt_tpu_torch.cli import generator
from equiadapt_tpu_torch.data import synthetic_image_batch
from equiadapt_tpu_torch.data.images import get_image_dataset
from equiadapt_tpu_torch.models.convert import apply_pretrained_to_state
from equiadapt_tpu_torch.pipelines.classification import (
    ImageClassifierPipeline,
    create_train_state,
    group_inference,
    make_eval_step,
    make_optimizer,
    make_train_step,
    vanilla_inference,
)
from equiadapt_tpu_torch.utils.checkpoint import (
    AsyncTrainCheckpointer,
    best_metric_saver,
    restore_checkpoint,
    restore_config,
)
from equiadapt_tpu_torch.utils.config import Config, compose_config
from equiadapt_tpu_torch.utils.metrics import (
    EarlyStopping,
    MetricLogger,
    assert_finite_loss,
    save_canonized_images,
)
from equiadapt_tpu_torch.utils.profiling import profile_trace
from equiadapt_tpu_torch.utils.registry import (
    get_image_canonicalization_network,
    get_image_canonicalizer,
    get_image_prediction_network,
)
from equiadapt_tpu_torch.utils.tuner import lr_find

Tensor = torch.Tensor

CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "examples", "images", "classification", "configs")
# generator streams of a run: epoch e's batches take stream e
STEP_STREAM, TEST_STREAM, PROFILE_STREAM = 1_000_000, 999, 77
VAL_STREAM, TUNE_STREAM = 10_000, 50_000


def steps_per_epoch(cfg: Config) -> int:
    return 20 if cfg.dataset.dataset_name == "synthetic" else 400


def build_pipeline(cfg: Config, device) -> ImageClassifierPipeline:
    """The pipeline of `cfg`, its weights drawn from the run's seed."""
    torch.manual_seed(cfg.experiment.seed)
    size = cfg.dataset.image_size
    in_shape = (size, size, cfg.dataset.in_channels)
    net = get_image_canonicalization_network(cfg.canonicalization, in_shape,
                                             device=device)
    canon = get_image_canonicalizer(cfg.canonicalization, net, in_shape,
                                    device=device)
    pred = get_image_prediction_network(cfg.prediction, cfg.dataset.num_classes,
                                        small_images=size <= 64, device=device,
                                        image_size=size)
    return ImageClassifierPipeline(canonicalizer=canon, prediction_network=pred,
                                   remat=cfg.prediction.remat)


def get_batches(cfg: Config, gen: torch.Generator, num_batches: int,
                split: str = "train", device="cuda") -> Iterator[Dict[str, Tensor]]:
    """split="train": shuffled and augmented; split="test": the held-out
    split in order, no augmentation. Synthetic data ignores the split
    (fresh draws from `gen`)."""
    if cfg.dataset.dataset_name == "synthetic":
        for _ in range(num_batches):
            yield synthetic_image_batch(
                gen, cfg.experiment.batch_size, size=cfg.dataset.image_size,
                channels=cfg.dataset.in_channels,
                num_classes=cfg.dataset.num_classes)
    else:
        yield from get_image_dataset(cfg, gen, num_batches, split=split,
                                     device=device)


def compose(argv) -> Config:
    """The run's config: `argv` over the defaults; the named run directory;
    in test mode with a checkpoint, the config saved with it."""
    cfg = compose_config(argv, config_dir=CONFIG_DIR)
    if cfg.checkpoint.checkpoint_name and cfg.checkpoint.checkpoint_path:
        cfg = cfg.override(
            "checkpoint.checkpoint_path="
            f"{cfg.checkpoint.checkpoint_path}/{cfg.checkpoint.checkpoint_name}")
    if cfg.experiment.run_mode == "test" and cfg.checkpoint.checkpoint_path:
        cfg = restore_config(cfg.checkpoint.checkpoint_path).override(
            "experiment.run_mode=test")
    return cfg


def loss_kwargs(cfg: Config) -> dict:
    return {
        "task_weight": cfg.experiment.loss.task_weight,
        "prior_weight": cfg.experiment.loss.prior_weight,
        "group_contrast_weight": cfg.experiment.loss.group_contrast_weight,
        "canonicalization_type": cfg.canonicalization.canonicalization_type,
        "out_vector_size": cfg.canonicalization.network_hyperparams.out_vector_size,
        "artifact_err_wt": cfg.canonicalization.artifact_err_wt,
    }


def build_state(cfg: Config, device, learning_rate=None):
    """A fresh pipeline in a train state with the config's optimizers."""
    pipe = build_pipeline(cfg, device)
    tx = make_optimizer(
        pipe,
        architecture=cfg.prediction.architecture,
        dataset_name=cfg.dataset.dataset_name,
        learning_rate=(cfg.experiment.learning_rate if learning_rate is None
                       else learning_rate),
        canonicalization_learning_rate=cfg.experiment.canonicalization_learning_rate,
        weight_decay=cfg.experiment.weight_decay,
        freeze_prediction=cfg.prediction.freeze_encoder,
    )
    state = create_train_state(pipe, tx)
    if cfg.prediction.pretrained:
        if not cfg.prediction.pretrained_path:
            raise ValueError(
                "prediction.pretrained=true needs prediction.pretrained_path "
                "(a local torchvision .pth; no egress to download DEFAULT "
                "weights — see models/convert.py)")
        apply_pretrained_to_state(state, cfg.prediction.architecture,
                                  cfg.prediction.pretrained_path)
        print(f"loaded pretrained {cfg.prediction.architecture} weights "
              f"from {cfg.prediction.pretrained_path}")
    return state


def run_test(cfg: Config, state, device) -> Dict[str, float]:
    """One held-out batch through the configured evaluator."""
    batch = next(get_batches(cfg, generator(cfg.experiment.seed, TEST_STREAM, device),
                             1, split="test", device=device))
    if cfg.experiment.inference_method == "group":
        metrics = group_inference(
            state.model, batch,
            num_rotations=cfg.experiment.num_group_elements_for_inference,
            grayscale=cfg.dataset.in_channels == 1)
    else:
        metrics = vanilla_inference(state.model, batch, cfg.dataset.num_classes)
    return {k: float(v.float().mean()) for k, v in metrics.items()}


def main(argv, device="cuda"):
    cfg = compose(argv)
    if cfg.experiment.num_nodes > 1 or cfg.experiment.num_devices > 1:
        raise NotImplementedError(
            "training on more than one device or node needs parallel/, not "
            "ported yet (ROADMAP.md item 16)")
    seed = cfg.experiment.seed
    path = cfg.checkpoint.checkpoint_path
    state = build_state(cfg, device)
    kw = loss_kwargs(cfg)
    step = make_train_step(kw, watch_gradients=cfg.experiment.watch_gradients)
    eval_step = make_eval_step(kw)
    draws = generator(seed, STEP_STREAM, device)

    if cfg.experiment.run_mode == "test":
        state = restore_checkpoint(path, state, strict=cfg.checkpoint.strict_loading)
        out = run_test(cfg, state, device)
        print(out)
        return out

    if cfg.experiment.run_mode == "dryrun":
        batch = next(get_batches(cfg, generator(seed, 0, device), 1, device=device))
        state, tm = step(state, batch, draws)
        vm = eval_step(state.model, batch)
        print(f"dryrun ok: train loss={float(tm['loss/total']):.4f} "
              f"eval loss={float(vm['loss/total']):.4f}")
        return state

    if cfg.experiment.run_mode == "auto_tune":
        def batches():
            e = 0
            while True:
                yield from get_batches(cfg, generator(seed, TUNE_STREAM + e, device),
                                       10, device=device)
                e += 1

        result = lr_find(build_pipeline(cfg, device),
                         make_step=lambda s: make_train_step(kw),
                         batches=batches(), generator=draws)
        print(f"auto_tune: suggested learning rate {result.suggestion:.3e}")
        state = build_state(cfg, device, learning_rate=result.suggestion)

    logger = MetricLogger(f"{path}/train_log.jsonl" if path else None)
    saver = best_metric_saver(path) if path else None
    stopper = EarlyStopping(patience=10)
    resumer = None
    start_epoch = 0
    if cfg.checkpoint.resume and path:
        resumer = AsyncTrainCheckpointer(path, config=cfg)
        state, latest = resumer.restore_latest(state)
        if latest is not None:
            start_epoch = latest + 1
            print(f"resumed from epoch {latest}")
    if cfg.experiment.profile:
        with profile_trace(cfg.experiment.profile_dir):
            b = next(get_batches(cfg, generator(seed, PROFILE_STREAM, device), 1,
                                 device=device))
            for _ in range(3):
                state, m = step(state, b, draws)
            float(m["loss/total"])  # waits for the device
        print(f"profile trace written to {cfg.experiment.profile_dir}")
    try:
        for epoch in range(start_epoch, cfg.experiment.num_epochs):
            for batch in get_batches(cfg, generator(seed, epoch, device),
                                     steps_per_epoch(cfg), device=device):
                state, metrics = step(state, batch, draws)
                assert_finite_loss(metrics)
                logger.update(metrics)
            val = next(get_batches(cfg, generator(seed, VAL_STREAM + epoch, device),
                                   1, split="test", device=device))
            vm = eval_step(state.model, val)
            if cfg.checkpoint.save_canonized_images and path:
                with torch.no_grad():
                    x_c, _ = state.model.canonicalize(val["image"][:8])
                save_canonized_images(f"{path}/canonized_epoch{epoch}.png",
                                      val["image"][:8], x_c)
            means = logger.flush(epoch, prefix="train/")
            acc = float(vm["metric/acc"])
            print(f"epoch {epoch}: {means} val/acc={acc:.4f}")
            if saver is not None:
                saver.maybe_save(acc, state, cfg)
            if resumer is not None:
                resumer.save(epoch, state)  # written in the background
            if stopper.update(acc):
                print("early stopping")
                break
    finally:
        if resumer is not None:
            resumer.close()
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
