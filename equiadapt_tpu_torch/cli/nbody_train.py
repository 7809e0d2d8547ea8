"""N-body training CLI: simulate, train, checkpoint, test from the checkpoint.

The port's counterpart of `examples/nbody/train.py`, with the same
overrides and printouts. The config is composed from
`examples/nbody/configs/` (read as YAML); the charged-particle data is
simulated on the device (`data.nbody_sim`): 512 training, 128 validation
and, in test mode, 128 test graphs, predicting frame 40 from frame 30.

    python -m equiadapt_tpu_torch.cli.nbody_train prediction.architecture=GNN \\
        experiment.num_epochs=5
    python -m equiadapt_tpu_torch.cli.nbody_train experiment.run_mode=test \\
        checkpoint.checkpoint_path=./checkpoints

Train mode prints `epoch i: {...} val/mse=...` after each epoch and keeps
the checkpoint of the best validation MSE; test mode restores the config
and the weights from the checkpoint and prints `{'test/mse': ...}`.
`main(argv, device="cuda")` runs on the card unless asked for the CPU.
"""

from __future__ import annotations

import os
import sys
from typing import Dict

import torch

from equiadapt_tpu_torch.cli import generator
from equiadapt_tpu_torch.data import generate_nbody_dataset
from equiadapt_tpu_torch.pipelines.nbody import (
    NBodyPipeline,
    create_nbody_state,
    make_nbody_train_step,
    nbody_eval_mse,
)
from equiadapt_tpu_torch.utils.checkpoint import (
    best_metric_saver,
    restore_checkpoint,
    restore_config,
)
from equiadapt_tpu_torch.utils.config import Config, compose_config
from equiadapt_tpu_torch.utils.metrics import MetricLogger
from equiadapt_tpu_torch.utils.registry import (
    get_nbody_canonicalizer,
    get_nbody_prediction_network,
)

CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "examples", "nbody", "configs")
# graphs per split; the generator stream of each draw
SPLITS = {"train": (512, 0), "valid": (128, 1), "test": (128, 2)}
DROPOUT_STREAM, PERMUTATION_STREAM = 3, 100


def dataset_split(cfg: Config, split: str, device) -> Dict[str, torch.Tensor]:
    """One split of the run's data, simulated on `device`."""
    num, stream = SPLITS[split]
    return generate_nbody_dataset(
        generator(cfg.experiment.seed, stream, device), num,
        n_balls=cfg.dataset.num_nodes_graph, device=device)


def compose(argv) -> Config:
    """The run's config: the CLI's defaults, then `argv`; in test mode with
    a checkpoint, the config saved with it."""
    cfg = compose_config(argv, config_dir=CONFIG_DIR, base=[
        "prediction.architecture=GNN",
        "canonicalization.canonicalization_type=continuous_group",
        "canonicalization.network_hyperparams.canon_feature=pv",
    ])
    if cfg.checkpoint.checkpoint_name and cfg.checkpoint.checkpoint_path:
        cfg = cfg.override(
            "checkpoint.checkpoint_path="
            f"{cfg.checkpoint.checkpoint_path}/{cfg.checkpoint.checkpoint_name}")
    if cfg.experiment.run_mode == "test" and cfg.checkpoint.checkpoint_path:
        cfg = restore_config(cfg.checkpoint.checkpoint_path).override(
            "experiment.run_mode=test")
    return cfg


def build_state(cfg: Config, device):
    """The pipeline of `cfg` (weights drawn from the run's seed) in a train
    state with AdamW at the config's learning rate and weight decay."""
    torch.manual_seed(cfg.experiment.seed)
    pipe = NBodyPipeline(get_nbody_canonicalizer(cfg.canonicalization, device=device),
                         get_nbody_prediction_network(cfg.prediction, device=device))
    return create_nbody_state(pipe, cfg.experiment.learning_rate,
                              cfg.experiment.weight_decay)


def main(argv, device="cuda"):
    """Run the CLI; returns the train state (train mode) or the test
    metrics (test mode)."""
    cfg = compose(argv)
    seed = cfg.experiment.seed
    state = build_state(cfg, device)

    if cfg.experiment.run_mode == "test":
        state = restore_checkpoint(cfg.checkpoint.checkpoint_path, state,
                                   strict=cfg.checkpoint.strict_loading)
        test = dataset_split(cfg, "test", device)
        out = {"test/mse": float(nbody_eval_mse(state.model, test))}
        print(out)
        return out

    train = dataset_split(cfg, "train", device)
    valid = dataset_split(cfg, "valid", device)
    step = make_nbody_train_step()
    logger = MetricLogger(None)
    saver = (best_metric_saver(cfg.checkpoint.checkpoint_path, mode="min")
             if cfg.checkpoint.checkpoint_path else None)
    dropout = generator(seed, DROPOUT_STREAM, device)
    bs = cfg.experiment.batch_size
    n = train["loc"].shape[0]
    for epoch in range(cfg.experiment.num_epochs):
        perm = torch.randperm(n, generator=generator(seed, PERMUTATION_STREAM + epoch,
                                                     device), device=device)
        for i in range(n // bs):
            idx = perm[i * bs:(i + 1) * bs]
            state, metrics = step(state, {k: v[idx] for k, v in train.items()}, dropout)
            logger.update(metrics)
        val = float(nbody_eval_mse(state.model, valid))
        print(f"epoch {epoch}: {logger.flush(epoch)} val/mse={val:.6f}")
        if saver is not None:
            saver.maybe_save(val, state, cfg)
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
