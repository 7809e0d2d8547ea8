"""Batch-serving CLI: canonicalized inference in the serving configuration.

The port's counterpart of `examples/images/classification/serve.py`. It
builds the pipeline with fast warps and bf16 compute, loads the weights
of an explicitly named checkpoint (non-strict: the module's tensors only,
so a checkpoint written by the training CLI, with its optimizers, serves)
or serves fresh weights, runs one untimed warm-up call on the fixed batch
shape (`warm-up: ...s`; it builds the kernels and runs cuDNN's autotuning
in place of the JAX package's ahead-of-time compile), then streams five
synthetic batches and prints the throughput:

    python -m equiadapt_tpu_torch.cli.classification_serve \\
        config=examples/images/classification/configs/serving_bf16.yaml \\
        dataset.image_size=224

Overrides as in `classification_train`; with a checkpoint path, its saved
config is the starting point. `--export=PATH` also writes the serving
forward (`pipeline(x)[0]`, the logits) at the served batch shape as a
`torch.export` artifact (`utils.export.export_apply`; the JAX CLI writes
StableHLO) and prints its size; it keeps the hand kernels' launches and
runs on the device it was exported on (load it with
`utils.export.load_exported` after importing `equiadapt_tpu_torch`).
`main(argv, device="cuda")` runs on the card unless asked for the CPU; it
returns {"images_per_s", "warmup_s", "pipeline", "export_bytes"} (the
pipeline it served; the artifact's size, or None).
"""

from __future__ import annotations

import sys
import time

import torch

from equiadapt_tpu_torch.cli import generator
from equiadapt_tpu_torch.cli.classification_train import CONFIG_DIR, build_pipeline
from equiadapt_tpu_torch.data import synthetic_image_batch
from equiadapt_tpu_torch.pipelines.classification import (
    ImageClassifierPipeline,
    create_train_state,
)
from equiadapt_tpu_torch.utils.checkpoint import restore_checkpoint, restore_config
from equiadapt_tpu_torch.utils.config import Config, compose_config
from equiadapt_tpu_torch.utils.export import export_apply

NUM_BATCHES = 5


def build_serving_pipeline(cfg: Config, device) -> ImageClassifierPipeline:
    """The pipeline of `cfg` with fast warps and bf16 compute."""
    return build_pipeline(cfg.override(
        "canonicalization.warp_mode=fast",
        "canonicalization.compute_dtype=bfloat16",
        "prediction.dtype=bfloat16",
    ), device)


def main(argv, device="cuda"):
    argv = list(argv)
    export_path = next((a.split("=", 1)[1] for a in argv if a.startswith("--export=")),
                       None)
    argv = [a for a in argv if not a.startswith("--export=")]
    cfg = compose_config(argv, config_dir=CONFIG_DIR)
    # restore only from a checkpoint the user named (the default path must
    # not pick up a stray directory)
    explicit_ckpt = any(a.startswith("checkpoint.checkpoint_path=") for a in argv)
    if explicit_ckpt:
        try:
            cfg = compose_config(argv, config_dir=CONFIG_DIR,
                                 start=restore_config(cfg.checkpoint.checkpoint_path))
        except FileNotFoundError:
            pass
    pipe = build_serving_pipeline(cfg, device)
    if explicit_ckpt:
        try:
            restore_checkpoint(cfg.checkpoint.checkpoint_path,
                               create_train_state(pipe, ([], [])), strict=False)
            print("serving checkpoint weights")
        except FileNotFoundError:
            print("no checkpoint found; serving fresh weights")

    B, size = cfg.experiment.batch_size, cfg.dataset.image_size
    seed = cfg.experiment.seed

    def batch(i):
        return synthetic_image_batch(generator(seed, i, device), B, size=size,
                                     channels=cfg.dataset.in_channels,
                                     num_classes=cfg.dataset.num_classes)["image"]

    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True  # one batch shape: autotune once
    try:
        with torch.no_grad():
            x = batch(0)
            t0 = time.perf_counter()
            logits, _ = pipe(x, training=False)
            float(logits.float().sum())  # waits for the device
            warmup = time.perf_counter() - t0
            print(f"warm-up: {warmup:.1f}s (batch {B} @ {size}px)")
            export_bytes = None
            if export_path:
                blob = export_apply(lambda p, xb: p(xb, training=False)[0], pipe, x)
                with open(export_path, "wb") as f:
                    f.write(blob)
                export_bytes = len(blob)
                print(f"exported torch.export artifact: {export_path} "
                      f"({export_bytes} bytes)")
            t0 = time.perf_counter()
            for i in range(NUM_BATCHES):
                logits, _ = pipe(batch(1 + i), training=False)
            float(logits.float().sum())  # waits for the device
            dt = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.benchmark = benchmark
    rate = NUM_BATCHES * B / dt
    print(f"served {NUM_BATCHES} batches: {rate:.1f} images/s")
    return {"images_per_s": rate, "warmup_s": warmup, "pipeline": pipe,
            "export_bytes": export_bytes}


if __name__ == "__main__":
    main(sys.argv[1:])
