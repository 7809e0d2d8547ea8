"""Segmentation serving CLI: box-prompted masks through the canonicalizer in
the serving configuration.

The segmentation counterpart of `cli.classification_serve`. The config is
composed from `examples/images/segmentation/configs/default.yaml`
(BASELINE config 5: the C4 GCNN canonicalizer, 1024 px), then this CLI's
defaults, SAM ViT-B (`prediction.architecture=sam_vit_b`,
`models.sam.SamModel`) and batches of 8 images with 8 box prompts each,
then the command line. `build_serving_pipeline`
applies fast warps and bf16 compute to the canonicalizer (its canonical
images handed on in bf16) and `prediction.dtype=bfloat16` to every model that
takes a dtype, and reads `prediction.architecture` (`sam_vit_b`, the SAMLite
variants `sam` and `sam_vit`, which compute in fp32, or the detector
`maskrcnn_resnet50_fpn`, `models.maskrcnn.MaskRCNN`, served through
`ImageSegmentationPipeline.detect`: images in, input-frame boxes, labels,
scores and uint8 masks out). Weights are fresh from the seed. One
untimed warm-up call on the fixed batch shape builds the kernels and runs
cuDNN's autotuning; then five synthetic batches (`synthetic_coco_batch`)
are served through `ImageSegmentationPipeline.serve` (a detector: `detect`) and the throughput is
printed:

    python -m equiadapt_tpu_torch.cli.segmentation_serve
    python -m equiadapt_tpu_torch.cli.segmentation_serve experiment.profile=true

`experiment.profile=true` traces the five batches into
`experiment.profile_dir` and prints the program's spans (`pipeline`,
`canon/*`, `predict`, `sam/*`), the idle time by span and the counters
(`utils.profiling.profile_report`). `main(argv, device="cuda")` runs on
the card unless asked for the CPU; it returns {"images_per_s",
"warmup_s", "pipeline"}.
"""

from __future__ import annotations

import os
import sys
import time

import torch

from equiadapt_tpu_torch.cli import generator
from equiadapt_tpu_torch.cli.segmentation_train import CONFIG_DIR
from equiadapt_tpu_torch.data.coco import synthetic_coco_batch
from equiadapt_tpu_torch.pipelines.segmentation import ImageSegmentationPipeline
from equiadapt_tpu_torch.utils.config import Config, compose_config
from equiadapt_tpu_torch.utils.profiling import profile_report, profile_trace
from equiadapt_tpu_torch.utils.registry import (
    get_image_canonicalization_network,
    get_image_canonicalizer,
    get_segmentation_prediction_network,
)

NUM_BATCHES = 5
PROMPTS = 8
# config 5's file, then this CLI's model and batch; the command line wins
DEFAULTS = [f"config={os.path.join(CONFIG_DIR, 'default.yaml')}",
            "prediction.architecture=sam_vit_b", "experiment.batch_size=8"]
PROMPTABLE = ("sam", "sam_vit", "sam_vit_b")
DETECTORS = ("maskrcnn_resnet50_fpn",)


def build_serving_pipeline(cfg: Config, device, **model_kw) -> ImageSegmentationPipeline:
    """The pipeline of `cfg` with fast warps and bf16 compute, weights drawn
    from the run's seed; `model_kw` goes to the prediction network's factory
    (`SamModel`'s widths, ViT-B's by default)."""
    cfg = cfg.override(
        "canonicalization.warp_mode=fast",
        "canonicalization.compute_dtype=bfloat16",
        "canonicalization.output_dtype=compute",
        "prediction.dtype=bfloat16",
    )
    arch = cfg.prediction.architecture
    if arch not in PROMPTABLE + DETECTORS:
        raise ValueError(f"{arch} is neither a promptable segmentation network nor a "
                         f"detector")
    torch.manual_seed(cfg.experiment.seed)
    size = cfg.dataset.image_size
    in_shape = (size, size, 3)
    net = get_image_canonicalization_network(cfg.canonicalization, in_shape, device=device)
    canon = get_image_canonicalizer(cfg.canonicalization, net, in_shape, device=device)
    net = get_segmentation_prediction_network(arch, size, device=device,
                                              dtype=getattr(torch, cfg.prediction.dtype),
                                              **model_kw)
    return ImageSegmentationPipeline(canonicalizer=canon, prediction_network=net).eval()


def main(argv, device="cuda"):
    cfg = compose_config(DEFAULTS + list(argv), config_dir=CONFIG_DIR)
    pipe = build_serving_pipeline(cfg, device)
    B, size, seed = cfg.experiment.batch_size, cfg.dataset.image_size, cfg.experiment.seed

    detector = cfg.prediction.architecture in DETECTORS

    def batch(i):
        b = synthetic_coco_batch(generator(seed, i, device), B, image_size=size,
                                 num_prompts=PROMPTS)
        return (b["image"],) if detector else (b["image"], b["targets"]["boxes"])

    def serve(*args):  # the served call, and a result to wait for
        if detector:
            out, _ = pipe.detect(*args)
            return out["scores"]
        return pipe.serve(*args)[1]

    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True  # one batch shape: autotune once
    try:
        with torch.no_grad():
            t0 = time.perf_counter()
            float(serve(*batch(0)).sum())  # waits for the device
            warmup = time.perf_counter() - t0
            what = "detections" if detector else f"{PROMPTS} boxes"
            print(f"warm-up: {warmup:.1f}s (batch {B} x {what} @ {size}px)")
            inputs = [batch(1 + i) for i in range(NUM_BATCHES)]
            with profile_trace(cfg.experiment.profile_dir, enabled=cfg.experiment.profile):
                t0 = time.perf_counter()
                for args in inputs:
                    last = serve(*args)
                float(last.sum())  # waits for the device
                dt = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.benchmark = benchmark
    rate = NUM_BATCHES * B / dt
    print(f"served {NUM_BATCHES} batches: {rate:.1f} images/s")
    if cfg.experiment.profile:
        print(f"profile trace written to {cfg.experiment.profile_dir}")
        for line in profile_report(cfg.experiment.profile_dir):
            print(line)
    return {"images_per_s": rate, "warmup_s": warmup, "pipeline": pipe}


if __name__ == "__main__":
    main(sys.argv[1:])
