"""MaskRCNNLite quality experiment: a converted ResNet-50 trunk on rectangles.

The port's counterpart of
`examples/images/segmentation/maskrcnn_lite_experiment.py`. It trains
`MaskRCNNLite(num_classes=2, max_instances=4, channels=64,
backbone="resnet50")` end to end, its trunk loaded through the torchvision
converter (`models.convert.convert_resnet_checkpoint`) from a randomly
initialised torchvision-layout ResNet-50 state dict (the tensors a
``resnet50().state_dict()`` file holds, drawn from a seeded
`torch.Generator` as the JAX script draws them: nothing is downloaded), on
the synthetic COCO rectangles (`data.coco.synthetic_coco_batch`), with
AdamW (optax's defaults: weight decay 1e-4). It then evaluates four fresh
batches: segm mAP (`mean_average_precision_segm`, COCO 101-point, IoU
.5:.95) and the mean best IoU of the detected boxes against each ground
truth, and writes the JSON record to `--out` (default
`checkpoints/maskrcnn_lite.json`, which git ignores):

    python -m equiadapt_tpu_torch.cli.maskrcnn_lite_experiment [--steps 600] [--out PATH]

The stated bar is the JAX script's: segm mAP >= 0.5 and det IoU >= 0.6;
the process exits 1 below it. `main(argv, device="cuda")` runs on the card
unless asked for the CPU and returns the record.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict

import torch

from equiadapt_tpu_torch.cli import generator
from equiadapt_tpu_torch.data.coco import synthetic_coco_batch
from equiadapt_tpu_torch.models.convert import convert_resnet_checkpoint
from equiadapt_tpu_torch.models.detection import (
    MaskRCNNLite,
    _box_iou,
    maskrcnn_lite_loss,
)
from equiadapt_tpu_torch.pipelines.segmentation import mean_average_precision_segm

SEED = 0
IMAGE = 96
BATCH = 16
PROMPTS = 4
STEPS = 600
LR = 3e-4
EVAL_BATCHES = 4
EVAL_STREAM = 10_000
BAR = {"segm_map": 0.5, "det_iou": 0.6}


def random_resnet50_state_dict(seed: int = SEED) -> Dict[str, torch.Tensor]:
    """A torchvision-layout ResNet-50 state dict of random tensors: He-scaled
    normal convolutions, identity BatchNorms, a zero head."""
    g = torch.Generator().manual_seed(seed)
    sd: Dict[str, torch.Tensor] = {}

    def conv(name, co, ci, k):
        sd[name] = torch.randn(co, ci, k, k, generator=g) * (2.0 / (ci * k * k)) ** 0.5

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = torch.ones(c)
        sd[f"{prefix}.bias"] = torch.zeros(c)
        sd[f"{prefix}.running_mean"] = torch.zeros(c)
        sd[f"{prefix}.running_var"] = torch.ones(c)
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)

    conv("conv1.weight", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for i, n in enumerate([3, 4, 6, 3]):
        width = 64 * 2 ** i
        cout = width * 4
        for j in range(n):
            p = f"layer{i + 1}.{j}"
            conv(f"{p}.conv1.weight", width, cin, 1)
            bn(f"{p}.bn1", width)
            conv(f"{p}.conv2.weight", width, width, 3)
            bn(f"{p}.bn2", width)
            conv(f"{p}.conv3.weight", cout, width, 1)
            bn(f"{p}.bn3", cout)
            if j == 0:
                conv(f"{p}.downsample.0.weight", cout, cin, 1)
                bn(f"{p}.downsample.1", cout)
            cin = cout
    sd["fc.weight"] = torch.zeros(1000, 2048)
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def build_model(device, seed: int = SEED) -> MaskRCNNLite:
    """The experiment's model, its trunk converted from
    `random_resnet50_state_dict(seed)`."""
    torch.manual_seed(seed + 1)
    model = MaskRCNNLite(num_classes=2, max_instances=PROMPTS, channels=64,
                         backbone="resnet50", device=device)
    model.backbone.load_state_dict(convert_resnet_checkpoint(
        random_resnet50_state_dict(seed), model.backbone.state_dict()))
    return model


def eval_metrics(model: MaskRCNNLite, batch) -> Dict[str, float]:
    """Segm mAP and the mean best IoU of the detected boxes against each
    valid ground-truth box, in eval mode."""
    with torch.no_grad():
        out = model(batch["image"], training=False)
    tg = batch["targets"]
    segm_map = mean_average_precision_segm(out["pred_masks"], out["det_scores"],
                                           tg["masks"], tg["valid"])
    iou = _box_iou(out["det_boxes"][:, :, None, :], tg["boxes"][:, None, :, :])
    best = iou.max(dim=1).values  # (B, N)
    det_iou = (best * tg["valid"]).sum() / torch.clamp(tg["valid"].sum(), min=1.0)
    return {"segm_map": float(segm_map), "det_iou": float(det_iou)}


def main(argv=(), device="cuda") -> Dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=STEPS)
    parser.add_argument("--out", default=os.path.join("checkpoints", "maskrcnn_lite.json"))
    args = parser.parse_args(list(argv))
    t_start = time.time()
    model = build_model(device)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=1e-4)
    draws = generator(SEED, 0, device)
    aux: Dict[str, torch.Tensor] = {}
    for step in range(args.steps):
        batch = synthetic_coco_batch(draws, BATCH, IMAGE, PROMPTS)
        out = model(batch["image"], batch["targets"]["boxes"], training=True)
        loss, aux = maskrcnn_lite_loss(out, batch["targets"])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        aux = {k: v.detach() for k, v in aux.items()}
        if step % 100 == 0:
            print(f"step {step}: " + " ".join(f"{k}={float(v):.4f}"
                                              for k, v in aux.items()), flush=True)

    # eval on fresh batches (held-out streams)
    folds = [eval_metrics(model, synthetic_coco_batch(
        generator(SEED, EVAL_STREAM + i, device), BATCH, IMAGE, PROMPTS))
        for i in range(EVAL_BATCHES)]
    segm_map = sum(f["segm_map"] for f in folds) / len(folds)
    det_iou = sum(f["det_iou"] for f in folds) / len(folds)
    dev = torch.device(device)
    result = {
        "experiment": "maskrcnn_lite_converted_backbone_quality",
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "seed": SEED,
        "config": {"image": IMAGE, "batch": BATCH, "prompts": PROMPTS,
                   "steps": args.steps, "lr": LR, "backbone": "resnet50 (converted)",
                   "num_classes": 2, "channels": 64},
        "final_train_losses": {k: round(float(v), 4) for k, v in aux.items()},
        "eval_segm_map_coco101": round(segm_map, 4),
        "eval_segm_map_per_fold": [round(f["segm_map"], 4) for f in folds],
        "eval_det_mean_best_iou": round(det_iou, 4),
        "bar": BAR,
        "passed": bool(segm_map >= BAR["segm_map"] and det_iou >= BAR["det_iou"]),
        "wall_s": round(time.time() - t_start, 1),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    sys.exit(0 if main(sys.argv[1:])["passed"] else 1)
