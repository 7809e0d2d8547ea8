"""Instance-segmentation pipeline: images and targets canonicalized together,
a promptable model, the masks mapped back.

Counterpart of `equiadapt_tpu/pipelines/segmentation.py`. The canonicalizer
transforms images and targets (boxes, masks) together, batched; the
promptable model (`models.segmentation.SAMLite`, or SAM ViT-B,
`models.sam.SamModel`) predicts masks from the canonical boxes;
`invert_masks` maps predicted masks back to the input frame (scalar
induced rep: kernel K1 on their view of NCHW memory for a discrete
canonicalizer). `serve` is the serving call: images and box prompts in,
input-frame mask logits and predicted IoU out. `detect` is a detector's
(`models.maskrcnn.MaskRCNN`): images in, input-frame boxes, scores,
labels and thresholded masks out. Task loss: 20 focal + dice
+ MSE of the predicted against the achieved IoU; the prior regularization
drives the canonicalizer (BASELINE config 5, prior weight 100).

The train state is the port's `TrainState` with one AdamW over every
parameter (optax's `adamw(lr)`, weight decay 1e-4, as the JAX CLI builds
it); the step updates it in place. `mean_average_precision_segm` is COCO's
single-class segm AP (score-ranked greedy matching, 101-point interpolated
precision), walked rank by rank as the JAX package's `lax.scan` walks it,
all thresholds at once.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from equiadapt_tpu_torch.common.info import (
    IdentityCanonicalizationInfo,
    prior_regularization_loss,
)
from equiadapt_tpu_torch.models.segmentation import calc_iou, dice_loss, focal_loss
from equiadapt_tpu_torch.ops.boxes import flip_boxes, flip_masks, rotate_boxes, rotate_masks
from equiadapt_tpu_torch.ops.warp import _residual_rotate, hflip
from equiadapt_tpu_torch.pipelines.classification import TrainState
from equiadapt_tpu_torch.utils.profiling import annotate

Tensor = torch.Tensor

THRESHOLDS = (0.5, 0.55, 0.6, 0.65, 0.7, 0.75, 0.8, 0.85, 0.9, 0.95)
MASK_THRESHOLD = 0.5  # a detector's mask probabilities to its served masks

__all__ = [
    "ImageSegmentationPipeline",
    "segmentation_task_loss",
    "make_segmentation_train_step",
    "create_segmentation_state",
    "segmentation_group_inference",
    "mask_iou_map_metric",
    "mean_average_precision_segm",
]


class ImageSegmentationPipeline(nn.Module):
    """canonicalize(images, targets) -> promptable predict -> invert masks."""

    def __init__(self, canonicalizer: nn.Module, prediction_network: nn.Module):
        super().__init__()
        self.canonicalizer = canonicalizer
        self.prediction_network = prediction_network

    def forward(self, images: Tensor, targets: Dict[str, Tensor],
                training: bool = False,
                generator: Optional[torch.Generator] = None):
        """images: (B, H, W, 3); targets: boxes (B, N, 4), masks
        (B, N, H, W), labels (B, N), valid (B, N) {0, 1} (padded prompt
        slots). Returns ((images_c, targets_c, pred_masks, ious), info)."""
        images_c, targets_c, info = self.canonicalizer(
            images, targets, training=training, generator=generator)
        pred_masks, ious = self.prediction_network(
            images_c, targets_c["boxes"], training=training, generator=generator)
        return (images_c, targets_c, pred_masks, ious), info

    def serve(self, images: Tensor, boxes: Tensor) -> Tuple[Tensor, Tensor, object]:
        """The serving call: images (B, H, W, 3) and their box prompts
        (B, N, 4) xyxy canonicalized together (no masks), the prediction
        network run on the canonical pair, its mask logits mapped back to
        the input frame (`invert_masks`). Returns (mask logits (B, N, H, W),
        predicted IoU (B, N), info). Spans: `pipeline`, with the
        canonicalizer's and `predict` inside it."""
        with annotate("pipeline"):
            images_c, targets_c, info = self.canonicalizer(
                images, {"boxes": boxes}, training=False)
            with annotate("predict"):
                masks, ious = self.prediction_network(images_c, targets_c["boxes"])
            return self.invert_masks(info, masks), ious, info

    def detect(self, images: Tensor,
               return_probs: bool = False) -> Tuple[Dict[str, Tensor], object]:
        """The serving call of a detector (`models.maskrcnn.MaskRCNN`):
        images (B, H, W, 3) canonicalized, the detector run on the canonical
        images, its masks pasted into the canonical frame, and the boxes
        (`invert_boxes`) and masks (`invert_masks`) mapped back to the input
        frame. Returns ({"boxes" (B, D, 4) fp32, "scores" (B, D), "labels"
        (B, D), "valid" (B, D), "masks" (B, D, H, W) uint8: the inverted
        probabilities above `MASK_THRESHOLD`, 0.5; with `return_probs` also
        "probs", those probabilities (fp32)}, info). Slots past the
        detections that survive have score 0, `valid` False and zero masks.
        Spans: `pipeline`, with the canonicalizer's and `predict` (the
        detector's and `maskrcnn/paste`) inside it; no host sync past the
        canonicalizer."""
        with annotate("pipeline"):
            images_c, info = self.canonicalizer(images, None, training=False)
            with annotate("predict"):
                net = self.prediction_network
                det = net(images_c)
                probs = net.paste_masks(det.pop("mask_probs"), det["boxes"],
                                        tuple(images.shape[1:3]))
            probs = self.invert_masks(info, probs)
            out = {"boxes": self.invert_boxes(info, det["boxes"], images.shape[2]),
                   "scores": det["scores"], "labels": det["labels"], "valid": det["valid"],
                   "masks": (probs > MASK_THRESHOLD).to(torch.uint8)}
            if return_probs:
                out["probs"] = probs
            return out, info

    def invert_boxes(self, info, boxes: Tensor, width: int) -> Tensor:
        """(B, N, 4) canonical-frame xyxy boxes -> the input frame: turned by
        the element's inverse angle (`ops.boxes.rotate_boxes`), then
        flipped where the element reflects (the inverse of
        `_canonicalize_targets`)."""
        element = info.element
        boxes = rotate_boxes(boxes, -element.rotation_deg, width)
        if getattr(element, "reflection", None) is not None:
            r = element.reflection[:, None, None].to(boxes.dtype)
            boxes = (1.0 - r) * boxes + r * flip_boxes(boxes, width)
        return boxes

    def invert_masks(self, info, masks: Tensor) -> Tensor:
        """(B, N, H, W) canonical-frame masks -> the input frame (scalar
        induced rep)."""
        out = self.canonicalizer.invert_canonicalization(
            info, masks.movedim(1, -1), induced_rep_type="scalar")
        return out.movedim(-1, 1)


def segmentation_task_loss(pred_masks: Tensor, ious: Tensor,
                           targets: Dict[str, Tensor]) -> Tuple[Tensor, Dict[str, Tensor]]:
    """20 focal + dice + MSE(predicted IoU, achieved IoU) over the valid
    prompts; padded prompts are masked out of both sides."""
    gt = targets["masks"].float()
    valid = targets.get("valid")
    if valid is None:
        valid = torch.ones(pred_masks.shape[:2], dtype=pred_masks.dtype,
                           device=pred_masks.device)
    w = valid[..., None, None]
    f = focal_loss(pred_masks * w, gt * w)
    d = dice_loss(pred_masks * w - (1 - w) * 1e4, gt * w)
    iou_gt = calc_iou(pred_masks, gt)
    n = torch.clamp(valid.sum(), min=1.0)
    iou_mse = torch.sum(((ious - iou_gt) ** 2) * valid) / n
    loss = 20.0 * f + d + iou_mse
    return loss, {
        "loss/focal": f,
        "loss/dice": d,
        "loss/iou_mse": iou_mse,
        "metric/mean_iou": torch.sum(iou_gt * valid) / n,
    }


def create_segmentation_state(pipeline: ImageSegmentationPipeline,
                              learning_rate: float = 8e-4,
                              weight_decay: float = 1e-4) -> TrainState:
    """A `TrainState` at step 0 with one AdamW over every parameter."""
    opt = torch.optim.AdamW(pipeline.parameters(), lr=learning_rate,
                            weight_decay=weight_decay)
    return TrainState(model=pipeline, optimizers=[opt])


def make_segmentation_train_step(prior_weight: float = 100.0):
    """train_step(state, batch, generator=None) -> (state, metrics): the
    prior-regularized finetuning step. The forward runs with training=True
    (the canonicalizer's straight-through selection and one-hot warp blend,
    so the loss reaches its network through the image and the targets),
    then the task loss plus `prior_weight` times the prior, its backward
    and one optimizer step."""

    def train_step(state: TrainState, batch: Dict[str, Tensor],
                   generator: Optional[torch.Generator] = None):
        for opt in state.optimizers:
            opt.zero_grad(set_to_none=True)
        (_, targets_c, pred_masks, ious), info = state.model(
            batch["image"], batch["targets"], training=True, generator=generator)
        loss, metrics = segmentation_task_loss(pred_masks, ious, targets_c)
        if prior_weight and not isinstance(info, IdentityCanonicalizationInfo):
            prior = prior_regularization_loss(info)
            loss = loss + prior_weight * prior
            metrics["loss/prior"] = prior
        metrics["loss/total"] = loss
        metrics["loss/finite"] = torch.isfinite(loss).float()
        loss.backward()
        state.apply_gradients()
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def segmentation_group_inference(model: ImageSegmentationPipeline,
                                 batch: Dict[str, Tensor], *,
                                 num_rotations: int = 4,
                                 group_type: str = "rotation") -> Dict[str, Tensor]:
    """Per-group-element mAP sweep: the images and their targets are taken
    through each element (the image by a static rotation, border fill; the
    masks by the bilinear rotate, zeros fill; then the hflip for the
    reflection coset), each copy goes through the pipeline in eval, and the
    mAP of each element and their mean are reported."""
    x, targets = batch["image"], batch["targets"]
    B, H, W, _ = x.shape
    degrees = np.linspace(0.0, 360.0, num_rotations + 1)[:num_rotations].tolist()
    reflections = (0, 1) if group_type == "roto-reflection" else (0,)
    results, maps = {}, []
    for refl in reflections:
        for g, deg in enumerate(degrees):
            ang = torch.full((B,), -deg, device=x.device)
            xi = hflip(x) if refl else x
            xi = _residual_rotate(xi, -deg, "border", "exact")
            boxes, masks = targets["boxes"], targets["masks"]
            if refl:
                boxes, masks = flip_boxes(boxes, W), flip_masks(masks)
            ti = {**targets, "boxes": rotate_boxes(boxes, -ang, W),
                  "masks": rotate_masks(masks, ang)}
            with torch.no_grad():
                (_, tc, pred_masks, ious), _ = model(xi, ti, training=False)
            m = mean_average_precision_segm(pred_masks, ious, tc["masks"], tc["valid"])
            results[f"test/map_element_{g + refl * num_rotations}"] = m
            maps.append(m)
    results["test/group_map"] = torch.mean(torch.stack(maps))
    results["test/map"] = maps[0]
    return results


def mask_iou_map_metric(pred_masks: Tensor, scores: Tensor, gt_masks: Tensor,
                        valid: Tensor, thresholds: Sequence[float] = THRESHOLDS) -> Tensor:
    """Mean over IoU thresholds of the share of valid prompts whose mask IoU
    (logits > 0) exceeds the threshold; prompts give the matching."""
    ious = calc_iou(pred_masks, gt_masks.float())
    n = torch.clamp(valid.sum(), min=1.0)
    return torch.mean(torch.stack([torch.sum((ious > t) * valid) / n
                                   for t in thresholds]))


def _pairwise_mask_iou(pred: Tensor, gt: Tensor) -> Tensor:
    """(B, Np, H, W) x (B, Ng, H, W) -> (B, Np, Ng) IoU of masks > 0.5."""
    p = (pred > 0.5).float().reshape(pred.shape[0], pred.shape[1], -1)
    g = (gt > 0.5).float().reshape(gt.shape[0], gt.shape[1], -1)
    inter = torch.einsum("bpx,bgx->bpg", p, g)
    union = p.sum(-1)[:, :, None] + g.sum(-1)[:, None, :] - inter
    return inter / torch.clamp(union, min=1e-7)


def mean_average_precision_segm(pred_masks: Tensor, scores: Tensor, gt_masks: Tensor,
                                valid: Tensor,
                                thresholds: Sequence[float] = THRESHOLDS) -> Tensor:
    """COCO-style single-class segm mAP: predictions ranked by score (a
    stable sort, padded slots last), each greedily matched to its image's
    best unmatched ground truth of IoU >= t; the 101-point interpolated
    precision, averaged over the thresholds.

    Args:
        pred_masks: (B, N, H, W) predicted masks (probabilities, or logits
            compared at 0.5).
        scores: (B, N) confidence of each prediction.
        gt_masks: (B, N, H, W) ground-truth masks.
        valid: (B, N) 1 where the slot is real (for the prediction and the
            ground truth alike).
    """
    B, Np = scores.shape
    dev = scores.device
    iou_mat = _pairwise_mask_iou(pred_masks, gt_masks)  # (B, Np, Ng)
    Ng = iou_mat.shape[-1]
    v = valid.float()
    flat = torch.where(v > 0, scores.float(),
                       torch.tensor(float("-inf"), device=dev)).reshape(-1)
    order = torch.argsort(-flat, stable=True)
    img_of = order // Np
    pred_valid = v.reshape(-1)[order] > 0
    rows = iou_mat[img_of, order % Np]  # (R, Ng): IoU rows in rank order
    gt_valid = v[img_of] > 0  # (R, Ng)
    t = torch.tensor(thresholds, dtype=torch.float32, device=dev)[:, None]  # (T, 1)
    T = t.shape[0]
    matched = torch.zeros(T, B * Ng, device=dev)
    lanes = torch.arange(T, device=dev)
    tps = []
    for r in range(B * Np):  # greedy matching, rank by rank
        base = img_of[r] * Ng
        taken = matched.index_select(1, base + torch.arange(Ng, device=dev))
        cand = (rows[r] >= t) & (taken < 0.5) & gt_valid[r]  # (T, Ng)
        best = torch.argmax(torch.where(cand, rows[r], -1.0), dim=-1)
        tp = cand.any(dim=-1) & pred_valid[r]
        matched.index_put_((lanes, base + best), tp.float(), accumulate=True)
        tps.append(tp.float())
    cum_tp = torch.cumsum(torch.stack(tps, dim=1), dim=1)  # (T, R)
    ranks = torch.cumsum(pred_valid.float(), dim=0)
    precision = cum_tp / torch.clamp(ranks, min=1.0)
    recall = cum_tp / torch.clamp(v.sum(), min=1.0)
    recall_pts = torch.arange(101, dtype=torch.float32, device=dev) / 100.0
    hit = (recall[:, None, :] >= recall_pts[None, :, None]) & pred_valid
    prec_at = torch.amax(torch.where(hit, precision[:, None, :], 0.0), dim=-1)
    return torch.mean(torch.mean(prec_at, dim=-1))
