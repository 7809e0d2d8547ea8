"""MaskRCNNLite: static-shape detection and instance masks, NHWC in.

Counterpart of `equiadapt_tpu/models/detection.py`, the JAX package's
redesign of the reference's torchvision ``maskrcnn_resnet50_fpn`` wrapper
(reference examples/images/segmentation/model_utils.py:14-97) with the same
pipeline contract and static shapes:

* a trunk: the small from-scratch conv FPN ("lite") or a torchvision-layout
  ResNet-50 (stages C3 / C4 and a lateral merge; its `backbone` submodule
  takes converted pretrained weights through `models.convert`);
* a dense anchor-free head (FCOS-style): objectness, class logits and
  distances to the box edges at every location;
* the top-K locations by objectness as detections (a stable descending
  sort, so ties go to the lower index, as `lax.top_k` decides them), with
  the scores' validity mask standing in for torchvision's score threshold;
* masks: ground-truth boxes (training) or the detected boxes (inference)
  prompt the `PromptEncoderLite` / `MaskDecoderLite` of `models.segmentation`.

`maskrcnn_lite_loss` is the torchvision loss dict's analog: focal
objectness, IoU box regression and cross-entropy classification at the
location holding each instance's centre, and the masks' focal and dice
losses.

Submodules carry the names Flax gives their counterparts (`_FPNLite_0`,
`backbone`, `Conv_{i}` in creation order, `PromptEncoderLite_0`,
`MaskDecoderLite_0`), so `utils.jax_weights` carries weights across.
Convolutions run in NCHW inside; outputs are laid out as the JAX module's.
The module runs no hand kernel: the JAX package has none on this path.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from equiadapt_tpu_torch.common.layers import BatchNorm
from equiadapt_tpu_torch.models.resnet import ResNet50
from equiadapt_tpu_torch.models.segmentation import (
    MaskDecoderLite,
    PromptEncoderLite,
    dice_loss,
    focal_loss,
)
from equiadapt_tpu_torch.ops.warp import _resize_nearest, resize

Tensor = torch.Tensor

__all__ = ["MaskRCNNLite", "maskrcnn_lite_loss", "decode_boxes"]


def decode_boxes(centers: Tensor, ltrb: Tensor) -> Tensor:
    """(cx, cy) + (l, t, r, b) distances -> xyxy boxes."""
    cx, cy = centers[..., 0], centers[..., 1]
    l, t, r, b = ltrb[..., 0], ltrb[..., 1], ltrb[..., 2], ltrb[..., 3]
    return torch.stack([cx - l, cy - t, cx + r, cy + b], dim=-1)


# the nearest resize of an NCHW map's (H, W), as `jax.image.resize(..., "nearest")`
_upsample_nearest = functools.partial(_resize_nearest, dims=(2, 3))


class _FPNLite(nn.Module):
    """Two-level feature pyramid from a small conv trunk (NCHW)."""

    def __init__(self, channels: int = 128, device="cuda"):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, 64, 3, 2, 1, device=device)
        self.BatchNorm_0 = BatchNorm(64, momentum=0.99, epsilon=1e-5, device=device)
        self.Conv_1 = nn.Conv2d(64, channels, 3, 2, 1, device=device)
        self.Conv_2 = nn.Conv2d(channels, channels, 3, 2, 1, device=device)
        self.Conv_3 = nn.Conv2d(channels, channels, 3, 1, 1, device=device)

    def forward(self, x: Tensor, training: bool = False) -> Tensor:
        h = F.relu(self.BatchNorm_0(self.Conv_0(x), training))
        c3 = F.relu(self.Conv_1(h))
        c4 = F.relu(self.Conv_2(c3))
        # top-down merge back to c3's stride
        return self.Conv_3(c3 + _upsample_nearest(c4, tuple(c3.shape[-2:])))


class MaskRCNNLite(nn.Module):
    """Detector and promptable mask head with static top-K instances.

    Args:
        num_classes: class logits per location.
        max_instances: K, the detections (and inference prompts) per image.
        channels: the pyramid's, head's and decoder's width.
        decoder_depth, num_heads: the mask decoder's.
        backbone: "lite" (`_FPNLite`) or "resnet50" (stages 1-2 of a
            torchvision-layout ResNet-50, stride 8, and a lateral merge).
        score_threshold: detections whose sigmoid score is below it are
            zeroed (boxes, labels, scores) and their masks pushed to -1e4.
    """

    def __init__(self, num_classes: int = 91, max_instances: int = 8,
                 channels: int = 128, decoder_depth: int = 1, num_heads: int = 4,
                 backbone: str = "lite", score_threshold: float = 0.05,
                 device="cuda"):
        super().__init__()
        self.num_classes, self.max_instances = num_classes, max_instances
        self.score_threshold = score_threshold
        self.trunk = backbone
        C = channels
        convs = []  # (in, out, kernel) in Flax's creation order
        if backbone == "resnet50":
            self.backbone = ResNet50(num_classes=None, return_stages=True, device=device)
            convs += [(512, C, 1), (1024, C, 1), (C, C, 3)]  # lateral p3, p4; merge
        elif backbone == "lite":
            self._FPNLite_0 = _FPNLite(C, device=device)
        else:
            raise ValueError(f"unknown MaskRCNNLite backbone {backbone!r}")
        self._head = len(convs)
        convs += [(C, C, 3), (C, C, 3), (C, 1, 3), (C, num_classes, 3), (C, 4, 3)]
        for i, (cin, cout, k) in enumerate(convs):
            setattr(self, f"Conv_{i}", nn.Conv2d(cin, cout, k, padding=k // 2,
                                                 device=device))
        self.PromptEncoderLite_0 = PromptEncoderLite(C, device=device)
        self.MaskDecoderLite_0 = MaskDecoderLite(C, decoder_depth, num_heads,
                                                 device=device)

    def _conv(self, i: int) -> nn.Module:
        return getattr(self, f"Conv_{i}")

    def _features(self, images: Tensor, training: bool) -> Tensor:
        """The pyramid's stride-4 ("lite") or stride-8 map, NCHW."""
        if self.trunk == "lite":
            return self._FPNLite_0(images.permute(0, 3, 1, 2), training)
        stages = self.backbone(images, training)  # NCHW, strides 4 .. 32
        p3 = self._conv(0)(stages[1])
        p4 = self._conv(1)(stages[2])
        return self._conv(2)(p3 + _upsample_nearest(p4, tuple(p3.shape[-2:])))

    def forward(self, images: Tensor, boxes: Optional[Tensor] = None,
                training: bool = False) -> Dict[str, Tensor]:
        """images: (B, H, W, 3); boxes: optional (B, N, 4) ground-truth
        prompts. Returns the dense head's outputs (for the losses), the top-K
        detections (boxes, scores, labels, validity) and the instance mask
        logits at image resolution (B, N or K, H, W)."""
        B, H, W, _ = images.shape
        feat = self._features(images, training)
        h, w = feat.shape[-2:]
        stride = H // h

        head = feat
        for i in (self._head, self._head + 1):
            head = F.relu(self._conv(i)(head))
        obj_logits = self._conv(self._head + 2)(head)[:, 0]  # (B, h, w)
        cls_logits = self._conv(self._head + 3)(head).permute(0, 2, 3, 1)
        ltrb = F.relu(self._conv(self._head + 4)(head)).permute(0, 2, 3, 1) * stride * 4.0

        ys = (torch.arange(h, dtype=feat.dtype, device=feat.device) + 0.5) * stride
        xs = (torch.arange(w, dtype=feat.dtype, device=feat.device) + 0.5) * stride
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        centers = torch.stack([gx, gy], dim=-1)  # (h, w, 2)
        dense_boxes = decode_boxes(centers[None], ltrb)  # (B, h, w, 4)

        # static top-K proposals: a stable descending sort keeps ties in
        # index order
        scores, idx = torch.sort(obj_logits.reshape(B, h * w), dim=-1,
                                 descending=True, stable=True)
        scores, idx = scores[:, :self.max_instances], idx[:, :self.max_instances]
        det_boxes = torch.take_along_dim(dense_boxes.reshape(B, h * w, 4),
                                         idx[..., None], dim=1)
        det_labels = torch.argmax(torch.take_along_dim(
            cls_logits.reshape(B, h * w, self.num_classes), idx[..., None], dim=1),
            dim=-1).to(torch.int32)

        prompts = boxes if boxes is not None else det_boxes
        sparse = self.PromptEncoderLite_0(prompts, (H, W))
        low_res, ious = self.MaskDecoderLite_0(feat.permute(0, 2, 3, 1), sparse,
                                               training)
        # bilinear upsample, half-pixel centres (jax.image.resize "linear")
        masks = resize(low_res.movedim(1, -1), (H, W)).movedim(-1, 1)

        # the empty-prediction fallback, branch-free: detections below the
        # score threshold are zeroed (slots stay score-ranked)
        det_scores = torch.sigmoid(scores)
        det_valid = (det_scores >= self.score_threshold).to(det_scores.dtype)
        det_boxes = det_boxes * det_valid[..., None]
        det_labels = det_labels * det_valid.to(det_labels.dtype)
        det_scores = det_scores * det_valid
        if boxes is None:
            masks = masks + torch.where(
                det_valid[..., None, None] > 0, 0.0, -1e4).to(masks.dtype)

        return {
            "obj_logits": obj_logits,
            "cls_logits": cls_logits,
            "dense_boxes": dense_boxes,
            "det_boxes": det_boxes,
            "det_scores": det_scores,
            "det_labels": det_labels,
            "det_valid": det_valid,
            "pred_masks": masks,
            "ious": ious,
            "stride": stride,
        }


def _box_iou(a: Tensor, b: Tensor) -> Tensor:
    """IoU of aligned box tensors (..., 4)."""
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    inter = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)
    return inter / torch.clamp(area_a + area_b - inter, min=1e-6)


def maskrcnn_lite_loss(outputs: Dict[str, Tensor],
                       targets: Dict[str, Tensor]) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Dense detection and mask losses (the torchvision loss dict's analog).

    Matching: each ground-truth instance goes to the feature location that
    holds its centre (centre sampling, FCOS's simplification of RPN
    matching)."""
    obj = outputs["obj_logits"]  # (B, h, w)
    B, h, w = obj.shape
    stride = outputs["stride"]
    boxes, valid = targets["boxes"], targets["valid"]  # (B, N, 4), (B, N)

    cx = (boxes[..., 0] + boxes[..., 2]) / 2.0
    cy = (boxes[..., 1] + boxes[..., 3]) / 2.0
    ix = (cx / stride).to(torch.int32).clamp(0, w - 1)
    iy = (cy / stride).to(torch.int32).clamp(0, h - 1)
    flat_idx = (iy * w + ix).long()  # (B, N)

    # the objectness target grid: 1 at each valid instance's centre
    obj_t = torch.zeros(B, h * w, dtype=obj.dtype, device=obj.device).scatter_reduce(
        1, flat_idx, valid.to(obj.dtype), reduce="amax", include_self=True)
    obj_loss = focal_loss(obj.reshape(B, h * w), obj_t)

    # box regression at the matched centres
    pred_boxes = torch.take_along_dim(outputs["dense_boxes"].reshape(B, h * w, 4),
                                      flat_idx[..., None], dim=1)
    iou = _box_iou(pred_boxes, boxes)
    count = torch.clamp(valid.sum(), min=1.0)
    box_loss = torch.sum((1.0 - iou) * valid) / count

    # classification at the matched centres
    pred_cls = torch.take_along_dim(outputs["cls_logits"].reshape(B, h * w, -1),
                                    flat_idx[..., None], dim=1)
    cls_ce = -F.log_softmax(pred_cls, dim=-1)
    labels = targets["labels"].long()
    cls_loss = torch.sum(torch.take_along_dim(cls_ce, labels[..., None], dim=-1)[..., 0]
                         * valid) / count

    # mask losses on the prompted instances
    gt_masks = targets["masks"].float()
    vmask = valid[..., None, None]
    m_focal = focal_loss(outputs["pred_masks"] * vmask, gt_masks * vmask)
    m_dice = dice_loss(outputs["pred_masks"] * vmask - (1 - vmask) * 1e4,
                       gt_masks * vmask)

    loss = obj_loss + box_loss + cls_loss + 20.0 * m_focal + m_dice
    return loss, {
        "loss/objectness": obj_loss,
        "loss/box_reg": box_loss,
        "loss/classifier": cls_loss,
        "loss/mask_focal": m_focal,
        "loss/mask_dice": m_dice,
        "loss/total": loss,
    }
