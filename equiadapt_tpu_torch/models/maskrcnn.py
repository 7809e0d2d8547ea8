"""Mask R-CNN with a ResNet-50-FPN backbone, at torchvision's published
settings, with static shapes from input to output.

He, Gkioxari, Dollar, Girshick, "Mask R-CNN" (ICCV 2017), as torchvision
builds it (`torchvision/models/detection/mask_rcnn.py::maskrcnn_resnet50_fpn`
with the defaults of `faster_rcnn.py`, `rpn.py`, `roi_heads.py` and
`transform.py`): the detector equiadapt's segmentation example wraps. Not the
JAX package's `MaskRCNNLite` (`models.detection`), a static-shape redesign
with no FPN, RPN, NMS or RoIAlign.

* Transform: ImageNet mean and std; a bilinear resize (half-pixel centres)
  so the short side is `min_size` and the long side at most `MAX_SIZE` (a
  1024 px square becomes 800 x 800); padding to a multiple of 32.
* Backbone: the port's ResNet-50 (`models.resnet.ResNet50`, eval BatchNorm:
  torchvision's frozen BatchNorm is BatchNorm with fixed statistics), C2-C5;
  the FPN's 1 x 1 laterals to 256 channels, nearest 2x top-down sums, 3 x 3
  outputs P2-P5, and P6 = P5[::2, ::2] (a max-pool of kernel 1, stride 2).
* RPN: a shared 3 x 3 conv and ReLU, 1 x 1 convs to 3 logits and 12 deltas
  a location; anchors of sizes 32-512 (one a level) and aspect ratios 0.5,
  1, 2 (torchvision's rounded base anchors, strides image // feature); the
  box coder with weights (1, 1, 1, 1), deltas clamped at log(1000 / 16);
  the top `rpn_pre_nms_top_n` logits a level, clipped, boxes under 1e-3
  dropped, NMS at 0.7 within each level, the top `rpn_post_nms_top_n`
  kept an image.
* Box branch: RoIAlign on P2-P5 (7 x 7, sampling ratio 2, aligned=False),
  the level k = floor(4 + log2(sqrt(area) / 224) + 1e-6) clamped to 2-5
  (torchvision's `LevelMapper`, eps added after the log); fc6, fc7 (12,544 ->
  1,024 -> 1,024, ReLU); 91 class logits and 364 deltas; softmax, decode with
  weights (10, 10, 5, 5), clip, background dropped, score > 0.05, boxes
  under 1e-2 dropped, NMS at 0.5 within each class, the top 100 kept.
* Mask branch: RoIAlign at 14 x 14 on the detections, four 3 x 3 convs of
  256 with ReLU, a 2 x 2 stride-2 transposed conv with ReLU, a 1 x 1 conv to
  91 classes; the detected label's 28 x 28 logits through a sigmoid.
* `paste_masks`: torchvision's `paste_masks_in_image` (pad by 1, scale the
  box by 30 / 28, truncate it to integers, resize the mask bilinearly into
  it) for every mask at once, as two products with interpolation matrices.

Static shapes: where torchvision keeps a variable number of boxes, this
module keeps a fixed number with a validity mask (top-k, stable sorts, the
segmented NMS of `ops.kernels.nms`; no `nonzero`), so a served call makes no
host sync. Two departures from torchvision, both where its result is not
fixed by its definition: ties in score keep index order (stable sorts), and
fewer than 100 surviving detections are padded (score 0, `valid` False,
box and mask zero).

`dtype` is the computation's dtype of the convolutions and linear layers
(parameters fp32, cast per call); boxes, scores, the NMS and the paste are
fp32. Parameter names follow torchvision's tree as its published checkpoint
writes them (`backbone.body.layer1.0.conv1.weight`, `backbone.fpn.
inner_blocks.0.weight`, `rpn.head.conv.weight`, `roi_heads.box_head.fc6`,
`roi_heads.mask_head.mask_fcn1`, ...): the trunk is the port's ResNet with
its own names inside, mapped to torchvision's in `state_dict` and
`load_state_dict` (`models.convert.torchvision_resnet_names`); the newer
torchvision names (`inner_blocks.0.0.weight`, `rpn.head.conv.0.0.weight`,
`mask_head.0.0.weight`) load too. So `load_state_dict` takes a
`maskrcnn_resnet50_fpn` state dict as it is.

Spans (`utils.profiling.annotate`): `maskrcnn/backbone` (transform, trunk,
FPN), `maskrcnn/rpn` (head, anchors, decode, top-k, NMS), `maskrcnn/nms`
(each NMS call), `maskrcnn/roi_heads` with `maskrcnn/roi_align` (each
RoIAlign), `maskrcnn/box_head` and `maskrcnn/mask_head`; `maskrcnn/paste`.
Counters on the card (`count_on_device`, while spans record):
`maskrcnn/proposals`, `maskrcnn/nms_candidates`, `maskrcnn/nms_pairs`,
`maskrcnn/detections`.

Setting `keep` to a dict makes a call store its intermediates there (the
transformed batch, the pyramid, the RPN's outputs and NMS segments, the
proposals, the box branch's outputs and the final NMS segments): references
to what the call computed anyway, for a comparison with a reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from equiadapt_tpu_torch.common.layers import CastConv2d, CastConvTranspose2d, CastLinear
from equiadapt_tpu_torch.models.convert import torchvision_resnet_names
from equiadapt_tpu_torch.models.resnet import ResNet50
from equiadapt_tpu_torch.ops.kernels import nms as nms_ops
from equiadapt_tpu_torch.ops.kernels import roi_align as roi_ops
from equiadapt_tpu_torch.utils.profiling import annotate, count_on_device

Tensor = torch.Tensor

__all__ = ["MaskRCNN", "decode_boxes", "clip_boxes", "level_of",
           "base_anchors", "grid_anchors", "paste_masks", "resized_size", "IMAGE_MEAN",
           "IMAGE_STD", "ANCHOR_SIZES", "ASPECT_RATIOS", "BBOX_CLIP", "MAX_SIZE",
           "RPN_NMS_THRESH", "RPN_MIN_SIZE", "BOX_SCORE_THRESH", "BOX_NMS_THRESH", "BOX_MIN_SIZE"]

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)
ANCHOR_SIZES = (32, 64, 128, 256, 512)
ASPECT_RATIOS = (0.5, 1.0, 2.0)
BBOX_CLIP = math.log(1000.0 / 16)
RPN_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
MAX_SIZE = 1333
RPN_NMS_THRESH = 0.7
RPN_MIN_SIZE = 1e-3
BOX_SCORE_THRESH = 0.05
BOX_NMS_THRESH = 0.5
BOX_MIN_SIZE = 1e-2
FPN_CHANNELS = 256
SIZE_DIVISIBLE = 32


def resized_size(h: int, w: int, min_size: int, max_size: int) -> Tuple[int, int]:
    """torchvision's resize of an h x w image: the scale min(min_size /
    short, max_size / long), each side floored."""
    scale = min(min_size / min(h, w), max_size / max(h, w))
    return int(math.floor(h * scale)), int(math.floor(w * scale))


def decode_boxes(deltas: Tensor, boxes: Tensor, weights: Sequence[float],
                 clip: float = BBOX_CLIP) -> Tensor:
    """torchvision's `BoxCoder.decode_single` in fp32: deltas (..., 4) against
    boxes (..., 4) xyxy (broadcast), the size deltas clamped at `clip`."""
    deltas, boxes = deltas.float(), boxes.float()
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights
    wx, wy, ww, wh = weights
    dx, dy = deltas[..., 0] / wx, deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=clip)
    dh = torch.clamp(deltas[..., 3] / wh, max=clip)
    pred_ctr_x = dx * widths + ctr_x
    pred_ctr_y = dy * heights + ctr_y
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    half_w, half_h = 0.5 * pred_w, 0.5 * pred_h
    return torch.stack([pred_ctr_x - half_w, pred_ctr_y - half_h,
                        pred_ctr_x + half_w, pred_ctr_y + half_h], dim=-1)


def clip_boxes(boxes: Tensor, height: int, width: int) -> Tensor:
    x = boxes[..., 0::2].clamp(min=0, max=width)
    y = boxes[..., 1::2].clamp(min=0, max=height)
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], dim=-1)


def _not_small(boxes: Tensor, min_size: float) -> Tensor:
    return ((boxes[..., 2] - boxes[..., 0]) >= min_size) & (
        (boxes[..., 3] - boxes[..., 1]) >= min_size)


def level_of(boxes: Tensor, k_min: int = 2, k_max: int = 5) -> Tensor:
    """torchvision's `LevelMapper`: floor(4 + log2(sqrt(area) / 224) + 1e-6)
    clamped to [k_min, k_max], less k_min (int64)."""
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    s = torch.sqrt(area)
    lvl = torch.floor(4 + torch.log2(s / 224) + torch.tensor(1e-6, dtype=s.dtype))
    return torch.clamp(lvl, min=k_min, max=k_max).to(torch.int64) - k_min


def base_anchors(size: int, ratios: Sequence[float] = ASPECT_RATIOS, device=None) -> Tensor:
    """torchvision's `AnchorGenerator.generate_anchors` for one size: (A, 4)
    zero-centred xyxy, rounded."""
    scales = torch.as_tensor([size], dtype=torch.float32, device=device)
    ar = torch.as_tensor(ratios, dtype=torch.float32, device=device)
    h_ratios = torch.sqrt(ar)
    w_ratios = 1 / h_ratios
    ws = (w_ratios[:, None] * scales[None, :]).view(-1)
    hs = (h_ratios[:, None] * scales[None, :]).view(-1)
    return (torch.stack([-ws, -hs, ws, hs], dim=1) / 2).round()


def grid_anchors(base: Tensor, grid: Tuple[int, int], image: Tuple[int, int]) -> Tensor:
    """(H W A, 4) anchors of one level: the base anchors at every location,
    location-major (rows, then columns), strides image // grid."""
    gh, gw = grid
    sh, sw = image[0] // gh, image[1] // gw
    shifts_x = torch.arange(0, gw, dtype=torch.int32, device=base.device) * sw
    shifts_y = torch.arange(0, gh, dtype=torch.int32, device=base.device) * sh
    shift_y, shift_x = torch.meshgrid(shifts_y, shifts_x, indexing="ij")
    shift_x, shift_y = shift_x.reshape(-1), shift_y.reshape(-1)
    shifts = torch.stack((shift_x, shift_y, shift_x, shift_y), dim=1)
    return (shifts.view(-1, 1, 4) + base.view(1, -1, 4)).reshape(-1, 4)


def _paste_weights(lo: Tensor, hi: Tensor, source: int, size: int) -> Tensor:
    """(..., size, source) interpolation matrix of one axis of
    `paste_masks`: output pixel p inside [lo, hi] samples the source
    resized bilinearly (half-pixel centres, PyTorch's `interpolate`
    arithmetic in fp32) to hi - lo + 1 pixels; zero rows outside."""
    n = torch.clamp(hi - lo + 1, min=1)
    pos = torch.arange(size, device=lo.device)
    d = pos - lo[..., None]
    inside = (d >= 0) & (pos <= hi[..., None])
    scale = source / n.float()  # float(source) / n
    src = scale[..., None] * (d.float() + 0.5) - 0.5
    src = torch.where(src < 0, torch.zeros_like(src), src)
    i0 = src.to(torch.int64)
    frac = torch.clamp(src - i0.float(), 0.0, 1.0)
    i0 = torch.clamp(i0, max=source - 1)
    i1 = i0 + (i0 < source - 1).to(torch.int64)
    w1 = torch.where(inside, frac, torch.zeros_like(frac))
    w0 = torch.where(inside, 1.0 - frac, torch.zeros_like(frac))
    cols = torch.arange(source, device=lo.device)
    return (w0[..., None] * (cols == i0[..., None]) + w1[..., None] * (cols == i1[..., None]))


def paste_masks(masks: Tensor, boxes: Tensor, size: Tuple[int, int]) -> Tensor:
    """torchvision's `paste_masks_in_image` of every mask at once: masks
    (..., M, M) fp32 in boxes (..., 4) xyxy of an image of `size` (H, W) ->
    (..., H, W) fp32. Each mask is padded by one pixel, its box scaled about
    its centre by (M + 2) / M and truncated to integers, and the
    padded mask resized bilinearly to the box's pixels (inclusive) and
    placed there; out of the image it is cut off. Computed as Ry @ mask @
    Rx^T with each axis' interpolation matrix (`_paste_weights`)."""
    with annotate("maskrcnn/paste"):
        M = masks.shape[-1]
        padded = F.pad(masks.float(), (1, 1, 1, 1))
        scale = float(M + 2) / M
        boxes = boxes.float()
        w_half = (boxes[..., 2] - boxes[..., 0]) * 0.5
        h_half = (boxes[..., 3] - boxes[..., 1]) * 0.5
        x_c = (boxes[..., 2] + boxes[..., 0]) * 0.5
        y_c = (boxes[..., 3] + boxes[..., 1]) * 0.5
        w_half = w_half * scale
        h_half = h_half * scale
        ints = torch.stack([x_c - w_half, y_c - h_half, x_c + w_half, y_c + h_half],
                           dim=-1).to(torch.int64)
        H, W = size
        ry = _paste_weights(ints[..., 1], ints[..., 3], M + 2, H)
        rx = _paste_weights(ints[..., 0], ints[..., 2], M + 2, W)
        return torch.matmul(torch.matmul(ry, padded), rx.transpose(-1, -2))


def _count(name: str, n) -> None:
    count_on_device(f"maskrcnn/{name}", n)


def _pairs(counts: Tensor) -> Tensor:
    """The candidate pairs within each segment of `counts`."""
    c = counts.to(torch.int64)
    return c * (c - 1) // 2


def _nms(boxes: Tensor, scores: Tensor, valid: Tensor, threshold: float) -> Tensor:
    """Segmented NMS (`ops.kernels.nms.segment_nms`) under its span, with
    the candidates and pairs counted."""
    with annotate("maskrcnn/nms"):
        keep, counts = nms_ops.segment_nms(boxes, scores, valid, threshold)
    _count("nms_candidates", counts)
    _count("nms_pairs", lambda: _pairs(counts))  # made only while counted
    return keep


def _first_kept(keep: Tensor, scores: Tensor, n: int) -> Tuple[Tensor, Tensor]:
    """The first n kept candidates of each row (B, K) by descending score,
    ties in index order: (indices (B, n), kept (B, n))."""
    key = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices[:, :n]
    return order, torch.gather(keep, 1, order)


class _FPN(nn.Module):
    """torchvision's `FeaturePyramidNetwork` with `LastLevelMaxPool`."""

    def __init__(self, in_channels: Sequence[int], out_channels: int, device):
        super().__init__()
        self.inner_blocks = nn.ModuleList(
            CastConv2d(c, out_channels, 1, device=device) for c in in_channels)
        self.layer_blocks = nn.ModuleList(
            CastConv2d(out_channels, out_channels, 3, padding=1, device=device)
            for _ in in_channels)

    def forward(self, feats: Sequence[Tensor]) -> List[Tensor]:
        last = self.inner_blocks[-1](feats[-1])
        out = [self.layer_blocks[-1](last)]
        for i in range(len(feats) - 2, -1, -1):
            lateral = self.inner_blocks[i](feats[i])
            last = lateral + F.interpolate(last, size=lateral.shape[-2:], mode="nearest")
            out.insert(0, self.layer_blocks[i](last))
        out.append(F.max_pool2d(out[-1], 1, 2, 0))
        return out


class _Backbone(nn.Module):
    def __init__(self, dtype, device):
        super().__init__()
        self.body = ResNet50(num_classes=None, return_stages=True, dtype=dtype, device=device)
        self.fpn = _FPN((256, 512, 1024, 2048), FPN_CHANNELS, device)
        names = torchvision_resnet_names(self.body.state_dict().keys())
        self.body._register_state_dict_hook(_to_names(names))
        self.body.register_load_state_dict_pre_hook(_from_names(names))


def _to_names(names: Dict[str, str]):
    """A state-dict hook giving the trunk's tensors torchvision's names (and
    dropping BatchNorm's step counters, which frozen BatchNorm lacks)."""

    def hook(module, state_dict, prefix, local_metadata):
        for port, tv in names.items():
            if prefix + port in state_dict:
                state_dict[prefix + tv] = state_dict.pop(prefix + port)
        for k in [k for k in state_dict
                  if k.startswith(prefix) and k.endswith(".num_batches_tracked")]:
            del state_dict[k]
        return state_dict

    return hook


def _from_names(names: Dict[str, str]):
    """A load pre-hook reading torchvision's names into the trunk."""
    counters = sorted({p.rsplit(".", 1)[0] + ".num_batches_tracked"
                       for p in names if ".BatchNorm_" in p or p.startswith("BatchNorm_")})

    def hook(module, state_dict, prefix, local_metadata, strict, missing, unexpected,
             errors):
        for port, tv in names.items():
            if prefix + tv in state_dict:
                state_dict[prefix + port] = state_dict.pop(prefix + tv)
        for k in counters:
            state_dict.setdefault(prefix + k, torch.zeros((), dtype=torch.long))

    return hook


# newer torchvision names (Conv2dNormActivation wrappers) -> the checkpoint's
_NEWER_NAMES = (
    (r"backbone.fpn.inner_blocks.{i}.0.", "backbone.fpn.inner_blocks.{i}.", 4),
    (r"backbone.fpn.layer_blocks.{i}.0.", "backbone.fpn.layer_blocks.{i}.", 4),
    (r"rpn.head.conv.0.0.", "rpn.head.conv.", 1),
    (r"roi_heads.mask_head.{i}.0.", "roi_heads.mask_head.mask_fcn{j}.", 4),
)


class _RPNHead(nn.Module):
    def __init__(self, channels: int, anchors: int, device):
        super().__init__()
        self.conv = CastConv2d(channels, channels, 3, padding=1, device=device)
        self.cls_logits = CastConv2d(channels, anchors, 1, device=device)
        self.bbox_pred = CastConv2d(channels, anchors * 4, 1, device=device)


class _RPN(nn.Module):
    def __init__(self, channels: int, anchors: int, device):
        super().__init__()
        self.head = _RPNHead(channels, anchors, device)


class _TwoMLPHead(nn.Module):
    def __init__(self, in_features: int, hidden: int, device):
        super().__init__()
        self.fc6 = CastLinear(in_features, hidden, device=device)
        self.fc7 = CastLinear(hidden, hidden, device=device)


class _FastRCNNPredictor(nn.Module):
    def __init__(self, hidden: int, num_classes: int, device):
        super().__init__()
        self.cls_score = CastLinear(hidden, num_classes, device=device)
        self.bbox_pred = CastLinear(hidden, num_classes * 4, device=device)


class _MaskHead(nn.Module):
    def __init__(self, channels: int, device):
        super().__init__()
        for i in range(1, 5):
            self.add_module(f"mask_fcn{i}", CastConv2d(channels, channels, 3, padding=1,
                                                       device=device))


class _MaskPredictor(nn.Module):
    def __init__(self, channels: int, num_classes: int, device):
        super().__init__()
        self.conv5_mask = CastConvTranspose2d(channels, channels, 2, 2, device=device)
        self.mask_fcn_logits = CastConv2d(channels, num_classes, 1, device=device)


class _RoIHeads(nn.Module):
    def __init__(self, num_classes: int, device):
        super().__init__()
        self.box_head = _TwoMLPHead(FPN_CHANNELS * 7 * 7, 1024, device)
        self.box_predictor = _FastRCNNPredictor(1024, num_classes, device)
        self.mask_head = _MaskHead(FPN_CHANNELS, device)
        self.mask_predictor = _MaskPredictor(FPN_CHANNELS, num_classes, device)


class MaskRCNN(nn.Module):
    """Mask R-CNN ResNet-50-FPN (module docstring) on NHWC images.

    `forward(images)` of (B, S, S, 3) images returns, in the images' frame:
    boxes (B, D, 4) fp32 xyxy, scores (B, D) fp32, labels (B, D) int64,
    valid (B, D) bool and mask_probs (B, D, 28, 28) fp32 (D =
    `box_detections_per_img`); `paste_masks` puts the masks into the frame.
    """

    def __init__(self, num_classes: int = 91, min_size: int = 800,
                 rpn_pre_nms_top_n: int = 1000, rpn_post_nms_top_n: int = 1000,
                 box_detections_per_img: int = 100, dtype: torch.dtype = torch.float32,
                 device="cuda"):
        super().__init__()
        self.num_classes = num_classes
        self.min_size = min_size
        self.rpn_pre_nms_top_n, self.rpn_post_nms_top_n = rpn_pre_nms_top_n, rpn_post_nms_top_n
        self.detections = box_detections_per_img
        self.dtype = dtype
        self.backbone = _Backbone(dtype, device)
        self.rpn = _RPN(FPN_CHANNELS, len(ASPECT_RATIOS), device)
        self.roi_heads = _RoIHeads(num_classes, device)
        self.register_load_state_dict_pre_hook(_newer_names)
        # made once on the device: a served call copies nothing from the host
        self.register_buffer("image_mean", torch.tensor(IMAGE_MEAN, device=device),
                             persistent=False)
        self.register_buffer("image_std", torch.tensor(IMAGE_STD, device=device),
                             persistent=False)
        self.keep: Optional[dict] = None
        self._anchors: Dict[tuple, List[Tensor]] = {}

    # ------------------------------------------------------------ stages

    def transform(self, images: Tensor) -> Tensor:
        """NHWC images -> the normalized, resized, padded NCHW batch (fp32)."""
        B, H, W, _ = images.shape
        x = images.permute(0, 3, 1, 2).float()
        x = (x - self.image_mean[None, :, None, None]) / self.image_std[None, :, None, None]
        h, w = resized_size(H, W, self.min_size, MAX_SIZE)
        if (h, w) != (H, W):
            x = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)
        ph = -(-h // SIZE_DIVISIBLE) * SIZE_DIVISIBLE - h
        pw = -(-w // SIZE_DIVISIBLE) * SIZE_DIVISIBLE - w
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph))
        return x

    def features(self, x: Tensor) -> List[Tensor]:
        """P2-P6 of the transformed batch (NCHW, in the compute dtype)."""
        c = self.backbone.body(x.permute(0, 2, 3, 1).to(self.dtype))
        return self.backbone.fpn(c)

    def rpn_head(self, feats: Sequence[Tensor]) -> Tuple[List[Tensor], List[Tensor]]:
        """Per level: objectness (B, H W A) and deltas (B, H W A, 4), fp32."""
        head = self.rpn.head
        objs, deltas = [], []
        for f in feats:
            t = torch.relu(head.conv(f))
            o, d = head.cls_logits(t), head.bbox_pred(t)
            B, A, H, W = o.shape
            objs.append(o.permute(0, 2, 3, 1).reshape(B, -1).float())
            deltas.append(d.view(B, A, 4, H, W).permute(0, 3, 4, 1, 2).reshape(B, -1, 4)
                          .float())
        return objs, deltas

    def anchors(self, feats: Sequence[Tensor], image: Tuple[int, int]) -> List[Tensor]:
        key = (tuple(f.shape[-2:] for f in feats), image, feats[0].device)
        if key not in self._anchors:
            self._anchors[key] = [
                grid_anchors(base_anchors(s, device=feats[0].device), tuple(f.shape[-2:]), image)
                for s, f in zip(ANCHOR_SIZES, feats)]
        return self._anchors[key]

    def proposals(self, feats: Sequence[Tensor], padded: Tuple[int, int],
                  image: Tuple[int, int]) -> Tuple[Tensor, Tensor]:
        """(boxes (B, N, 4) fp32, valid (B, N)) of the RPN, N =
        `rpn_post_nms_top_n`, in descending score order: anchors strided
        over the `padded` batch, boxes clipped to the resized `image`."""
        with annotate("maskrcnn/rpn"):
            objs, deltas = self.rpn_head(feats)
            anchors = self.anchors(feats, padded)
            K = self.rpn_pre_nms_top_n
            B = objs[0].shape[0]
            boxes, scores, valid = [], [], []
            for o, d, a in zip(objs, deltas, anchors):
                k = min(K, o.shape[1])
                top, idx = torch.topk(o, k, dim=1)
                dd = torch.gather(d, 1, idx[..., None].expand(-1, -1, 4))
                bx = clip_boxes(decode_boxes(dd, a[idx], RPN_WEIGHTS), *image)
                ok = _not_small(bx, RPN_MIN_SIZE)
                if k < K:  # pad the level's segment with invalid slots
                    bx = F.pad(bx, (0, 0, 0, K - k))
                    top = F.pad(top, (0, K - k))
                    ok = F.pad(ok, (0, K - k))
                boxes.append(bx)
                scores.append(torch.sigmoid(top))
                valid.append(ok)
            L = len(boxes)
            boxes = torch.stack(boxes, 1)  # (B, L, K, 4)
            scores, valid = torch.stack(scores, 1), torch.stack(valid, 1)
            keep = _nms(boxes.reshape(B * L, K, 4), scores.reshape(B * L, K),
                        valid.reshape(B * L, K), RPN_NMS_THRESH).reshape(B, L * K)
            order, kept = _first_kept(keep, scores.reshape(B, L * K), self.rpn_post_nms_top_n)
            props = torch.gather(boxes.reshape(B, L * K, 4), 1, order[..., None].expand(-1, -1, 4))
            props = torch.where(kept[..., None], props, torch.zeros_like(props))
        _count("proposals", kept)
        if self.keep is not None:
            self.keep.update(rpn_objectness=objs, rpn_deltas=deltas, rpn_boxes=boxes,
                             rpn_scores=scores, rpn_valid=valid, rpn_keep=keep,
                             proposals=props, proposals_valid=kept)
        return props, kept

    def roi_align(self, feats: Sequence[Tensor], boxes: Tensor, size: int,
                  image: Tuple[int, int]) -> Tensor:
        """`ops.kernels.roi_align` of (B, N, 4) boxes on P2-P5 at size x size
        (sampling ratio 2), each box on its `level_of`."""
        with annotate("maskrcnn/roi_align"):
            B, N, _ = boxes.shape
            maps = list(feats[:4])
            scales = [2.0 ** round(math.log2(f.shape[-2] / image[0])) for f in maps]
            k_min = int(-math.log2(scales[0]))
            rois = boxes.reshape(B * N, 4)
            level = level_of(rois, k_min, k_min + len(maps) - 1)
            batch = torch.arange(B, device=boxes.device, dtype=torch.int32).repeat_interleave(N)
            return roi_ops.roi_align(maps, rois, batch, level, scales, size, 2)

    def box_branch(self, feats: Sequence[Tensor], props: Tensor, image: Tuple[int, int]
                   ) -> Tuple[Tensor, Tensor]:
        """Class logits (B N, classes) and deltas (B N, 4 classes), fp32."""
        x = self.roi_align(feats, props, 7, image)
        with annotate("maskrcnn/box_head"):
            head, pred = self.roi_heads.box_head, self.roi_heads.box_predictor
            x = x.flatten(1)
            x = torch.relu(head.fc7(torch.relu(head.fc6(x))))
            return pred.cls_score(x).float(), pred.bbox_pred(x).float()

    def detect(self, logits: Tensor, deltas: Tensor, props: Tensor, props_valid: Tensor,
               image: Tuple[int, int]) -> Dict[str, Tensor]:
        """torchvision's `postprocess_detections` with fixed shapes."""
        B, N, _ = props.shape
        C = self.num_classes
        scores = torch.softmax(logits, -1).reshape(B, N, C)[..., 1:]
        boxes = clip_boxes(decode_boxes(deltas.reshape(B, N, C, 4), props[:, :, None],
                                        BOX_WEIGHTS), *image)[:, :, 1:]
        valid = ((scores > BOX_SCORE_THRESH) & _not_small(boxes, BOX_MIN_SIZE)
                 & props_valid[..., None])
        seg = (boxes.transpose(1, 2).reshape(B * (C - 1), N, 4),
               scores.transpose(1, 2).reshape(B * (C - 1), N),
               valid.transpose(1, 2).reshape(B * (C - 1), N))
        keep = _nms(*seg, BOX_NMS_THRESH).reshape(B, C - 1, N).transpose(1, 2)
        keep = keep.reshape(B, N * (C - 1))
        flat = scores.reshape(B, N * (C - 1))
        order, kept = _first_kept(keep, flat, self.detections)
        det_boxes = torch.gather(boxes.reshape(B, -1, 4), 1, order[..., None].expand(-1, -1, 4))
        out = {"boxes": torch.where(kept[..., None], det_boxes, torch.zeros_like(det_boxes)),
               "scores": torch.where(kept, torch.gather(flat, 1, order),
                                     torch.zeros_like(order, dtype=flat.dtype)),
               "labels": order % (C - 1) + 1, "valid": kept}
        if self.keep is not None:
            self.keep.update(det_boxes=boxes, det_scores=scores, det_valid=valid,
                             det_keep=keep, det_order=order)
        return out

    def mask_branch(self, feats: Sequence[Tensor], boxes: Tensor, labels: Tensor,
                    valid: Tensor, image: Tuple[int, int]) -> Tensor:
        """(B, D, 28, 28) fp32 probabilities of each detection's label (zero
        where it is not valid)."""
        x = self.roi_align(feats, boxes, 14, image)
        with annotate("maskrcnn/mask_head"):
            head, pred = self.roi_heads.mask_head, self.roi_heads.mask_predictor
            for i in range(1, 5):
                x = torch.relu(getattr(head, f"mask_fcn{i}")(x))
            x = pred.mask_fcn_logits(torch.relu(pred.conv5_mask(x)))
            B, D = labels.shape
            rows = torch.arange(B * D, device=x.device)
            probs = torch.sigmoid(x[rows, labels.reshape(-1)].float()).reshape(B, D, *x.shape[-2:])
            return torch.where(valid[..., None, None], probs, torch.zeros_like(probs))

    # ------------------------------------------------------------ the call

    def forward(self, images: Tensor, training: bool = False) -> Dict[str, Tensor]:
        if training:
            raise NotImplementedError("MaskRCNN is served in eval only (no losses)")
        S = images.shape[1:3]
        with annotate("maskrcnn/backbone"):
            x = self.transform(images)
            feats = self.features(x)
        image = resized_size(S[0], S[1], self.min_size, MAX_SIZE)
        props, props_valid = self.proposals(feats, tuple(x.shape[-2:]), image)
        with annotate("maskrcnn/roi_heads"):
            logits, deltas = self.box_branch(feats, props, image)
            det = self.detect(logits, deltas, props, props_valid, image)
            det["mask_probs"] = self.mask_branch(feats, det["boxes"], det["labels"],
                                                 det["valid"], image)
        _count("detections", det["valid"])
        if self.keep is not None:
            self.keep.update(transformed=x, features=feats, class_logits=logits,
                             box_regression=deltas, boxes_resized=det["boxes"])
        # torchvision's fp32 ratios of the input to the resized size, on the host
        rh, rw = (float(torch.tensor(a, dtype=torch.float32) / torch.tensor(b, dtype=torch.float32))
                  for a, b in zip(S, image))
        x1, y1, x2, y2 = det["boxes"].unbind(-1)
        det["boxes"] = torch.stack([x1 * rw, y1 * rh, x2 * rw, y2 * rh], dim=-1)
        if self.keep is not None:
            self.keep["boxes"] = det["boxes"]
        return det

    def paste_masks(self, mask_probs: Tensor, boxes: Tensor, size: Tuple[int, int]) -> Tensor:
        """The detections' masks in the (H, W) frame of their boxes
        (`paste_masks`), fp32 probabilities."""
        return paste_masks(mask_probs, boxes, size)


def _newer_names(module, state_dict, prefix, local_metadata, strict, missing, unexpected,
                 errors):
    """Read the newer torchvision names of the FPN, RPN and mask head."""
    for new, old, n in _NEWER_NAMES:
        for i in range(n):
            a = prefix + new.format(i=i)
            b = prefix + old.format(i=i, j=i + 1)
            for k in [k for k in state_dict if k.startswith(a)]:
                state_dict[b + k[len(a):]] = state_dict.pop(k)
