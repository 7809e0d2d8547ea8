"""Plain reference of the `maskrcnn-r50fpn-c4` configuration.

The C4 canonicalizer of `sam_vitb_c4` (equiadapt's published segmentation
canonicalizer: its GCNN on the centre-cropped, resized image, the argmax
element, the image turned back by that exact quarter turn) in front of Mask
R-CNN with a ResNet-50-FPN backbone (He et al. 2017), as torchvision builds
`maskrcnn_resnet50_fpn` with the defaults of `faster_rcnn.py`, `rpn.py`,
`roi_heads.py` and `transform.py`:

* transform: (x - mean) / std with ImageNet's statistics; a bilinear resize
  (half-pixel centres, no antialias) by min(800 / short, 1333 / long), each
  side floored; zero padding to a multiple of 32;
* ResNet-50 (torchvision's layout, frozen BatchNorm: fixed statistics,
  eps 1e-5) to C2-C5; the FPN: 1 x 1 laterals to 256, nearest top-down
  sums, 3 x 3 outputs, P6 a max-pool of kernel 1 and stride 2 of P5;
* the RPN: 3 x 3 conv + ReLU, 1 x 1 convs to 3 logits and 12 deltas a
  location, permuted to (H, W, A) order; anchors of size 32 x 2^l and
  ratios (0.5, 1, 2), torchvision's rounded base anchors, strides image //
  feature; the top 1,000 logits a level, decoded (weights 1, deltas
  clamped at log(1000 / 16)), clipped, boxes under 1e-3 dropped, NMS at 0.7
  within each level, the first 1,000 kept;
* RoIAlign from torchvision's bilinear sampling formula (aligned=False,
  sampling ratio 2; regions at least 1 x 1; samples outside [-1, size]
  zero; clamped at 0 and at the last row), the level floor(4 + log2(sqrt(
  area) / 224) + 1e-6) clamped to 2-5;
* the box head (fc6, fc7, ReLU), 91 logits and 364 deltas; softmax, decode
  (weights 10, 10, 5, 5), clip, background dropped, score > 0.05, boxes
  under 1e-2 dropped, NMS at 0.5 within each class, the first 100 kept;
* the mask head (four 3 x 3 convs + ReLU, a transposed 2 x 2 conv + ReLU, a
  1 x 1 conv to 91), the label's logits through a sigmoid;
* the boxes scaled back to the input size (fp32 ratios), the masks pasted
  one box at a time (torchvision's `paste_masks_in_image`: pad 1, scale the
  box by 30 / 28, truncate, `F.interpolate` into it, place it), and both
  turned back to the input frame by the element.

NMS is torchvision's greedy loop, one segment at a time. Two departures
from torchvision, both where its result is not fixed by its definition:
ties in score go to the lower index (stable sorts), and an image with fewer
than 100 detections is padded to 100 (score 0, not valid, box and mask
zero). Everything is fp32 with TF32 off; the reference runs one image at a
time.

`serve` returns, besides the outputs, the intermediates the comparison
reads (the pyramid, the RPN's outputs and NMS segments, the proposals, the
box branch's outputs, the final NMS segments), in the program's layouts.
`faults` plants a defect: "roi_align_sr1" samples RoIAlign once a bin,
"level_off_by_one" pools every region one level up, "class_agnostic_nms"
suppresses across classes.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import sam_vitb_c4 as canon
from benchmark.reference.common import FP32, Precision, Weights, batch_norm, bn_spec

Tensor = torch.Tensor

PRED = "prediction_network"
BODY = f"{PRED}.backbone.body"
FPN = f"{PRED}.backbone.fpn"
RPN = f"{PRED}.rpn.head"
ROI = f"{PRED}.roi_heads"
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
SIZES = (32, 64, 128, 256, 512)
RATIOS = (0.5, 1.0, 2.0)
CLIP = math.log(1000.0 / 16)
MAX_SIZE = 1333
RPN_NMS_THRESH = 0.7
RPN_MIN_SIZE = 1e-3
BOX_SCORE_THRESH = 0.05
BOX_NMS_THRESH = 0.5
BOX_MIN_SIZE = 1e-2
STAGES = (3, 4, 6, 3)
FAULTS = ("roi_align_sr1", "level_off_by_one", "class_agnostic_nms")


def _m(settings: dict) -> dict:
    return settings["maskrcnn"]


def _gain(g: float, fan_in: int) -> str:
    """N(0, (g / sqrt(fan_in))^2)."""
    return f"normal:{g / math.sqrt(fan_in)!r}"


def _conv_spec(prefix: str, cout: int, cin: int, k: int, init: str = "he",
               bias: bool = True) -> List[Tuple[str, tuple, str]]:
    spec = [(f"{prefix}.weight", (cout, cin, k, k), init)]
    return spec + ([(f"{prefix}.bias", (cout,), "small")] if bias else [])


def _body_spec(residual_gain: float) -> List[Tuple[str, tuple, str]]:
    spec = _conv_spec(f"{BODY}.conv1", 64, 3, 7, bias=False) + bn_spec(f"{BODY}.bn1", 64)
    cin, width = 64, 64
    for s, n in enumerate(STAGES, start=1):
        for j in range(n):
            p = f"{BODY}.layer{s}.{j}"
            cout = width * 4
            spec += _conv_spec(f"{p}.conv1", width, cin, 1, bias=False) + bn_spec(f"{p}.bn1", width)
            spec += _conv_spec(f"{p}.conv2", width, width, 3, bias=False)
            spec += bn_spec(f"{p}.bn2", width)
            spec += _conv_spec(f"{p}.conv3", cout, width, 1, _gain(residual_gain, width),
                               bias=False)
            spec += bn_spec(f"{p}.bn3", cout)
            if j == 0:
                spec += _conv_spec(f"{p}.downsample.0", cout, cin, 1, bias=False)
                spec += bn_spec(f"{p}.downsample.1", cout)
            cin = cout
        width *= 2
    return spec


def param_spec(settings: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every weight and statistic: the GCNN's, then
    Mask R-CNN's under torchvision's names. The scales of the heads are the
    configuration's `assumed` ones: each weight of `weights` (a gain g:
    N(0, g^2 / fan-in)), He's sqrt(2 / fan-in) elsewhere."""
    m = _m(settings)
    g = settings["weights"]
    C, FPN_C = m["num_classes"], 256
    spec = canon._gcnn_spec(settings) + _body_spec(g["residual"])
    for i, cin in enumerate((256, 512, 1024, 2048)):
        spec += _conv_spec(f"{FPN}.inner_blocks.{i}", FPN_C, cin, 1, _gain(g["fpn"], cin))
        spec += _conv_spec(f"{FPN}.layer_blocks.{i}", FPN_C, FPN_C, 3,
                           _gain(g["fpn"], 9 * FPN_C))
    A = len(RATIOS)
    spec += _conv_spec(f"{RPN}.conv", FPN_C, FPN_C, 3)
    spec += _conv_spec(f"{RPN}.cls_logits", A, FPN_C, 1, _gain(g["rpn_cls_logits"], FPN_C))
    spec += _conv_spec(f"{RPN}.bbox_pred", 4 * A, FPN_C, 1, _gain(g["rpn_bbox_pred"], FPN_C))
    spec += [(f"{ROI}.box_head.fc6.weight", (1024, FPN_C * 49), "he"),
             (f"{ROI}.box_head.fc6.bias", (1024,), "small"),
             (f"{ROI}.box_head.fc7.weight", (1024, 1024), "he"),
             (f"{ROI}.box_head.fc7.bias", (1024,), "small"),
             (f"{ROI}.box_predictor.cls_score.weight", (C, 1024), _gain(g["cls_score"], 1024)),
             (f"{ROI}.box_predictor.cls_score.bias", (C,), "small"),
             (f"{ROI}.box_predictor.bbox_pred.weight", (4 * C, 1024),
              _gain(g["box_bbox_pred"], 1024)),
             (f"{ROI}.box_predictor.bbox_pred.bias", (4 * C,), "small")]
    for i in range(1, 5):
        spec += _conv_spec(f"{ROI}.mask_head.mask_fcn{i}", FPN_C, FPN_C, 3)
    spec += [(f"{ROI}.mask_predictor.conv5_mask.weight", (FPN_C, FPN_C, 2, 2), "he"),
             (f"{ROI}.mask_predictor.conv5_mask.bias", (FPN_C,), "small")]
    spec += _conv_spec(f"{ROI}.mask_predictor.mask_fcn_logits", C, FPN_C, 1,
                       _gain(g["mask_fcn_logits"], FPN_C))
    return spec


# ---------------------------------------------------------------- backbone

def resized(h: int, w: int, settings: dict) -> Tuple[int, int]:
    m = _m(settings)
    scale = min(m["min_size"] / min(h, w), MAX_SIZE / max(h, w))
    return int(math.floor(h * scale)), int(math.floor(w * scale))


def transform(image: Tensor, settings: dict) -> Tensor:
    """One NHWC image (1, S, S, 3) -> the normalized, resized, padded
    (1, 3, h', w') batch."""
    x = image.permute(0, 3, 1, 2).float()
    mean = torch.tensor(MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(STD, device=x.device)[None, :, None, None]
    x = (x - mean) / std
    h, w = resized(x.shape[2], x.shape[3], settings)
    x = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)
    return F.pad(x, (0, -(-w // 32) * 32 - w, 0, -(-h // 32) * 32 - h))


def _bn(x: Tensor, w: Weights, prefix: str) -> Tensor:
    return batch_norm(x, w, prefix, False)


def body(w: Weights, x: Tensor, prec: Precision = FP32) -> List[Tensor]:
    """C2-C5 of ResNet-50 (torchvision's layout, frozen BatchNorm)."""
    h = prec.conv(x, w[f"{BODY}.conv1.weight"], 2, 3)
    h = F.max_pool2d(torch.relu(prec(_bn(h, w, f"{BODY}.bn1"))), 3, 2, 1)
    outs = []
    for s, n in enumerate(STAGES, start=1):
        for j in range(n):
            p = f"{BODY}.layer{s}.{j}"
            stride = 2 if (s > 1 and j == 0) else 1
            y = torch.relu(prec(_bn(prec.conv(h, w[f"{p}.conv1.weight"]), w, f"{p}.bn1")))
            y = torch.relu(prec(_bn(prec.conv(y, w[f"{p}.conv2.weight"], stride, 1), w,
                                    f"{p}.bn2")))
            y = prec(_bn(prec.conv(y, w[f"{p}.conv3.weight"]), w, f"{p}.bn3"))
            r = h
            if j == 0:
                r = prec(_bn(prec.conv(h, w[f"{p}.downsample.0.weight"], stride), w,
                             f"{p}.downsample.1"))
            h = torch.relu(prec(y + r))
        outs.append(h)
    return outs


def _conv_b(prec: Precision, x: Tensor, w: Weights, prefix: str, padding: int = 0) -> Tensor:
    y = prec.conv(x, w[f"{prefix}.weight"], 1, padding)
    return prec(y + w[f"{prefix}.bias"][None, :, None, None])


def fpn(w: Weights, cs: Sequence[Tensor], prec: Precision = FP32) -> List[Tensor]:
    """P2-P6."""
    last = _conv_b(prec, cs[-1], w, f"{FPN}.inner_blocks.3")
    out = [_conv_b(prec, last, w, f"{FPN}.layer_blocks.3", 1)]
    for i in range(len(cs) - 2, -1, -1):
        lat = _conv_b(prec, cs[i], w, f"{FPN}.inner_blocks.{i}")
        last = prec(lat + F.interpolate(last, size=lat.shape[-2:], mode="nearest"))
        out.insert(0, _conv_b(prec, last, w, f"{FPN}.layer_blocks.{i}", 1))
    out.append(F.max_pool2d(out[-1], 1, 2, 0))
    return out


def features(w: Weights, image: Tensor, settings: dict, prec: Precision = FP32
             ) -> Tuple[Tensor, List[Tensor]]:
    """(the transformed batch, P2-P6) of one NHWC image."""
    x = transform(image, settings)
    return x, fpn(w, body(w, prec(x), prec), prec)


# ---------------------------------------------------------------- boxes

def decode(deltas: Tensor, boxes: Tensor, weights: Sequence[float]) -> Tensor:
    """torchvision's `BoxCoder.decode_single`."""
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * widths
    cy = boxes[..., 1] + 0.5 * heights
    dx, dy = deltas[..., 0] / weights[0], deltas[..., 1] / weights[1]
    dw = torch.clamp(deltas[..., 2] / weights[2], max=CLIP)
    dh = torch.clamp(deltas[..., 3] / weights[3], max=CLIP)
    px, py = dx * widths + cx, dy * heights + cy
    pw, ph = torch.exp(dw) * widths, torch.exp(dh) * heights
    return torch.stack([px - 0.5 * pw, py - 0.5 * ph, px + 0.5 * pw, py + 0.5 * ph], -1)


def clip(boxes: Tensor, h: int, w: int) -> Tensor:
    return torch.stack([boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
                        boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)], -1)


def big_enough(boxes: Tensor, min_size: float) -> Tensor:
    return ((boxes[..., 2] - boxes[..., 0]) >= min_size) & (
        (boxes[..., 3] - boxes[..., 1]) >= min_size)


def nms(boxes: Tensor, scores: Tensor, threshold: float) -> Tensor:
    """torchvision's greedy `nms` loop (its CPU kernel) over one segment:
    the indices kept, by descending score, ties to the lower index. Its
    overlaps, inter / (area_i + area_j - inter) of box i before box j,
    are computed for every pair at once; the loop then reads them."""
    order = torch.sort(scores, descending=True, stable=True).indices
    b = boxes[order]
    x1, y1, x2, y2 = b.unbind(-1)
    areas = (x2 - x1) * (y2 - y1)
    w = torch.clamp(torch.minimum(x2[:, None], x2[None]) - torch.maximum(x1[:, None], x1[None]),
                    min=0)
    h = torch.clamp(torch.minimum(y2[:, None], y2[None]) - torch.maximum(y1[:, None], y1[None]),
                    min=0)
    inter = w * h
    over = (inter / (areas[:, None] + areas[None] - inter) > threshold).cpu().numpy()
    suppressed = np.zeros(len(order), dtype=bool)
    keep = []
    for a in range(len(order)):
        if suppressed[a]:
            continue
        keep.append(a)
        suppressed[a + 1:] |= over[a, a + 1:]
    return order[torch.tensor(keep, dtype=torch.long, device=boxes.device)]


def segment_keep(boxes: Tensor, scores: Tensor, valid: Tensor, threshold: float) -> Tensor:
    """Keep flags (N,) of one segment: `nms` of its valid boxes."""
    idx = torch.nonzero(valid).flatten()
    keep = torch.zeros_like(valid)
    if len(idx):
        keep[idx[nms(boxes[idx], scores[idx], threshold)]] = True
    return keep


def base_anchors(size: int, device) -> Tensor:
    ar = torch.tensor(RATIOS, dtype=torch.float32, device=device)
    h_r = torch.sqrt(ar)
    w_r = 1 / h_r
    ws = w_r * float(size)
    hs = h_r * float(size)
    return (torch.stack([-ws, -hs, ws, hs], 1) / 2).round()


def anchors(feats: Sequence[Tensor], padded: Tuple[int, int]) -> List[Tensor]:
    out = []
    for size, f in zip(SIZES, feats):
        gh, gw = f.shape[-2:]
        sy, sx = padded[0] // gh, padded[1] // gw
        ys = torch.arange(gh, device=f.device) * sy
        xs = torch.arange(gw, device=f.device) * sx
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        shifts = torch.stack([xx, yy, xx, yy], -1).reshape(-1, 1, 4)
        out.append((shifts + base_anchors(size, f.device)[None]).reshape(-1, 4))
    return out


# ---------------------------------------------------------------- RPN

def rpn_head(w: Weights, feats: Sequence[Tensor], prec: Precision = FP32
             ) -> Tuple[List[Tensor], List[Tensor]]:
    """Per level: objectness (1, H W A) and deltas (1, H W A, 4)."""
    objs, deltas = [], []
    for f in feats:
        t = torch.relu(_conv_b(prec, f, w, f"{RPN}.conv", 1))
        o = _conv_b(prec, t, w, f"{RPN}.cls_logits")
        d = _conv_b(prec, t, w, f"{RPN}.bbox_pred")
        B, A, H, W = o.shape
        objs.append(o.permute(0, 2, 3, 1).reshape(B, -1))
        deltas.append(d.view(B, A, 4, H, W).permute(0, 3, 4, 1, 2).reshape(B, -1, 4))
    return objs, deltas


def proposals(objs, deltas, feats, padded, image, settings) -> dict:
    """The RPN's selection of one image: the segments (L, K) of the NMS, its
    keep flags, and the proposals (N, 4) with their valid flags."""
    m = _m(settings)
    K, N = m["rpn_pre_nms_top_n"], m["rpn_post_nms_top_n"]
    boxes, scores, valid = [], [], []
    for o, d, a in zip(objs, deltas, anchors(feats, padded)):
        k = min(K, o.shape[1])
        top, idx = torch.topk(o[0], k)
        bx = clip(decode(d[0][idx], a[idx], (1.0, 1.0, 1.0, 1.0)), *image)
        ok = big_enough(bx, RPN_MIN_SIZE)
        pad = K - k
        boxes.append(F.pad(bx, (0, 0, 0, pad)))
        scores.append(F.pad(torch.sigmoid(top), (0, pad)))
        valid.append(F.pad(ok, (0, pad)))
    boxes, scores, valid = torch.stack(boxes), torch.stack(scores), torch.stack(valid)
    keep = torch.stack([segment_keep(b, s, v, RPN_NMS_THRESH)
                        for b, s, v in zip(boxes, scores, valid)])
    order, kept = first_kept(keep.reshape(-1), scores.reshape(-1), N)
    props = torch.where(kept[:, None], boxes.reshape(-1, 4)[order], 0.0)
    return {"rpn_boxes": boxes, "rpn_scores": scores, "rpn_valid": valid, "rpn_keep": keep,
            "proposals": props, "proposals_valid": kept}


def first_kept(keep: Tensor, scores: Tensor, n: int) -> Tuple[Tensor, Tensor]:
    key = torch.where(keep, scores, float("-inf"))
    order = torch.sort(key, descending=True, stable=True).indices[:n]
    return order, keep[order]


# ---------------------------------------------------------------- RoI heads

def level_mapper(boxes: Tensor, faults: Sequence[str] = ()) -> Tensor:
    """torchvision's `LevelMapper` (levels 2-5) as indices 0-3."""
    s = torch.sqrt((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))
    lvl = torch.floor(4 + torch.log2(s / 224) + torch.tensor(1e-6, dtype=s.dtype))
    lvl = torch.clamp(lvl, 2, 5).long() - 2
    if "level_off_by_one" in faults:  # every region a level up, P5's kept
        lvl = torch.clamp(lvl + 1, max=3)
    return lvl


def _bilinear(f: Tensor, y: Tensor, x: Tensor) -> Tensor:
    """torchvision's `bilinear_interpolate` of map f (C, H, W) at points
    y, x (P,) -> (C, P)."""
    H, W = f.shape[1:]
    out_of = (y < -1.0) | (y > H) | (x < -1.0) | (x > W)
    y, x = y.clamp(min=0), x.clamp(min=0)
    yl, xl = y.long(), x.long()
    ylast, xlast = yl >= H - 1, xl >= W - 1
    yl = torch.where(ylast, H - 1, yl)
    xl = torch.where(xlast, W - 1, xl)
    yh = torch.where(ylast, yl, yl + 1)
    xh = torch.where(xlast, xl, xl + 1)
    y = torch.where(ylast, yl.float(), y)
    x = torch.where(xlast, xl.float(), x)
    ly, lx = y - yl, x - xl
    hy, hx = 1.0 - ly, 1.0 - lx
    val = (hy * hx * f[:, yl, xl] + hy * lx * f[:, yl, xh]) + ly * hx * f[:, yh, xl] \
        + ly * lx * f[:, yh, xh]
    return torch.where(out_of, 0.0, val)


def roi_align(maps: Sequence[Tensor], boxes: Tensor, level: Tensor, image: Tuple[int, int],
              size: int, sampling: int) -> Tensor:
    """torchvision's `MultiScaleRoIAlign` of one image's boxes (R, 4) ->
    (R, C, size, size): each region on its level (the regions of a level
    at once), bins of S x S samples, each sample `_bilinear`."""
    C = maps[0].shape[1]
    out = torch.zeros(boxes.shape[0], C, size, size, device=boxes.device)
    p = torch.arange(size, device=boxes.device, dtype=torch.float32)
    for lv, f in enumerate(maps):
        rows = torch.nonzero(level == lv).flatten()
        if not len(rows):
            continue
        f = f[0].float()
        scale = 2.0 ** round(math.log2(f.shape[1] / image[0]))
        x1, y1, x2, y2 = (boxes[rows] * scale).unbind(-1)
        bw = torch.clamp(x2 - x1, min=1.0) / size
        bh = torch.clamp(y2 - y1, min=1.0) / size
        acc = torch.zeros(len(rows), C, size, size, device=boxes.device)
        for iy in range(sampling):
            ys = y1[:, None] + p * bh[:, None] + (iy + 0.5) * bh[:, None] / sampling
            for ix in range(sampling):
                xs = x1[:, None] + p * bw[:, None] + (ix + 0.5) * bw[:, None] / sampling
                yy = ys[:, :, None].expand(-1, -1, size)
                xx = xs[:, None, :].expand(-1, size, -1)
                v = _bilinear(f, yy.reshape(-1), xx.reshape(-1))  # (C, R size size)
                acc = acc + v.reshape(C, len(rows), size, size).transpose(0, 1)
        out[rows] = acc / (sampling * sampling)
    return out


def _linear(prec: Precision, x: Tensor, w: Weights, prefix: str) -> Tensor:
    return prec.linear(x, w[f"{prefix}.weight"], w[f"{prefix}.bias"])


def box_branch(w: Weights, feats: Sequence[Tensor], props: Tensor, image: Tuple[int, int],
               prec: Precision = FP32, faults: Sequence[str] = ()) -> Tuple[Tensor, Tensor]:
    """Class logits (N, 91) and deltas (N, 364) of one image's proposals."""
    S = 1 if "roi_align_sr1" in faults else 2
    return box_head(w, roi_align(feats[:4], props, level_mapper(props, faults), image, 7, S),
                    prec)


def box_head(w: Weights, x: Tensor, prec: Precision = FP32) -> Tuple[Tensor, Tensor]:
    """The pooled regions (N, 256, 7, 7) -> class logits and deltas."""
    x = torch.relu(_linear(prec, prec(x.flatten(1)), w, f"{ROI}.box_head.fc6"))
    x = torch.relu(_linear(prec, x, w, f"{ROI}.box_head.fc7"))
    return (_linear(prec, x, w, f"{ROI}.box_predictor.cls_score"),
            _linear(prec, x, w, f"{ROI}.box_predictor.bbox_pred"))


def postprocess(logits: Tensor, deltas: Tensor, props: Tensor, props_valid: Tensor,
                image: Tuple[int, int], settings: dict, faults: Sequence[str] = ()) -> dict:
    """torchvision's `postprocess_detections` of one image, padded to the
    detection count; the final NMS's candidates (N, C - 1) and keep flags."""
    m = _m(settings)
    N, C = logits.shape
    scores = torch.softmax(logits, -1)[:, 1:]
    boxes = clip(decode(deltas.reshape(N, C, 4), props[:, None], (10.0, 10.0, 5.0, 5.0)),
                 *image)[:, 1:]
    valid = ((scores > BOX_SCORE_THRESH) & big_enough(boxes, BOX_MIN_SIZE)
             & props_valid[:, None])
    if "class_agnostic_nms" in faults:
        keep = segment_keep(boxes.reshape(-1, 4), scores.reshape(-1), valid.reshape(-1),
                            BOX_NMS_THRESH).reshape(N, C - 1)
    else:
        keep = torch.stack([segment_keep(boxes[:, c], scores[:, c], valid[:, c],
                                         BOX_NMS_THRESH) for c in range(C - 1)], 1)
    order, kept = first_kept(keep.reshape(-1), scores.reshape(-1), m["box_detections_per_img"])
    det = torch.where(kept[:, None], boxes.reshape(-1, 4)[order], 0.0)
    return {"det_boxes": boxes, "det_scores": scores, "det_valid": valid, "det_keep": keep,
            "boxes_resized": det, "scores": torch.where(kept, scores.reshape(-1)[order], 0.0),
            "labels": order % (C - 1) + 1, "valid": kept}


def mask_probs(w: Weights, feats: Sequence[Tensor], boxes: Tensor, labels: Tensor,
               valid: Tensor, image: Tuple[int, int], prec: Precision = FP32,
               faults: Sequence[str] = ()) -> Tensor:
    """(D, 28, 28) sigmoid of each detection's label logits (zero where not
    valid)."""
    S = 1 if "roi_align_sr1" in faults else 2
    x = roi_align(feats[:4], boxes, level_mapper(boxes, faults), image, 14, S)
    return torch.where(valid[:, None, None], mask_head(w, x, labels, prec), 0.0)


def mask_head(w: Weights, x: Tensor, labels: Tensor, prec: Precision = FP32) -> Tensor:
    """The pooled detections (D, 256, 14, 14) -> the sigmoid of each one's
    label logits (D, 28, 28)."""
    for i in range(1, 5):
        x = torch.relu(_conv_b(prec, x, w, f"{ROI}.mask_head.mask_fcn{i}", 1))
    cw = w[f"{ROI}.mask_predictor.conv5_mask.weight"]
    x = prec(F.conv_transpose2d(prec(x), prec(cw), w[f"{ROI}.mask_predictor.conv5_mask.bias"],
                                2))
    x = _conv_b(prec, torch.relu(x), w, f"{ROI}.mask_predictor.mask_fcn_logits")
    return torch.sigmoid(x[torch.arange(len(labels), device=x.device), labels])


def paste(masks: Tensor, boxes: Tensor, size: Tuple[int, int]) -> Tensor:
    """torchvision's `paste_masks_in_image`, one box at a time: (D, M, M) in
    (D, 4) boxes -> (D, H, W)."""
    M = masks.shape[-1]
    scale = float(M + 2) / M
    padded = F.pad(masks, (1, 1, 1, 1))
    w_half = (boxes[:, 2] - boxes[:, 0]) * 0.5
    h_half = (boxes[:, 3] - boxes[:, 1]) * 0.5
    x_c = (boxes[:, 2] + boxes[:, 0]) * 0.5
    y_c = (boxes[:, 3] + boxes[:, 1]) * 0.5
    w_half *= scale
    h_half *= scale
    ex = torch.stack([x_c - w_half, y_c - h_half, x_c + w_half, y_c + h_half], 1).long().cpu()
    H, W = size
    out = torch.zeros(len(masks), H, W, device=masks.device)
    for i in range(len(masks)):
        b = [int(v) for v in ex[i]]
        w, h = max(b[2] - b[0] + 1, 1), max(b[3] - b[1] + 1, 1)
        m = F.interpolate(padded[i][None, None], size=(h, w), mode="bilinear",
                          align_corners=False)[0, 0]
        x0, x1 = max(b[0], 0), min(b[2] + 1, W)
        y0, y1 = max(b[1], 0), min(b[3] + 1, H)
        if x1 > x0 and y1 > y0:
            out[i, y0:y1, x0:x1] = m[y0 - b[1]:y1 - b[1], x0 - b[0]:x1 - b[0]]
    return out


def resize_ratios(size: Tuple[int, int], image: Tuple[int, int]) -> Tuple[float, float]:
    """torchvision's fp32 ratios of the input size to the resized one."""
    return tuple(float(torch.tensor(a, dtype=torch.float32) / torch.tensor(b, dtype=torch.float32))
                 for a, b in zip(size, image))


def scale_boxes(boxes: Tensor, size: Tuple[int, int], image: Tuple[int, int]) -> Tensor:
    rh, rw = resize_ratios(size, image)
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1 * rw, y1 * rh, x2 * rw, y2 * rh], -1)


# ---------------------------------------------------------------- the model

def detect(w: Weights, image: Tensor, settings: dict, prec: Precision = FP32,
           faults: Sequence[str] = ()) -> dict:
    """Mask R-CNN on one canonical NHWC image (1, S, S, 3): its
    intermediates and outputs in the canonical frame (boxes at the input
    size, masks pasted there)."""
    S = image.shape[1:3]
    x, feats = features(w, image, settings, prec)
    image_hw = resized(*S, settings)
    objs, deltas = rpn_head(w, feats, prec)
    out = {"transformed": x, "features": feats, "rpn_objectness": objs, "rpn_deltas": deltas}
    out.update(proposals(objs, deltas, feats, tuple(x.shape[-2:]), image_hw, settings))
    logits, box_deltas = box_branch(w, feats, out["proposals"], image_hw, prec, faults)
    out.update(class_logits=logits, box_regression=box_deltas)
    out.update(postprocess(logits, box_deltas, out["proposals"], out["proposals_valid"],
                           image_hw, settings, faults))
    out["mask_probs"] = mask_probs(w, feats, out["boxes_resized"], out["labels"], out["valid"],
                                   image_hw, prec, faults)
    out["boxes"] = scale_boxes(out["boxes_resized"], S, image_hw)
    out["probs"] = paste(out["mask_probs"], out["boxes"], S)
    return out


def serve(w: Weights, x: Tensor, settings: dict, follow: Optional[Tensor] = None,
          prec: Precision = FP32, faults: Sequence[str] = ()) -> dict:
    """Eval of a batch of NHWC images (B, S, S, 3): energies, their scale,
    the element in degrees (its own argmax, or `follow`, the program's),
    the canonical images, and per image (lists) `detect`'s record plus the
    input-frame boxes and probabilities (`boxes_input`, `probs_input`).
    Under a lower precision the images are rounded to it first."""
    out = canonicalize(w, x, settings, follow, prec)
    idx, xc, S = out["turns"], out["canonical"], x.shape[2]
    images = []
    for b in range(x.shape[0]):
        rec = detect(w, xc[b:b + 1], settings, prec, faults)
        rec["boxes_input"] = turn_back(rec["boxes"], int(idx[b]), S)
        rec["probs_input"] = torch.rot90(rec["probs"], int(idx[b]), dims=(1, 2))
        images.append(rec)
    out["images"] = images
    return out


def turn_back(boxes: Tensor, turns: int, size: int) -> Tensor:
    """(D, 4) boxes of a canonical image to those of the input image
    `torch.rot90(canonical, turns)` (`canon.turn_boxes` by -turns)."""
    return canon.turn_boxes(boxes[None], torch.tensor([(-turns) % 4]), size)[0]


def canonicalize(w: Weights, x: Tensor, settings: dict, follow: Optional[Tensor] = None,
                 prec: Precision = FP32) -> dict:
    """The C4 canonicalizer of a batch (B, S, S, 3): energies, their scale,
    the quarter turns (B,) on the host (the argmax, or `follow`, the
    program's element in degrees), the element in degrees and the
    canonical images (the images turned back by it, after rounding to
    `prec`)."""
    G = canon._hp(settings)["num_rotations"]
    if G != 4:
        raise ValueError("the reference is written for C4")
    x = prec(x)
    y = canon.energy_map(w, x, settings, prec)
    scale = y.float().pow(2).mean().sqrt()
    e = prec(canon._fiber_mean(y, G))
    del y
    if follow is None:
        idx = torch.argmax(e, dim=-1).cpu()
    else:
        idx = torch.round(follow.cpu().float() / (360.0 / G)).long() % G
    xc = torch.stack([torch.rot90(x[b], -int(idx[b]), dims=(0, 1)) for b in range(x.shape[0])])
    return {"energies": e, "energy_scale": scale, "turns": idx,
            "element": idx.float() * (360.0 / G), "canonical": xc}


element_gaps = canon.element_gaps


def teacher(w: Weights, canonical: Tensor, settings: dict) -> dict:
    """The fp32 reference's pyramid and RPN head outputs on one canonical
    image the program made (1, S, S, 3)."""
    x, feats = features(w, canonical.float(), settings)
    objs, deltas = rpn_head(w, feats)
    return {"transformed": x, "features": feats, "rpn_objectness": objs, "rpn_deltas": deltas}
