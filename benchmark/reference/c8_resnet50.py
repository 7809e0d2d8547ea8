"""Plain reference of the `c8-resnet50` configuration.

A C8 group-equivariant energy network (a lifting convolution whose filter
is rotated to the eight angles 45 g, folded with a 2 x 2 average pool;
fiber BatchNorm; ReLU; dropout 0.5 in training; a group convolution whose
filters are rotated and whose fiber is rolled by the element; the mean over
channels and space) on the centre-cropped, resized image picks an element
of C8 by argmax (straight-through one-hot in training); the image is
rotated back by it, and ResNet-50 classifies the result. Loss: the
cross-entropy of the logits plus `prior_weight` times the cross-entropy of
the energies against the identity element.

Eval selects the largest energy; `follow` makes the reference take the
program's element instead, so that its canonical image and logits are
those of the element the program chose, and `element_gaps` holds the
program's energies, whose argmax that element is, to the reference's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.common import (
    FP32,
    Precision,
    Weights,
    batch_norm,
    bn_spec,
    crop_and_resize,
    discrete_rotation_candidates,
    dropout_keep,
    resnet50,
    resnet50_spec,
    rotation_tap_matrix,
    train_steps,
)

Tensor = torch.Tensor

NET = "canonicalizer.canonicalization_network"
PRED = "prediction_network"
LIFT = f"{NET}.RotationEquivariantConvLift_0"
GCONV = f"{NET}.RotationEquivariantConv_0"


def _hp(settings: dict) -> dict:
    return settings["canonicalization"]["network_hyperparams"]


def param_spec(settings: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every weight and statistic, in order."""
    h = _hp(settings)
    K, C, G = h["kernel_size"], h["out_channels"], h["num_rotations"]
    if h["num_layers"] != 2 or h["group_type"] != "rotation":
        raise ValueError("the reference is written for 2 layers of C_n")
    ci = settings["dataset"]["in_channels"]
    size = settings["dataset"]["image_size"]
    spec = [(f"{LIFT}.weights", (K, K, ci, C), "fan_in_last"),
            (f"{LIFT}.bias", (C,), "small")]
    spec += bn_spec(f"{NET}.FiberBatchNorm_0.BatchNorm_0", C)
    spec += [(f"{GCONV}.weights", (K, K, C, G, C), "fan_in_last"),
             (f"{GCONV}.bias", (C,), "small")]
    return spec + resnet50_spec(PRED, settings["dataset"]["num_classes"], size <= 64)


def _angles(G: int) -> List[float]:
    return [360.0 * g / G for g in range(G)]


def energy_map(w: Weights, x: Tensor, settings: dict, training: bool = False,
               generator: Optional[torch.Generator] = None,
               prec: Precision = FP32) -> Tensor:
    """(B, C * G, H', W') output of the group convolution, whose mean over
    channels and space is the energies, of NHWC images at full size."""
    h = _hp(settings)
    K, C, G = h["kernel_size"], h["out_channels"], h["num_rotations"]
    cfg = settings["canonicalization"]
    z = crop_and_resize(x, cfg["input_crop_ratio"], cfg["resize_shape"])
    z = z.permute(0, 3, 1, 2)
    T = torch.from_numpy(rotation_tap_matrix(K, _angles(G))).to(x.device)
    # lifting filters: out channel c * G + g is filter c rotated by angle g
    wl = w[f"{LIFT}.weights"]  # (K, K, Ci, C)
    ci = wl.shape[2]
    rot = torch.einsum("gpq,qf->gpf", T, wl.reshape(K * K, ci * C))
    bank = rot.reshape(G, K, K, ci, C).permute(4, 0, 3, 1, 2).reshape(C * G, ci, K, K)
    y = prec.conv(z, bank) + w[f"{LIFT}.bias"].repeat_interleave(G)[None, :, None, None]
    if h.get("fused_pool_lift") or h.get("pool_after_lift"):
        y = F.avg_pool2d(y, 2, 2)
    B, _, Hh, Ww = y.shape
    bn = batch_norm(y.reshape(B, C, G * Hh, Ww), w,
                    f"{NET}.FiberBatchNorm_0.BatchNorm_0", training)
    y = torch.relu(prec(bn.reshape(B, C * G, Hh, Ww)))
    if training:
        keep = dropout_keep(tuple(y.shape), generator, y.device)
        y = torch.where(keep, y / 0.5, torch.zeros_like(y))
    # group conv: output element j reads input fiber k through the filter
    # of fiber (k - j) mod G, rotated by angle j
    wg = w[f"{GCONV}.weights"]  # (K, K, Ci, G_in, Co)
    j = torch.arange(G, device=x.device)
    perm = (j[None, :] - j[:, None]) % G  # [j, k]
    wp = wg[:, :, :, perm, :]  # (K, K, Ci, G_out, G_in, Co)
    wp = wp.permute(3, 0, 1, 2, 4, 5).reshape(G, K * K, C * G * C)
    rot = torch.einsum("gpq,gqf->gpf", T, wp).reshape(G, K, K, C, G, C)
    bank = rot.permute(5, 0, 3, 4, 1, 2).reshape(C * G, C * G, K, K)
    return prec.conv(y, bank) + w[f"{GCONV}.bias"].repeat_interleave(G)[None, :, None, None]


def energies(w: Weights, x: Tensor, settings: dict, training: bool = False,
             generator: Optional[torch.Generator] = None,
             prec: Precision = FP32) -> Tensor:
    """(B, G) energies of NHWC images at full size, rounded to `prec` as
    the program hands its energies on in its compute dtype."""
    y = energy_map(w, x, settings, training, generator, prec)
    return prec(_fiber_mean(y, _hp(settings)["num_rotations"]))


def _fiber_mean(y: Tensor, G: int) -> Tensor:
    """(B, C * G, H, W), channel c * G + g -> (B, G): the mean over c and
    space."""
    return y.reshape(y.shape[0], -1, G, y.shape[2] * y.shape[3]).mean(dim=(1, 3))


def canonical_images(x: Tensor, onehot: Tensor, G: int) -> Tensor:
    """sum_g onehot[b, g] rotate(x[b], -360 g / G): the canonical image of
    a one-hot (the hard select of an exact one-hot)."""
    out = None
    for g, cand in enumerate(discrete_rotation_candidates(x, G, -1.0)):
        term = cand * onehot[:, g, None, None, None]
        out = term if out is None else out + term
    return out


def serve(w: Weights, x: Tensor, settings: dict, follow: Optional[Tensor] = None,
          prec: Precision = FP32) -> Dict[str, Tensor]:
    """Eval of one batch: energies, their scale (the root mean square of
    the values they are means of), the element in degrees (its own argmax,
    or `follow`, the program's), the canonical image and the logits.
    Under a lower precision the images are rounded to it first, as the
    program rounds them to its compute dtype."""
    G = _hp(settings)["num_rotations"]
    x = prec(x)
    y = energy_map(w, x, settings, prec=prec)
    scale = y.float().pow(2).mean().sqrt()
    e = prec(_fiber_mean(y, G))
    del y
    if follow is None:
        idx = torch.argmax(e, dim=-1)
    else:  # the program's element in degrees
        idx = torch.round(follow.to(x.device).float() / (360.0 / G)).long() % G
    xc = canonical_images(x, F.one_hot(idx, G).to(x.dtype), G)
    logits = resnet50(w, xc, PRED, small_images=settings["dataset"]["image_size"] <= 64,
                      prec=prec)
    return {"energies": e, "energy_scale": scale, "element": idx.float() * (360.0 / G),
            "canonical": xc, "logits": logits}


def trainable(settings: dict) -> List[str]:
    """The leaves the optimizer moves: every weight, no statistic."""
    return [n for n, _, init in param_spec(settings)
            if init not in ("bn_mean", "bn_var")]


def loss(w: Weights, x: Tensor, labels: Tensor, generator: torch.Generator,
         settings: dict, prec: Precision = FP32, rows: Optional[slice] = None,
         remat: bool = False, follow: Optional[Tensor] = None,
         chosen: Optional[list] = None) -> Tensor:
    """The training loss of one batch (training-mode statistics, dropout
    from `generator`, straight-through selection). The hard one-hot is the
    argmax of the energies, or the elements `follow` (degrees) chosen by
    what is judged; `chosen` receives the elements used. `rows` keeps only
    those rows in the means (a planted fault)."""
    G = _hp(settings)["num_rotations"]
    beta = settings["canonicalization"]["beta"]
    e = energies(w, x, settings, training=True, generator=generator, prec=prec)
    idx = (torch.argmax(e, dim=-1) if follow is None
           else torch.round(follow.to(e.device).float() / (360.0 / G)).long() % G)
    if chosen is not None:
        chosen.append((idx.float() * (360.0 / G)).detach())
    hard = F.one_hot(idx, G).to(e.dtype)
    soft = torch.softmax(beta * e, dim=-1)
    onehot = hard + soft - soft.detach()
    xc = canonical_images(x, onehot, G)
    logits = resnet50(w, xc, PRED, training=True,
                      small_images=settings["dataset"]["image_size"] <= 64, prec=prec,
                      remat=remat)
    r = slice(None) if rows is None else rows
    lw = settings["experiment"]["loss"]
    task = F.cross_entropy(logits[r], labels[r].long())
    prior = -torch.mean(F.log_softmax(e[r], dim=-1)[:, 0])
    return lw["task_weight"] * task + lw["prior_weight"] * prior


def train(w: Weights, batches, generator: torch.Generator, settings: dict,
          optimizer: dict, steps: int = 3, prec: Precision = FP32,
          rows: Optional[slice] = None, remat: bool = False,
          follow: Optional[list] = None) -> dict:
    """`steps` AdamW steps (`optimizer`: lr, weight_decay) from `w` on
    `batches` [(images, labels)], selecting the elements `follow[i]` at
    step i where given; the result's "elements" are those used."""
    opt = optimizer
    chosen: list = []

    def step_loss(p, x, y, g):
        f = None if follow is None else follow[len(chosen)]
        return loss(p, x, y, g, settings, prec, rows, remat, f, chosen)

    out = train_steps(w, trainable(settings), step_loss, batches, generator,
                      opt["lr"], opt["weight_decay"], steps)
    out["elements"] = chosen
    return out


def element_gaps(out: Dict[str, Tensor], follow: Tensor,
                 energies: Optional[Tensor]) -> Dict[str, float]:
    """The program's energies `energies` (B, G) of the images of `out`
    (from `serve`) against the reference's: `energy_err`, the root mean
    square of their difference over the energies' scale (the root mean
    square of the values they are means of, to which rounding in the
    network is proportional; the energies themselves nearly cancel, by a
    share that the seed moves). The element is the argmax of these
    energies; `follow` is not read.

    Numbers of the element alone (the share of images whose element is
    not the reference's argmax, the reference's shortfall of the chosen
    element, its largest or its mean) are not compared: how many near
    ties a seed has moves them more than the precision does, so on some
    seeds they read as high in the bf16 program as the lowest fp8 control
    does (PERF.md, PR 18)."""
    e = out["energies"].float()
    if energies is None:
        return {"energy_err": math.inf}
    d = energies.to(e.device).float() - e
    scale = out["energy_scale"].float().clamp(min=1e-30)
    return {"energy_err": float(d.pow(2).mean().sqrt() / scale)}
