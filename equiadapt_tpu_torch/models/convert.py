"""Convert torchvision classification checkpoints onto the port's networks.

Counterpart of `equiadapt_tpu/models/convert.py`. The reference's central
workflow adapts a *frozen pretrained* prediction network through learned
canonicalization and a prior; its classification path loads torchvision
weights with ``weights="DEFAULT"`` (reference
examples/images/classification/model_utils.py:35-60, freeze at :66-71).
With no network, conversion is a utility: given a local ``state_dict``
(``torch.load`` of a torchvision ``resnet18/50``, ``wide_resnet50_2/101_2``
or ``vit_b_16`` checkpoint), map it onto the matching port module of
`models/resnet.py` / `models/vit.py`.

The port's networks carry Flax names in torch layout (`Conv_0`,
`Bottleneck_7`, `MultiHeadDotProductAttention_0.query`; OIHW convolution
weights, (out, in) linear weights), so a checkpoint tensor lands on its
template tensor with no transpose:

  * ``conv1`` / ``layer{s}.{j}.conv{c}`` / ``downsample.0`` -> ``Conv_*``;
  * BatchNorm weight, bias and running statistics -> the port BatchNorm's
    tensors of the same names;
  * a fused ViT ``in_proj`` (3C, C) splits into the query, key and value
    weights, (C, C) each.

The rules are the JAX converter's. Every checkpoint key must be consumed
(``num_batches_tracked`` excepted); a leaf of the wrong shape raises unless
it is one of the reference's two surgeries, which keep the template's fresh
tensors: the CIFAR stem (model_utils.py:61-65 swaps conv1 for a fresh 3x3)
and the classification head (model_utils.py:73-79 replaces fc for the
dataset's class count). A headless template (`num_classes=None`, the
MaskRCNNLite trunk) consumes ``fc`` and drops it.

The converters take a template state dict (``module.state_dict()``) and
return a new one with every mappable tensor replaced, in the template's
dtype and device; `apply_pretrained_to_state` loads it into a submodule of
a train state in place (the JAX function returns a new state).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Union

import torch

Tensor = torch.Tensor

__all__ = [
    "convert_resnet_checkpoint",
    "convert_vit_checkpoint",
    "load_torch_state_dict",
    "load_pretrained_prediction",
    "apply_pretrained_to_state",
]

_BN = ("weight", "bias", "running_mean", "running_var")


class _Consumer:
    """Tracks which checkpoint keys were used; raises on leftovers."""

    def __init__(self, state_dict: Mapping[str, Any]):
        self.sd = state_dict
        self.used: set = set()

    def __contains__(self, key: str) -> bool:
        return key in self.sd

    def take(self, key: str) -> Tensor:
        self.used.add(key)
        return torch.as_tensor(self.sd[key])

    def finish(self) -> None:
        leftovers = [
            k for k in self.sd
            if k not in self.used and not k.endswith("num_batches_tracked")
        ]
        if leftovers:
            raise ValueError(
                f"checkpoint keys not consumed by the converter "
                f"(unknown architecture variant?): {sorted(leftovers)[:10]}"
                + ("..." if len(leftovers) > 10 else "")
            )


def _put(out: Dict[str, Tensor], key: str, value: Tensor, *,
         allow_skip: bool = False) -> bool:
    """Place `value` on the template tensor `key` in its dtype and device;
    returns False when the shapes differ and `allow_skip` keeps the fresh
    template tensor (the reference's stem and head surgeries)."""
    dst = out[key]
    if tuple(value.shape) != tuple(dst.shape):
        if allow_skip:
            return False
        raise ValueError(
            f"{key}: checkpoint shape {tuple(value.shape)} vs template "
            f"{tuple(dst.shape)}"
        )
    out[key] = value.detach().to(dtype=dst.dtype, device=dst.device).clone()
    return True


def _put_bn(out: Dict[str, Tensor], sd: _Consumer, dst: str, src: str) -> None:
    for name in _BN:
        _put(out, f"{dst}.{name}", sd.take(f"{src}.{name}"))


def _fresh(template: Mapping[str, Tensor]) -> Dict[str, Tensor]:
    return {k: v.detach().clone() for k, v in template.items()}


def convert_resnet_checkpoint(state_dict: Mapping[str, Any],
                              template: Mapping[str, Tensor]) -> Dict[str, Tensor]:
    """Map a torchvision ResNet ``state_dict`` onto a port ResNet's.

    Args:
        state_dict: torchvision ``resnet18/34/50/101 / wide_resnet50_2/...``
            weights (keys ``conv1.weight``, ``layer{i}.{j}.conv{k}.weight``,
            ``...downsample.0/1``, ``fc.weight``).
        template: the state dict of a `models.resnet.ResNet`, which decides
            the block type (BasicBlock / Bottleneck), the stage sizes and
            the surgeries.

    Returns:
        A new state dict with every mappable tensor replaced. A CIFAR-stem
        (``small_images=True``) or replaced-head template keeps its fresh
        tensors, as the reference does after loading pretrained weights.
    """
    out = _fresh(template)
    sd = _Consumer(state_dict)
    blocks = sorted(
        {k.split(".")[0] for k in out
         if k.startswith(("Bottleneck_", "BasicBlock_"))},
        key=lambda s: int(s.split("_")[1]),
    )
    if not blocks:
        raise ValueError("template has no ResNet blocks — wrong state dict?")
    convs_per_block = 3 if blocks[0].startswith("Bottleneck") else 2

    # stem: conv1 kept fresh for the CIFAR 3x3 stem; bn1 converts either way
    # (the reference surgery replaces the conv only)
    _put(out, "Conv_0.weight", sd.take("conv1.weight"), allow_skip=True)
    _put_bn(out, sd, "BatchNorm_0", "bn1")

    b = 0
    for stage in (1, 2, 3, 4):
        j = 0
        while f"layer{stage}.{j}.conv1.weight" in sd:
            if b >= len(blocks):
                raise ValueError(
                    f"checkpoint has more blocks than the template's "
                    f"{len(blocks)} — architecture mismatch (stage sizes / depth)")
            blk, pre = blocks[b], f"layer{stage}.{j}"
            for c in range(convs_per_block):
                _put(out, f"{blk}.Conv_{c}.weight", sd.take(f"{pre}.conv{c + 1}.weight"))
                _put_bn(out, sd, f"{blk}.BatchNorm_{c}", f"{pre}.bn{c + 1}")
            if f"{pre}.downsample.0.weight" in sd:
                conv = f"{blk}.Conv_{convs_per_block}.weight"
                if conv not in out:
                    raise ValueError(
                        f"checkpoint has a downsample at {pre} but template "
                        f"block {blk} has none")
                _put(out, conv, sd.take(f"{pre}.downsample.0.weight"))
                _put_bn(out, sd, f"{blk}.BatchNorm_{convs_per_block}",
                        f"{pre}.downsample.1")
            j += 1
            b += 1
    if b != len(blocks):
        raise ValueError(
            f"checkpoint has {b} blocks but template has {len(blocks)} "
            "— architecture mismatch (stage sizes / depth)")

    # head: kept fresh when the template's class count differs; a headless
    # template consumes fc and drops it
    if "fc.weight" in sd:
        w, bias = sd.take("fc.weight"), sd.take("fc.bias")
        if "Dense_0.weight" in out and _put(out, "Dense_0.weight", w, allow_skip=True):
            _put(out, "Dense_0.bias", bias)
    sd.finish()
    return out


def convert_vit_checkpoint(state_dict: Mapping[str, Any],
                           template: Mapping[str, Tensor]) -> Dict[str, Tensor]:
    """Map a torchvision ``vit_b_16``-family ``state_dict`` onto a port
    `models.vit.ViT`'s state dict (reference model_utils.py:48-60).

    Accepts both torchvision MLP namings (``mlp.0/mlp.3`` and the pre-0.13
    ``mlp.linear_1/linear_2``). The classification head is kept fresh when
    the template's class count differs."""
    out = _fresh(template)
    sd = _Consumer(state_dict)

    _put(out, "Conv_0.weight", sd.take("conv_proj.weight"))
    _put(out, "Conv_0.bias", sd.take("conv_proj.bias"))
    _put(out, "cls_token", sd.take("class_token"))
    pos = sd.take("encoder.pos_embedding")
    if tuple(pos.shape) != tuple(out["pos_embedding"].shape):
        raise ValueError(
            f"pos_embedding mismatch: checkpoint {tuple(pos.shape)} vs template "
            f"{tuple(out['pos_embedding'].shape)} — image_size/patch_size differ")
    _put(out, "pos_embedding", pos)

    i = 0
    while f"encoder.layers.encoder_layer_{i}.ln_1.weight" in sd:
        pre, blk = f"encoder.layers.encoder_layer_{i}", f"EncoderBlock_{i}"
        if f"{blk}.LayerNorm_0.weight" not in out:
            raise ValueError(f"checkpoint layer {i} has no template block — depth mismatch")
        for ln_t, ln_p in (("ln_1", "LayerNorm_0"), ("ln_2", "LayerNorm_1")):
            _put(out, f"{blk}.{ln_p}.weight", sd.take(f"{pre}.{ln_t}.weight"))
            _put(out, f"{blk}.{ln_p}.bias", sd.take(f"{pre}.{ln_t}.bias"))
        mha = f"{blk}.MultiHeadDotProductAttention_0"
        C = out[f"{mha}.query.weight"].shape[1]
        in_w = sd.take(f"{pre}.self_attention.in_proj_weight")  # (3C, C)
        in_b = sd.take(f"{pre}.self_attention.in_proj_bias")
        if tuple(in_w.shape) != (3 * C, C) or tuple(in_b.shape) != (3 * C,):
            raise ValueError(
                f"{pre}.self_attention.in_proj: checkpoint {tuple(in_w.shape)} / "
                f"{tuple(in_b.shape)} vs template {(3 * C, C)} / {(3 * C,)}")
        for j, name in enumerate(("query", "key", "value")):
            _put(out, f"{mha}.{name}.weight", in_w[j * C:(j + 1) * C])
            _put(out, f"{mha}.{name}.bias", in_b[j * C:(j + 1) * C])
        _put(out, f"{mha}.out.weight", sd.take(f"{pre}.self_attention.out_proj.weight"))
        _put(out, f"{mha}.out.bias", sd.take(f"{pre}.self_attention.out_proj.bias"))
        mlp = (("mlp.0", "mlp.3") if f"{pre}.mlp.0.weight" in sd
               else ("mlp.linear_1", "mlp.linear_2"))
        for dense, mk in zip(("Dense_0", "Dense_1"), mlp):
            _put(out, f"{blk}.{dense}.weight", sd.take(f"{pre}.{mk}.weight"))
            _put(out, f"{blk}.{dense}.bias", sd.take(f"{pre}.{mk}.bias"))
        i += 1

    _put(out, "LayerNorm_0.weight", sd.take("encoder.ln.weight"))
    _put(out, "LayerNorm_0.bias", sd.take("encoder.ln.bias"))
    if "heads.head.weight" in sd:
        w, bias = sd.take("heads.head.weight"), sd.take("heads.head.bias")
        if _put(out, "Dense_0.weight", w, allow_skip=True):
            _put(out, "Dense_0.bias", bias)
    sd.finish()
    return out


def load_torch_state_dict(path: str) -> Dict[str, Any]:
    """``torch.load`` a checkpoint file (tensors only, ``weights_only=True``)
    and unwrap common containers (raw state_dict, ``{"state_dict": ...}``,
    ``{"model": ...}``)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    for wrapper in ("state_dict", "model"):
        if isinstance(obj, dict) and wrapper in obj and not any(
            hasattr(v, "shape") for v in obj.values() if not isinstance(v, dict)
        ):
            obj = obj[wrapper]
    return obj


def load_pretrained_prediction(architecture: str, path: str,
                               template: Mapping[str, Tensor]) -> Dict[str, Tensor]:
    """Convert the checkpoint at ``path`` for ``architecture`` onto the
    prediction network's state dict ``template`` (the
    ``prediction.pretrained`` option; reference model_utils.py:35-60)."""
    sd = load_torch_state_dict(path)
    if architecture.startswith(("resnet", "wide_resnet", "wideresnet")):
        return convert_resnet_checkpoint(sd, template)
    if architecture.startswith("vit"):
        return convert_vit_checkpoint(sd, template)
    raise ValueError(f"no pretrained converter for architecture '{architecture}'")


def apply_pretrained_to_state(state: Any, architecture: str, path: str,
                              subtree: Union[str, Sequence[str]] = "prediction_network"):
    """Load converted torchvision weights into one submodule of a train
    state's `model`, in place, and return `state` (the
    ``prediction.pretrained=true`` flow: a frozen pretrained backbone and a
    fresh canonicalizer, reference model_utils.py:35-71).

    ``subtree`` is an attribute name or a path of them: e.g.
    ``("prediction_network", "backbone")`` targets MaskRCNNLite's ResNet-50
    trunk (the reference's pretrained maskrcnn_resnet50_fpn backbone,
    segmentation/model_utils.py:14-36)."""
    sub = (subtree,) if isinstance(subtree, str) else tuple(subtree)
    target = state.model.get_submodule(".".join(sub))
    converted = load_pretrained_prediction(architecture, path, target.state_dict())
    target.load_state_dict(converted)
    return state
