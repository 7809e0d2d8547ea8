"""The port's torchvision converters (`models/convert.py`) against the JAX ones.

A torchvision-layout state dict drawn from a seed goes two ways: through the
JAX converter (onto the Flax template that `flax_variables` reads off the
port module, so the surgeries keep the same fresh values), then
`load_flax_variables` into a port module; and through the port's converter
into another. The two must hold bit-equal parameters and buffers, and the
port's forward must match the JAX module's on the converted weights within
1e-5 of the largest logit (fp32). Every rejection of the JAX tests
(tests/test_pretrained_convert.py) raises in both packages;
`apply_pretrained_to_state` fills a nested subtree (MaskRCNNLite's ResNet-50
trunk) in place from a file `torch.save` wrote.
"""

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import equiadapt_tpu.models.convert as jconv
import equiadapt_tpu.models.resnet as jresnet
import equiadapt_tpu_torch as tp
import equiadapt_tpu_torch.models.convert as tconv
import equiadapt_tpu_torch.models.resnet as tresnet
from equiadapt_tpu.models import ViT as JViT
from equiadapt_tpu_torch.models.detection import MaskRCNNLite
from equiadapt_tpu_torch.models.vit import ViT as TViT
from equiadapt_tpu_torch.pipelines.classification import TrainState


def _conv_w(rng, o, i, k):
    return torch.tensor(rng.normal(0, math.sqrt(2.0 / (i * k * k)), (o, i, k, k)),
                        dtype=torch.float32)


def _bn(sd, rng, prefix, c):
    sd[f"{prefix}.weight"] = torch.tensor(rng.uniform(0.6, 1.4, c), dtype=torch.float32)
    sd[f"{prefix}.bias"] = torch.tensor(rng.normal(0, 0.05, c), dtype=torch.float32)
    sd[f"{prefix}.running_mean"] = torch.tensor(rng.normal(0, 0.05, c), dtype=torch.float32)
    sd[f"{prefix}.running_var"] = torch.tensor(rng.uniform(0.5, 1.5, c), dtype=torch.float32)
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def make_resnet_state_dict(stage_sizes, bottleneck, num_classes=1000, seed=0,
                           width_mult=1):
    """Random weights under torchvision's ResNet key names (width_mult=2:
    the wide_resnet*_2 family)."""
    rng = np.random.default_rng(seed)
    sd = {"conv1.weight": _conv_w(rng, 64, 3, 7)}
    _bn(sd, rng, "bn1", 64)
    in_ch, width = 64, 64
    expansion = 4 if bottleneck else 1
    for stage, n_blocks in enumerate(stage_sizes, start=1):
        for j in range(n_blocks):
            pre = f"layer{stage}.{j}"
            stride = 2 if (stage > 1 and j == 0) else 1
            out_ch = width * expansion
            if bottleneck:
                inner = width * width_mult
                shapes = [(inner, in_ch, 1), (inner, inner, 3), (out_ch, inner, 1)]
            else:
                shapes = [(width, in_ch, 3), (width, width, 3)]
            for c, (o, i, k) in enumerate(shapes, start=1):
                sd[f"{pre}.conv{c}.weight"] = _conv_w(rng, o, i, k)
                _bn(sd, rng, f"{pre}.bn{c}", o)
            if stride != 1 or in_ch != out_ch:
                sd[f"{pre}.downsample.0.weight"] = _conv_w(rng, out_ch, in_ch, 1)
                _bn(sd, rng, f"{pre}.downsample.1", out_ch)
            in_ch = out_ch
        width *= 2
    sd["fc.weight"] = torch.tensor(rng.normal(0, 0.01, (num_classes, in_ch)),
                                   dtype=torch.float32)
    sd["fc.bias"] = torch.tensor(rng.normal(0, 0.01, num_classes), dtype=torch.float32)
    return sd


def make_vit_state_dict(depth=2, hidden=32, mlp=64, patch=8, img=16,
                        num_classes=1000, seed=0, mlp_naming="mlp.0"):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.tensor(rng.normal(0, 0.05, s), dtype=torch.float32)
    sd = {
        "conv_proj.weight": t(hidden, 3, patch, patch),
        "conv_proj.bias": t(hidden),
        "class_token": t(1, 1, hidden),
        "encoder.pos_embedding": t(1, (img // patch) ** 2 + 1, hidden),
        "encoder.ln.weight": t(hidden) + 1.0,
        "encoder.ln.bias": t(hidden),
        "heads.head.weight": t(num_classes, hidden),
        "heads.head.bias": t(num_classes),
    }
    lin1, lin2 = (("mlp.0", "mlp.3") if mlp_naming == "mlp.0"
                  else ("mlp.linear_1", "mlp.linear_2"))
    for i in range(depth):
        pre = f"encoder.layers.encoder_layer_{i}"
        sd[f"{pre}.ln_1.weight"] = t(hidden) + 1.0
        sd[f"{pre}.ln_1.bias"] = t(hidden)
        sd[f"{pre}.self_attention.in_proj_weight"] = t(3 * hidden, hidden)
        sd[f"{pre}.self_attention.in_proj_bias"] = t(3 * hidden)
        sd[f"{pre}.self_attention.out_proj.weight"] = t(hidden, hidden)
        sd[f"{pre}.self_attention.out_proj.bias"] = t(hidden)
        sd[f"{pre}.ln_2.weight"] = t(hidden) + 1.0
        sd[f"{pre}.ln_2.bias"] = t(hidden)
        sd[f"{pre}.{lin1}.weight"] = t(mlp, hidden)
        sd[f"{pre}.{lin1}.bias"] = t(mlp)
        sd[f"{pre}.{lin2}.weight"] = t(hidden, mlp)
        sd[f"{pre}.{lin2}.bias"] = t(hidden)
    return sd


def _assert_bit_equal(a: nn.Module, b: nn.Module):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(sa[k], sb[k]), k


def _close_to_max(ours, ref, bar=1e-5):
    ref = np.asarray(ref, np.float64)
    err = np.abs(np.asarray(ours, np.float64) - ref).max()
    assert err <= bar * np.abs(ref).max(), (err, np.abs(ref).max())


# (name, JAX module, port module factory, stage sizes, bottleneck, width_mult)
_RESNETS = {
    "resnet18": (lambda: jresnet.ResNet18(num_classes=1000),
                 lambda: tresnet.ResNet18(num_classes=1000, device="cpu"),
                 [2, 2, 2, 2], False, 1),
    "resnet50": (lambda: jresnet.ResNet50(num_classes=1000),
                 lambda: tresnet.ResNet50(num_classes=1000, device="cpu"),
                 [3, 4, 6, 3], True, 1),
    "wide_resnet50_2": (
        lambda: jresnet.ResNet(num_classes=1000, stage_sizes=[3, 4, 6, 3],
                               block=partial(jresnet.Bottleneck, width_mult=2)),
        lambda: tresnet.WideResNet50(num_classes=1000, device="cpu"),
        [3, 4, 6, 3], True, 2),
}


def _jax_path(sd, tmodule_factory, template_module, convert):
    """The JAX converter onto the port module's own Flax template, then the
    Flax loader into a fresh port module: (converted Flax tree, module)."""
    converted = convert(sd, tp.flax_variables(template_module))
    fresh = tmodule_factory()
    tp.load_flax_variables(fresh, converted)
    return converted, fresh


@pytest.mark.parametrize("name", sorted(_RESNETS))
def test_resnet_convert_bit_equal_to_jax_and_forward(name):
    jfactory, tfactory, stages, bottleneck, width_mult = _RESNETS[name]
    sd = make_resnet_state_dict(stages, bottleneck, width_mult=width_mult, seed=3)
    torch.manual_seed(0)
    port = tfactory()
    converted, via_jax = _jax_path(sd, tfactory, port, jconv.convert_resnet_checkpoint)
    port.load_state_dict(tconv.convert_resnet_checkpoint(sd, port.state_dict()))
    _assert_bit_equal(port, via_jax)
    x = np.random.default_rng(4).normal(size=(2, 32, 32, 3)).astype(np.float32)
    jm = jfactory()
    ref = jax.jit(lambda v, a: jm.apply(v, a, training=False))(converted, jnp.asarray(x))
    with torch.no_grad():
        ours = port(torch.from_numpy(x)).numpy()
    _close_to_max(ours, ref)


def test_resnet_convert_cifar_stem_and_head_surgery():
    """A CIFAR-stem, 10-class template keeps its fresh 3x3 stem and head,
    converts the rest (bn1 too) and consumes every key, as in JAX."""
    sd = make_resnet_state_dict([2, 2, 2, 2], bottleneck=False)
    factory = lambda: tresnet.ResNet18(num_classes=10, small_images=True, device="cpu")
    port = factory()
    fresh = {k: v.clone() for k, v in port.state_dict().items()}
    _, via_jax = _jax_path(sd, factory, port, jconv.convert_resnet_checkpoint)
    port.load_state_dict(tconv.convert_resnet_checkpoint(sd, port.state_dict()))
    _assert_bit_equal(port, via_jax)
    out = port.state_dict()
    for k in ("Conv_0.weight", "Dense_0.weight", "Dense_0.bias"):
        assert torch.equal(out[k], fresh[k]), k
    assert torch.equal(out["BasicBlock_0.Conv_0.weight"], sd["layer1.0.conv1.weight"])
    assert torch.equal(out["BatchNorm_0.running_mean"], sd["bn1.running_mean"])
    assert torch.equal(out["BasicBlock_2.Conv_2.weight"], sd["layer2.0.downsample.0.weight"])


def _resnet18_depth_mismatch(sd):
    sd.pop("layer4.1.conv1.weight")


def _resnet18_unconsumed(sd):
    sd["layer9.0.conv1.weight"] = sd["layer1.0.conv1.weight"]


def _resnet18_missing(sd):
    del sd["layer2.0.bn1.running_mean"]


# corruption -> (template factory, error types, message)
_REJECTIONS = {
    "depth_mismatch": (_resnet18_depth_mismatch,
                       lambda: tresnet.ResNet18(num_classes=1000, device="cpu"),
                       (ValueError,), None),
    "unconsumed": (_resnet18_unconsumed,
                   lambda: tresnet.ResNet18(num_classes=1000, device="cpu"),
                   (ValueError,), "not consumed"),
    "missing": (_resnet18_missing,
                lambda: tresnet.ResNet18(num_classes=1000, device="cpu"),
                (KeyError,), None),
    "wrong_block_type": (lambda sd: None,
                         lambda: tresnet.ResNet50(num_classes=1000, device="cpu"),
                         (KeyError, ValueError), None),
}


@pytest.mark.parametrize("package", ["jax", "port"])
@pytest.mark.parametrize("case", sorted(_REJECTIONS))
def test_resnet_convert_rejects_what_jax_rejects(case, package):
    corrupt, factory, errors, match = _REJECTIONS[case]
    sd = make_resnet_state_dict([2, 2, 2, 2], bottleneck=False)
    corrupt(sd)
    module = factory()
    with pytest.raises(errors, match=match):
        if package == "jax":
            jconv.convert_resnet_checkpoint(sd, tp.flax_variables(module))
        else:
            tconv.convert_resnet_checkpoint(sd, module.state_dict())


def _vits():
    jm = JViT(num_classes=1000, patch_size=8, hidden_dim=32, num_layers=2,
              num_heads=4, mlp_dim=64)
    factory = lambda n=1000: TViT(num_classes=n, patch_size=8, hidden_dim=32,
                                  num_layers=2, num_heads=4, mlp_dim=64,
                                  image_size=16, device="cpu")
    return jm, factory


@pytest.mark.parametrize("mlp_naming", ["mlp.0", "mlp.linear_1"])
def test_vit_convert_bit_equal_to_jax_and_forward(mlp_naming):
    jm, factory = _vits()
    sd = make_vit_state_dict(mlp_naming=mlp_naming)
    port = factory()
    converted = jconv.convert_vit_checkpoint(sd, tp.flax_variables(port)["params"])
    via_jax = tp.load_flax_variables(factory(), {"params": converted})
    port.load_state_dict(tconv.convert_vit_checkpoint(sd, port.state_dict()))
    _assert_bit_equal(port, via_jax)
    x = np.random.default_rng(3).normal(size=(2, 16, 16, 3)).astype(np.float32)
    ref = jax.jit(lambda v, a: jm.apply(v, a, training=False))(
        {"params": converted}, jnp.asarray(x))
    with torch.no_grad():
        ours = port(torch.from_numpy(x)).numpy()
    _close_to_max(ours, ref)


def test_vit_convert_head_surgery_and_leaf_consumption():
    _, factory = _vits()
    sd = make_vit_state_dict(num_classes=1000)
    port = factory(10)
    fresh = port.Dense_0.weight.detach().clone()
    out = tconv.convert_vit_checkpoint(sd, port.state_dict())
    assert torch.equal(out["Dense_0.weight"], fresh)
    assert torch.equal(out["cls_token"], sd["class_token"])
    q = out["EncoderBlock_1.MultiHeadDotProductAttention_0.value.weight"]
    in_w = sd["encoder.layers.encoder_layer_1.self_attention.in_proj_weight"]
    assert torch.equal(q, in_w[64:96])


@pytest.mark.parametrize("package", ["jax", "port"])
@pytest.mark.parametrize("case", ["corrupted_in_proj", "unknown_key"])
def test_vit_convert_rejects_a_corrupted_tree(case, package):
    _, factory = _vits()
    module = factory()
    sd = make_vit_state_dict()
    if case == "corrupted_in_proj":
        sd["encoder.layers.encoder_layer_0.self_attention.in_proj_weight"] = torch.zeros(7, 32)
        errors, match = (ValueError, TypeError), None
    else:
        sd["encoder.layers.encoder_layer_0.unknown_extra.weight"] = torch.zeros(3)
        errors, match = ValueError, "unconsumed|unknown"
    with pytest.raises(errors, match=match):
        if package == "jax":
            jconv.convert_vit_checkpoint(sd, tp.flax_variables(module)["params"])
        else:
            tconv.convert_vit_checkpoint(sd, module.state_dict())


class _Holder(nn.Module):
    def __init__(self, prediction_network):
        super().__init__()
        self.prediction_network = prediction_network


def test_apply_pretrained_to_state_nested_subtree(tmp_path):
    """`apply_pretrained_to_state` with a path fills MaskRCNNLite's ResNet-50
    trunk in place from a `torch.save` file (fc consumed and dropped), bit
    for bit as the JAX converter fills the same trunk; the rest of the model
    and the optimizer's parameter objects stay as they were."""
    sd = make_resnet_state_dict([3, 4, 6, 3], bottleneck=True, seed=5)
    torch.save({"state_dict": sd}, tmp_path / "r50.pth")
    model = MaskRCNNLite(num_classes=5, max_instances=4, channels=32,
                         backbone="resnet50", device="cpu")
    state = TrainState(model=_Holder(model),
                       optimizers=[torch.optim.SGD(model.parameters(), lr=0.0)])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    param_ids = [id(p) for p in state.optimizers[0].param_groups[0]["params"]]
    jax_trunk = jconv.convert_resnet_checkpoint(sd, tp.flax_variables(model.backbone))

    assert tconv.apply_pretrained_to_state(
        state, "resnet50", str(tmp_path / "r50.pth"),
        subtree=("prediction_network", "backbone")) is state
    after = model.state_dict()
    assert torch.equal(after["backbone.Bottleneck_0.Conv_0.weight"],
                       sd["layer1.0.conv1.weight"])
    assert torch.equal(after["backbone.BatchNorm_0.running_var"], sd["bn1.running_var"])
    assert all(torch.equal(after[k], before[k]) for k in after
               if not k.startswith("backbone."))
    assert [id(p) for p in model.parameters()] == param_ids
    ref = tresnet.ResNet50(num_classes=None, return_stages=True, device="cpu")
    tp.load_flax_variables(ref, jax_trunk)
    _assert_bit_equal(model.backbone, ref)
    with torch.no_grad():
        out = model(torch.zeros(1, 64, 64, 3))
    assert out["pred_masks"].shape == (1, 4, 64, 64)


def test_load_torch_state_dict_unwraps_and_routes(tmp_path):
    sd = make_resnet_state_dict([2, 2, 2, 2], bottleneck=False)
    for i, obj in enumerate((sd, {"state_dict": sd}, {"model": sd})):
        torch.save(obj, tmp_path / f"{i}.pth")
        got = tconv.load_torch_state_dict(str(tmp_path / f"{i}.pth"))
        assert got.keys() == sd.keys()
        assert all(torch.equal(got[k], sd[k]) for k in sd)
    port = tresnet.ResNet18(num_classes=1000, device="cpu")
    out = tconv.load_pretrained_prediction("resnet18", str(tmp_path / "0.pth"),
                                           port.state_dict())
    assert torch.equal(out["Dense_0.weight"], sd["fc.weight"])
    with pytest.raises(ValueError, match="no pretrained converter"):
        tconv.load_pretrained_prediction("pointnet", str(tmp_path / "0.pth"),
                                         port.state_dict())
