"""Port networks against the Flax modules with weights carried across.

The Flax variables are made by `init` and then every bias, BatchNorm scale
and running statistic is redrawn from a numpy seed, so a leaf carried to the
wrong place shows. Tolerances (fp32): GCNN activations within 1e-5 and the
argmax identical where the top-2 margin exceeds 1e-3; ResNet logits within
1e-4 of the largest logit (convolution sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equiadapt_tpu.images.networks import equivariant as jeq
from equiadapt_tpu.images.networks import group_conv as jgc
from equiadapt_tpu.models import resnet as jres
from equiadapt_tpu_torch.images.networks import equivariant as teq
from equiadapt_tpu_torch.images.networks import group_conv as tgc
from equiadapt_tpu_torch.models import resnet as tres
from equiadapt_tpu_torch.utils import load_flax_variables
from torch_port_cpu import one_intra_op_thread  # noqa: F401


def numpy_variables(variables, seed=0):
    """Flax variables as nested dicts of numpy arrays, with biases, BN
    scales and running statistics redrawn from `seed`."""
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        leaf = np.asarray(leaf)
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(leaf.dtype)
        if name in ("mean", "bias"):
            return (0.1 * rng.normal(size=leaf.shape)).astype(leaf.dtype)
        if name == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(redraw, jax.tree_util.tree_map(
        np.asarray, dict(variables)))


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def assert_same_argmax(ours, ref, margin=1e-3, min_share=0.5):
    """Identical argmax on every sample whose reference top-2 margin exceeds
    `margin` (a near-tie may flip under another summation order), and at
    least `min_share` of the batch so guarded."""
    top2 = np.sort(ref, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > margin
    assert clear.mean() >= min_share, "pick another seed"
    assert np.array_equal(ours.argmax(-1)[clear], ref.argmax(-1)[clear])


def test_rotation_tap_matrix_and_fold_match_jax():
    for K in (3, 5):
        for n in (4, 8):
            angles = jgc._angle_tuple(n)
            assert np.array_equal(tgc._rotation_tap_matrix(K, angles),
                                  jgc._rotation_tap_matrix(K, angles))
    bank = _x((3, 3, 2, 4))
    ref = np.asarray(jgc._fold_avg_pool(jnp.asarray(bank)))  # HWIO
    ours = tgc._fold_avg_pool(torch.from_numpy(bank).permute(3, 2, 0, 1))
    assert np.array_equal(ours.permute(2, 3, 1, 0).numpy(), ref)


@pytest.mark.parametrize("group_type", ["rotation", "roto-reflection"])
@pytest.mark.parametrize("preset", ["plain", "pool_after_lift", "fused_pool_lift"])
def test_gcnn_matches_flax(group_type, preset):
    layers = 3 if preset == "plain" else 2
    kw = dict(in_channels=3, out_channels=4, kernel_size=3, group_type=group_type,
              num_rotations=8, num_layers=layers,
              pool_after_lift=preset == "pool_after_lift",
              fused_pool_lift=preset == "fused_pool_lift")
    jnet = jeq.EquivariantNetwork(**kw)
    x = 4.0 * _x((8, 24, 24, 3), seed=11)
    variables = numpy_variables(jnet.init(jax.random.key(3), jnp.asarray(x)))
    ref = np.asarray(jnet.apply(variables, jnp.asarray(x)))
    tnet = load_flax_variables(teq.EquivariantNetwork(**kw, device="cpu"),
                               variables).eval()
    with torch.no_grad():
        ours = tnet(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (8, 8 if group_type == "rotation" else 16)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    assert_same_argmax(ours, ref)


@pytest.mark.parametrize("layer", ["RotationEquivariantConv",
                                   "RotoReflectionEquivariantConv"])
def test_group_conv_layer_matches_flax(layer):
    n = 4
    G = n if layer.startswith("Rotation") else 2 * n
    jl = getattr(jgc, layer)(in_channels=2, out_channels=3, kernel_size=3,
                             num_rotations=n, padding=1)
    x = _x((2, 10, 10, 2 * G), seed=12)
    variables = numpy_variables(jl.init(jax.random.key(4), jnp.asarray(x)))
    ref = np.asarray(jl.apply(variables, jnp.asarray(x)))
    tl = load_flax_variables(getattr(tgc, layer)(2, 3, 3, num_rotations=n,
                                                 padding=1, device="cpu"),
                             variables)
    with torch.no_grad():
        ours = tl(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch,small", [("ResNet18", True), ("ResNet18", False),
                                        ("ResNet50", False)])
def test_resnet_matches_flax(arch, small):
    jnet = getattr(jres, arch)(num_classes=10, small_images=small)
    x = _x((2, 32, 32, 3), seed=13)
    variables = numpy_variables(jnet.init(jax.random.key(5), jnp.asarray(x)))
    ref = np.asarray(jnet.apply(variables, jnp.asarray(x)))
    tnet = getattr(tres, arch)(num_classes=10, small_images=small, device="cpu")
    load_flax_variables(tnet, variables).eval()
    with torch.no_grad():
        ours = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_resnet_features_and_stages():
    tnet = tres.ResNet18(num_classes=None, device="cpu").eval()
    with torch.no_grad():
        feats = tnet(torch.zeros(2, 32, 32, 3))
        tnet.return_stages = True
        stages = tnet(torch.zeros(2, 32, 32, 3))
    assert feats.shape == (2, 512)
    assert [s.shape[1] for s in stages] == [64, 128, 256, 512]


def _gcnn_variables():
    kw = dict(in_channels=3, out_channels=4, kernel_size=3, num_rotations=4)
    jnet = jeq.EquivariantNetwork(**kw)
    variables = numpy_variables(jnet.init(jax.random.key(6), jnp.zeros((1, 12, 12, 3))))
    return kw, variables


def test_weights_round_trip_fills_everything():
    kw, variables = _gcnn_variables()
    tnet = load_flax_variables(teq.EquivariantNetwork(**kw, device="cpu"), variables)
    p = variables["params"]
    lift = p["RotationEquivariantConvLift_0"]
    assert np.array_equal(tnet.RotationEquivariantConvLift_0.weights.detach().numpy(),
                          lift["weights"])
    bn = tnet.FiberBatchNorm_0.BatchNorm_0
    assert np.array_equal(bn.running_var.numpy(),
                          variables["batch_stats"]["FiberBatchNorm_0"]["BatchNorm_0"]["var"])
    jres18 = jres.ResNet18(num_classes=10)
    rv = numpy_variables(jres18.init(jax.random.key(7), jnp.zeros((1, 32, 32, 3))))
    t18 = load_flax_variables(tres.ResNet18(num_classes=10, device="cpu"), rv)
    kernel = rv["params"]["BasicBlock_2"]["Conv_0"]["kernel"]  # HWIO
    assert np.array_equal(t18.BasicBlock_2.Conv_0.weight.detach().numpy(),
                          kernel.transpose(3, 2, 0, 1))
    assert np.array_equal(t18.Dense_0.weight.detach().numpy(),
                          rv["params"]["Dense_0"]["kernel"].T)


@pytest.mark.parametrize("fault", ["extra_leaf", "missing_leaf", "extra_scope",
                                   "shape", "collection"])
def test_weights_round_trip_raises_on_mismatch(fault):
    kw, variables = _gcnn_variables()
    p = variables["params"]
    if fault == "extra_leaf":
        p["RotationEquivariantConv_0"]["extra"] = np.zeros(3, np.float32)
    elif fault == "missing_leaf":
        del variables["batch_stats"]["FiberBatchNorm_0"]["BatchNorm_0"]["mean"]
    elif fault == "extra_scope":
        p["Dense_9"] = {"kernel": np.zeros((2, 2), np.float32)}
    elif fault == "shape":
        p["RotationEquivariantConv_0"]["bias"] = np.zeros(5, np.float32)
    else:
        variables["cache"] = {}
    with pytest.raises((KeyError, ValueError)):
        load_flax_variables(teq.EquivariantNetwork(**kw, device="cpu"), variables)
