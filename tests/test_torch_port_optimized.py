"""The optimized (orbit-scoring) canonicalizer and its networks against the
JAX package, Flax weights carried across.

Covers `ConvNetwork` (1, 2 and 3 layers), the three ResNet heads,
`OptimizedGroupEquivariantImageCanonicalization` at C4, D4 (orbit by K4's
plain version), C8 and D8 (static-warp orbit) in exact and fast modes, the
artifact dummies and `optimization_specific_loss`. The Flax variables are
drawn from a numpy seed at the shapes `init` would give (biases, BatchNorm
scales and running statistics away from their init values). Bars (fp32): layer outputs and vectors within
1e-5 of the largest; group activations (cosines) within 1e-5; selections
identical on seeds whose top-2 activation margin exceeds 1e-4; canonical
images within 1e-5; losses within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equiadapt_tpu.images.canonicalization import discrete_group as jdg
from equiadapt_tpu.images.networks import conv as jconv
import equiadapt_tpu_torch as tp
from equiadapt_tpu_torch.common.info import DiscreteCanonicalizationInfo
from equiadapt_tpu_torch.images.networks import conv as tconv
from equiadapt_tpu_torch.utils.jax_weights import flax_placements
from torch_port_cpu import one_intra_op_thread  # noqa: F401


def random_variables(module, x, seed=0):
    """Flax variables of `module` for input `x` as nested dicts of numpy
    arrays drawn from `seed` (shapes by `jax.eval_shape`, so the Flax
    forward pass is not run): kernels N(0, 1 / fan_in), biases and running
    means 0.1 N(0, 1), BatchNorm scales and variances (and NormBatchNorm's
    `norm_sq`) U(0.5, 1.5), any
    other parameter N(0, 1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.key(0), x)

    def draw(path, s):
        name = path[-1].key
        if name in ("var", "scale", "norm_sq"):
            return rng.uniform(0.5, 1.5, s.shape).astype(s.dtype)
        if name in ("mean", "bias"):
            return (0.1 * rng.normal(size=s.shape)).astype(s.dtype)
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(s.dtype)
        return rng.normal(size=s.shape).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(ours, ref, rel=1e-5):
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("num_layers", [1, 2, 3])
def test_conv_network_matches_flax(num_layers):
    kw = dict(in_channels=3, out_channels=4, kernel_size=3,
              num_layers=num_layers, out_vector_size=16)
    x = _x((5, 21, 21, 3), seed=num_layers)
    jnet = jconv.ConvNetwork(**kw)
    variables = random_variables(jnet, jnp.asarray(x), seed=num_layers)
    ref = np.asarray(jnet.apply(variables, jnp.asarray(x)))
    tnet = tp.load_flax_variables(
        tconv.ConvNetwork(**kw, input_size=21, device="cpu"), variables).eval()
    with torch.no_grad():
        ours = tnet(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (5, 16)
    _close(ours, ref)


def test_resnet18_head_matches_flax():
    x = _x((2, 32, 32, 3), seed=4)
    jnet = jconv.ResNet18Network(out_vector_size=16)
    variables = random_variables(jnet, jnp.asarray(x), seed=4)
    ref = np.asarray(jnet.apply(variables, jnp.asarray(x)))
    tnet = tp.load_flax_variables(
        tconv.ResNet18Network(out_vector_size=16, device="cpu"), variables).eval()
    with torch.no_grad():
        ours = tnet(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (2, 16)
    _close(ours, ref, 1e-4)


@pytest.mark.parametrize("name", ["WideResNet50Network", "WideResNet101Network"])
def test_wide_resnet_heads_take_every_flax_leaf(name):
    """Same module tree: every leaf of the Flax variables (shapes by
    `jax.eval_shape`, values never made) has a torch tensor of its shape
    and every torch tensor a leaf; the forward pass is ResNet18Network's."""
    shapes = jax.eval_shape(getattr(jconv, name)(out_vector_size=16).init,
                            jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    variables = jax.tree_util.tree_map(
        lambda s: np.lib.stride_tricks.as_strided(
            np.zeros(1, s.dtype), s.shape, (0,) * len(s.shape)), dict(shapes))
    tnet = getattr(tconv, name)(out_vector_size=16, device="meta")
    placed = flax_placements(tnet, variables)
    assert len(placed) == len(jax.tree_util.tree_leaves(variables))


def _canon_kwargs(n, group_type, mode):
    net = dict(in_channels=3, out_channels=8, kernel_size=3, num_layers=2,
               out_vector_size=16)
    canon = dict(in_shape=(24, 24, 3), input_crop_ratio=0.9, resize_shape=16,
                 num_rotations=n, group_type=group_type, warp_mode=mode,
                 out_vector_size=16)
    return net, canon


def _both_canons(n, group_type, mode, key, artifact_err_wt=0.0):
    net_kw, canon_kw = _canon_kwargs(n, group_type, mode)
    jcanon = jdg.OptimizedGroupEquivariantImageCanonicalization(
        canonicalization_network=jconv.ConvNetwork(**net_kw),
        artifact_err_wt=artifact_err_wt, **canon_kw)
    variables = random_variables(jcanon, jnp.zeros((2, 24, 24, 3)), seed=key)
    tcanon = tp.OptimizedGroupEquivariantImageCanonicalization(
        tconv.ConvNetwork(**net_kw, input_size=16, device="cpu"),
        artifact_err_wt=artifact_err_wt, device="cpu", **canon_kw)
    tp.load_flax_variables(tcanon, variables).eval()
    return jcanon, variables, tcanon


CASES = [(n, group_type, mode) for n in (4, 8)
         for group_type in ("rotation", "roto-reflection")
         for mode in ("exact", "fast")]


@pytest.mark.parametrize("n,group_type,mode", CASES)
def test_optimized_canonicalizer_matches_jax(n, group_type, mode):
    jcanon, variables, tcanon = _both_canons(n, group_type, mode, 0)
    x = 2.0 * _x((6, 24, 24, 3))
    jx, jinf = jcanon.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        tx, tinf = tcanon.canonicalize(torch.from_numpy(x))
    acts = np.asarray(jinf.group_activations)
    G = n * (2 if group_type == "roto-reflection" else 1)
    assert acts.shape == tuple(tinf.group_activations.shape) == (6, G)
    top2 = np.sort(acts, axis=-1)[:, -2:]
    assert np.all(top2[:, 1] - top2[:, 0] > 1e-4), "seed without clear margins"
    _close(tinf.extras["vector_out"].numpy(),
           np.asarray(jinf.extras["vector_out"]))
    np.testing.assert_allclose(tinf.group_activations.numpy(), acts, rtol=0, atol=1e-5)
    assert np.array_equal(tinf.onehot.numpy().argmax(-1), acts.argmax(-1))
    assert np.array_equal(tinf.element.rotation_deg.numpy(),
                          np.asarray(jinf.element.rotation_deg))
    if group_type == "roto-reflection":
        assert np.array_equal(tinf.element.reflection.numpy(),
                              np.asarray(jinf.element.reflection))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-5)
    ours = tp.optimization_specific_loss(tinf, out_vector_size=16).item()
    ref = float(jdg.optimization_specific_loss(jinf, out_vector_size=16))
    assert ours == pytest.approx(ref, rel=1e-5)


def test_artifact_dummies_and_loss_match_jax(monkeypatch):
    """artifact_err_wt > 0: the JAX side draws its dummy rotations with
    `jax.random.randint`; the test records them and hands the same indices
    to the port."""
    drawn = []
    randint = jax.random.randint

    def record(*args, **kwargs):
        out = randint(*args, **kwargs)
        drawn.append(np.asarray(out))
        return out

    jcanon, variables, tcanon = _both_canons(8, "rotation", "exact", 0,
                                             artifact_err_wt=0.5)
    x = 2.0 * _x((3, 24, 24, 3), seed=5)
    monkeypatch.setattr(jax.random, "randint", record)
    _, jinf = jcanon.apply(variables, jnp.asarray(x),
                           rngs={"artifact": jax.random.key(7)})
    monkeypatch.undo()
    assert len(drawn) == 1 and drawn[0].shape == (24,)
    with torch.no_grad():
        _, tinf = tcanon.canonicalize(torch.from_numpy(x),
                                      artifact_idx=torch.from_numpy(drawn[0].copy()))
    _close(tinf.extras["vector_out_dummy"].numpy(),
           np.asarray(jinf.extras["vector_out_dummy"]))
    ours = tp.optimization_specific_loss(tinf, out_vector_size=16,
                                         artifact_err_wt=0.5).item()
    ref = float(jdg.optimization_specific_loss(jinf, out_vector_size=16,
                                               artifact_err_wt=0.5))
    assert ours == pytest.approx(ref, rel=1e-5)
    # a generator draws the indices on its own; without one the port raises
    with torch.no_grad():
        _, tinf = tcanon.canonicalize(torch.from_numpy(x),
                                      generator=torch.Generator().manual_seed(0))
        assert tinf.extras["vector_out_dummy"].shape == (24, 16)
        with pytest.raises(ValueError, match="generator"):
            tcanon.canonicalize(torch.from_numpy(x))


def test_selection_shifts_under_rotation_d4():
    """canonicalize(rot90(x)) selects the next rotation in the same coset
    (a symmetric 1 px crop of 24 px keeps crop and rot90 commuting)."""
    _, _, tcanon = _both_canons(4, "roto-reflection", "exact", 0)
    x = torch.from_numpy(2.0 * _x((8, 24, 24, 3), seed=3))
    with torch.no_grad():
        _, info = tcanon.canonicalize(x)
        _, info_rot = tcanon.canonicalize(torch.rot90(x, 1, dims=(1, 2)))
    sel = info.group_activations.argmax(-1)
    sel_rot = info_rot.group_activations.argmax(-1)
    assert torch.equal(sel_rot % 4, (sel % 4 + 1) % 4)
    assert torch.equal(sel_rot // 4, sel // 4)


@pytest.mark.parametrize("fault", ["extra_root_leaf", "missing_reference_vector"])
def test_loader_places_only_the_canonicalizers_own_parameter(fault):
    _, variables, tcanon = _both_canons(4, "rotation", "exact", 0)
    if fault == "extra_root_leaf":
        variables["params"]["reference_vectors"] = np.zeros((1, 16), np.float32)
    else:
        del variables["params"]["reference_vector"]
    with pytest.raises(KeyError):
        tp.load_flax_variables(tcanon, variables)


def test_optimized_canonicalizer_guards():
    net_kw, canon_kw = _canon_kwargs(4, "rotation", "exact")
    net = tconv.ConvNetwork(**net_kw, input_size=16, device="cpu")
    # orbit_sharding is ported (item 16): it needs the mesh of a
    # data-parallel step (tests/test_torch_port_parallel.py runs it)
    sharded = tp.OptimizedGroupEquivariantImageCanonicalization(
        net, orbit_sharding=("group", "data"), device="cpu", **canon_kw)
    assert sharded.orbit_sharding == ("group", "data")
    with pytest.raises(ValueError, match="active mesh"):
        sharded.canonicalize(torch.zeros(2, 24, 24, 3))
    canon = tp.OptimizedGroupEquivariantImageCanonicalization(
        net, device="cpu", **canon_kw)
    assert not canon.reference_vector.requires_grad
    # train mode reads `training`, not the module mode: BatchNorm statistics
    # update, dropout draws from the generator (and needs one)
    x = torch.randn(2, 24, 24, 3, generator=torch.Generator().manual_seed(0))
    mean = net.BatchNorm_0.running_mean.clone()
    canon.canonicalize(x)  # module in train mode, training=False: eval
    assert torch.equal(net.BatchNorm_0.running_mean, mean)
    with pytest.raises(ValueError, match="generator"):
        canon.canonicalize(x, training=True)
    _, info = canon.canonicalize(x, training=True,
                                 generator=torch.Generator().manual_seed(1))
    assert not torch.equal(net.BatchNorm_0.running_mean, mean)
    assert info.group_activations.requires_grad
    info = DiscreteCanonicalizationInfo(
        group_activations=torch.zeros(2, 4), onehot=torch.zeros(2, 4),
        element=None, extras={"vector_out": torch.randn(8, 16)})
    v = info.extras["vector_out"].reshape(4, 2, 16).transpose(0, 1)
    gram = torch.einsum("bgd,bhd->bgh", v, v).abs() * (1 - torch.eye(4))
    assert tp.optimization_specific_loss(info, out_vector_size=16).item() == \
        pytest.approx(gram.mean().item(), rel=1e-6)
