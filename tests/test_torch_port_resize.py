"""`ops.warp.resize`'s five methods against `jax.image.resize`, and the
constructor options the port's modules take with the JAX modules' defaults.

Resize bars: fp32 within 1e-5 absolute (inputs N(0, 1); JAX builds its
weight matrices in fp32, the port in float64); a bf16 input resized in the
port equal to the port's fp32 resize of the same values rounded once to
bf16, and within one bf16 ulp of JAX's fp32 resize plus the fp32 bar (near
0 a bf16 ulp is smaller than the two fp32 results' 1e-7 difference);
"nearest" bit-equal; "linear" equal to the path the port took before (max
|delta| 0).

Options, each at a value other than its default, the JAX module's Flax
variables carried over: `SteerableConv(stride=2)` within 1e-5,
`NormBatchNorm(momentum=0.5, epsilon=1e-3)` in training and eval within
1e-6, `SteerableNetwork(group_type="rotation", num_rotations=8)` within
1e-5, `VNBatchNorm(momentum=0.5)` within 1e-5 (its statistics 1e-6),
`SamAttention(use_rel_pos=False)` within 1e-5, with the loader's round
trip of its rel-pos-less tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from equiadapt_tpu.images.networks import steerable as jst
from equiadapt_tpu.models import sam_encoder as jsam
from equiadapt_tpu.ops import warp as jwarp
from equiadapt_tpu.pointcloud import vector_neurons as jvn
import equiadapt_tpu_torch as tp
from equiadapt_tpu_torch.images.networks import steerable as tst
from equiadapt_tpu_torch.models import sam_encoder as tsam
from equiadapt_tpu_torch.ops import warp as twarp
from equiadapt_tpu_torch.pointcloud import vector_neurons as tvn
from torch_port_cpu import one_intra_op_thread  # noqa: F401

METHODS = ("nearest", "linear", "cubic", "lanczos3", "lanczos5")
# (H, W) -> (h, w): shrink, grow, and one axis each way
SIZES = {"shrink": ((37, 37), (16, 16)), "grow": ((16, 16), (37, 37)),
         "mixed": ((32, 20), (20, 48))}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def random_variables(module, x, seed):
    """Flax variables of `module` for input `x`, drawn from `seed` at the
    shapes `jax.eval_shape` gives (the Flax init is not run): statistics
    and scales U(0.5, 1.5), every other leaf N(0, 1 / fan_in) (N(0, 0.1) for
    vectors)."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        if path[-1].key in ("var", "scale", "norm_sq", "mean"):
            return rng.uniform(0.5, 1.5, s.shape).astype(s.dtype)
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 100
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(s.dtype)

    shapes = jax.eval_shape(module.init, jax.random.key(0), jnp.asarray(x))
    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """bf16's spacing at |v| (8 significand bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sizes", list(SIZES))
@pytest.mark.parametrize("method", METHODS)
def test_resize_matches_jax(method, sizes, dtype):
    (H, W), size = SIZES[sizes]
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, H, W, 3))
                         .astype(np.float32)).to(getattr(torch, dtype))
    got = twarp.resize(x, size, method)
    assert got.dtype == x.dtype and got.shape == (2, *size, 3)
    x32 = x.float().numpy()  # the same values in fp32
    if method == "nearest":  # moves values: bit-equal in the input's dtype
        ref = np.asarray(jwarp.resize(jnp.asarray(x32).astype(dtype), size, method))
        assert np.array_equal(got.float().numpy(), ref.astype(np.float32))
        return
    ref = np.asarray(jwarp.resize(jnp.asarray(x32), size, method))
    err = np.abs(got.float().numpy() - ref)
    if dtype == "float32":
        assert err.max() <= 1e-5, err.max()
    else:
        assert torch.equal(got, twarp.resize(x.float(), size, method).to(x.dtype))
        assert np.all(err <= _bf16_ulp(ref) + 1e-5), (err / _bf16_ulp(ref)).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_resize_is_the_path_it_was(dtype):
    """"linear" stays `F.interpolate(..., antialias=True)` in fp32, rounded
    once: the main path's resize, bit for bit."""
    x = torch.randn(2, 37, 29, 3, generator=torch.Generator().manual_seed(1)).to(dtype)
    for size in ((16, 16), (64, 40), (37, 12)):
        before = F.interpolate(x.permute(0, 3, 1, 2).float(), size=size, mode="bilinear",
                               align_corners=False, antialias=True
                               ).to(dtype).permute(0, 2, 3, 1)
        assert torch.equal(twarp.resize(x, size), before)
        assert torch.equal(twarp.resize(x, size, "linear"), before)


def test_resize_refuses_an_unknown_method_as_jax_does():
    x = torch.randn(1, 9, 9, 2, generator=torch.Generator().manual_seed(2))
    with pytest.raises(ValueError, match="Unknown resize method"):
        jwarp.resize(jnp.asarray(x.numpy()), (5, 5), "gaussian")
    with pytest.raises(ValueError, match="Unknown resize method"):
        twarp.resize(x, (5, 5), "gaussian")


def test_resize_weights_are_cached_and_normalised():
    """One float64 matrix per (in, out, method), rows summing to 1, the
    kernel widened when it shrinks (lanczos3 from 37 to 16 reads the
    inputs within 3 * 37 / 16 of each sample point)."""
    w = twarp._resize_weights(37, 16, "lanczos3")
    assert w is twarp._resize_weights(37, 16, "lanczos3")
    assert w.dtype == torch.float64 and w.shape == (16, 37)
    assert torch.allclose(w.sum(1), torch.ones(16, dtype=torch.float64), rtol=0, atol=1e-12)
    sample = (8 + 0.5) * 37 / 16 - 0.5
    taps = [j for j in range(37) if abs(j - sample) < 3 * 37 / 16]
    assert torch.nonzero(w[8]).flatten().tolist() == taps


# -------------------------------------------------- the constructor options


def test_steerable_conv_stride_matches_flax():
    in_orders, out_orders, K = (0, 1, 2), (0, 1), 5
    x = np.random.default_rng(3).normal(size=(2, 13, 13, 5)).astype(np.float32)
    jconv = jst.SteerableConv(in_orders=in_orders, out_orders=out_orders,
                              kernel_size=K, stride=2, padding=1)
    variables = random_variables(jconv, x, 4)
    ref = np.asarray(jconv.apply(variables, jnp.asarray(x)))
    tconv = tp.load_flax_variables(
        tst.SteerableConv(in_orders, out_orders, K, stride=2, padding=1, device="cpu"),
        variables)
    with torch.no_grad():
        got = tconv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == ref.shape == (2, 6, 6, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_norm_batchnorm_momentum_and_epsilon_match_flax():
    orders = (0, 1, 2)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 6, 7, 5)).astype(np.float32)
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, 3).astype(np.float32)},
                 "batch_stats": {"norm_sq": rng.uniform(0.5, 1.5, 3).astype(np.float32)}}
    jbn = jst.NormBatchNorm(orders=orders, momentum=0.5, epsilon=1e-3)
    jy, upd = jbn.apply(variables, jnp.asarray(x), training=True, mutable=["batch_stats"])
    tbn = tp.load_flax_variables(
        tst.NormBatchNorm(orders, momentum=0.5, epsilon=1e-3, device="cpu"), variables)
    ty = tbn(torch.from_numpy(x).permute(0, 3, 1, 2), training=True).permute(0, 2, 3, 1)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tbn.norm_sq.numpy(), np.asarray(upd["batch_stats"]["norm_sq"]),
                               rtol=0, atol=1e-6)
    jy_eval = jbn.apply({"params": variables["params"], **_np(upd)}, jnp.asarray(x))
    with torch.no_grad():
        ty_eval = tbn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(ty_eval.numpy(), np.asarray(jy_eval), rtol=0, atol=1e-6)


def test_steerable_network_group_options_match_flax():
    """group_type "rotation" and num_rotations (unused, as in JAX) are
    taken; another group type raises (the reference asserts SO(2))."""
    kw = dict(in_channels=3, out_channels=2, kernel_size=5, num_layers=1)
    x = np.random.default_rng(6).normal(size=(2, 12, 12, 3)).astype(np.float32)
    jnet = jst.SteerableNetwork(**kw, group_type="rotation", num_rotations=8)
    variables = random_variables(jnet, x, 7)
    tnet = tp.load_flax_variables(
        tst.SteerableNetwork(**kw, group_type="rotation", num_rotations=8, device="cpu"),
        variables)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jnet.apply(variables, jnp.asarray(x))),
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="SO\\(2\\)"):
        tst.SteerableNetwork(**kw, group_type="roto-reflection", device="cpu")


def test_vn_batchnorm_momentum_matches_flax():
    x = np.random.default_rng(8).normal(size=(3, 12, 3, 5)).astype(np.float32)
    jbn = jvn.VNBatchNorm(momentum=0.5)
    variables = random_variables(jbn, x, 9)
    jy, upd = jbn.apply(variables, jnp.asarray(x), training=True, mutable=["batch_stats"])
    tbn = tp.load_flax_variables(tvn.VNBatchNorm(5, momentum=0.5, device="cpu"), variables)
    ty = tbn(torch.from_numpy(x), training=True)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    got, ref = tp.flax_variables(tbn)["batch_stats"], _np(upd["batch_stats"])
    for leaf in ("mean", "var"):
        np.testing.assert_allclose(got["BatchNorm_0"][leaf], ref["BatchNorm_0"][leaf],
                                   rtol=0, atol=1e-6)


def test_sam_attention_without_rel_pos_matches_flax_and_round_trips():
    """A JAX `SamAttention(use_rel_pos=False)` tree has no `rel_pos_*`
    leaves: it loads into the port's module, which has none either and
    adds no bias, and `flax_variables` gives the same tree back."""
    x = np.random.default_rng(10).normal(size=(2, 4, 5, 16)).astype(np.float32)
    jatt = jsam.SamAttention(dim=16, num_heads=2, use_rel_pos=False, input_size=(4, 5))
    variables = random_variables(jatt, x, 11)
    assert set(variables["params"]) == {"qkv", "proj"}
    tatt = tp.load_flax_variables(
        tsam.SamAttention(16, 2, (4, 5), use_rel_pos=False, device="cpu"), variables)
    assert not any("rel_pos" in n for n, _ in tatt.named_parameters())
    with torch.no_grad():
        got = tatt(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jatt.apply(variables, jnp.asarray(x))),
                               rtol=0, atol=1e-5)
    back = tp.flax_variables(tatt)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(variables))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        assert np.array_equal(a, b)
