"""The port's continuous (SO(2) steerable) slice against the JAX package:
`SteerableNetwork`, the Flax weight loader's steerable leaves, and
`SteerableImageCanonicalization` -> `ResNet50` -> scalar
`invert_canonicalization` end to end, Flax weights carried across.

The Flax variables are made by `init`, then the NormBatchNorm scales and
running norms and the norm-ReLU biases are redrawn from a numpy seed, so a
leaf carried to the wrong place shows.

JAX side: exact mode runs `canon.apply` (on the CPU its exact warp is the
XLA taps form, the function of kernel K7). Fast mode off a TPU would take a
blend plus a bilinear residual, so the fast JAX side is composed by hand:
JAX network vectors -> `rotmat_2d_from_vector` -> `_transpose_trick` ->
`warp_rotate_center_fast(..., interpret=True)`, the three-shear function of
kernels K5 + K6.

Bars:
* network vectors (fp32): within 1e-5 * max|v|;
* fp32 slice, both warp modes: matrix_rep within 1e-5; canonical images
  and inverted maps within 1e-4; ResNet-50 logits within 1e-4 of the
  largest logit; prior loss and identity metric equal to rel 1e-5;
* bf16 serving slice (fast warp, bf16 network input, warp and output,
  bf16 ResNet-50): the first convolution runs in bf16, so the vectors and
  matrix_rep (fp32, as in JAX) agree within 1e-2 (a few bf16 ulps of the
  conv output), and the frames differ by up to about 0.2 degrees. Then
  canonical images and inverted maps agree within 1e-2 at 99% of their
  values and all within 5e-2, on images in [0, 1]; logits within 5e-2 of
  the largest logit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equiadapt_tpu.common import info as jinfo
from equiadapt_tpu.common.math import rotmat_2d_from_vector as j_rotmat
from equiadapt_tpu.images.canonicalization import continuous_group as jcg
from equiadapt_tpu.images.networks.steerable import SteerableNetwork as JNet
from equiadapt_tpu.models import ResNet50 as JResNet50
from equiadapt_tpu.ops.pallas.shear_rotate import warp_rotate_center_fast as j_fast
import equiadapt_tpu_torch as tp
from equiadapt_tpu_torch.images.networks import steerable as tst
from torch_port_cpu import one_intra_op_thread  # noqa: F401

IMG = 32


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _redraw(variables, seed):
    """Numpy variables with every NormBatchNorm `scale` / `norm_sq` and
    norm-ReLU `bias_*` redrawn from `seed`."""
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        name = path[-1].key
        if name in ("scale", "norm_sq"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(leaf.dtype)
        if name.startswith("bias_"):
            return (0.1 * rng.normal(size=leaf.shape)).astype(leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(redraw, _numpy(variables))


def _smooth(rng, b, size, c=3):
    """Images in [0, 1] with low-frequency content, sample b turned by b
    quarter turns (so the frames spread over the circle)."""
    coarse = rng.uniform(size=(b, c, size // 8, size // 8)).astype(np.float32)
    up = torch.nn.functional.interpolate(torch.from_numpy(coarse), size=(size, size),
                                         mode="bicubic", align_corners=False)
    up = torch.stack([torch.rot90(u, i, dims=(1, 2)) for i, u in enumerate(up)])
    return up.clamp(0, 1).permute(0, 2, 3, 1).contiguous().numpy()


@pytest.mark.parametrize("kernel_size,num_layers,size", [(5, 1, 16), (3, 2, 17)])
def test_network_matches_flax(kernel_size, num_layers, size):
    kw = dict(in_channels=3, out_channels=4, kernel_size=kernel_size,
              num_layers=num_layers)
    jnet = JNet(**kw)
    x = np.random.default_rng(size).normal(size=(4, size, size, 3)).astype(np.float32)
    variables = _redraw(jnet.init(jax.random.key(1), jnp.asarray(x)), seed=2)
    ref = np.asarray(jnet.apply(variables, jnp.asarray(x)))
    tnet = tp.load_flax_variables(tp.SteerableNetwork(**kw, device="cpu"),
                                  variables).eval()
    with torch.no_grad():
        ours = tnet(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (4, 2, 2)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_harmonic_basis_and_kernel_assembly_match_flax():
    """The assembled OIHW kernel equals the Flax block-by-block HWIO
    kernel, read back from a one-pixel-impulse convolution."""
    from equiadapt_tpu.images.networks import steerable as jst

    for dm in (0, 1, 2, -1):
        assert np.array_equal(tst._harmonic_basis(5, dm), jst._harmonic_basis(5, dm))
    in_orders, out_orders, K = (0, 1, 2), (0, 1), 3
    jconv = jst.SteerableConv(in_orders=in_orders, out_orders=out_orders,
                              kernel_size=K, padding=K // 2)
    Cin = tst._field_channels(in_orders)
    impulse = np.zeros((Cin, 2 * K - 1, 2 * K - 1, Cin), np.float32)
    impulse[np.arange(Cin), K - 1, K - 1, np.arange(Cin)] = 1.0
    variables = _numpy(jconv.init(jax.random.key(3), jnp.asarray(impulse)))
    ref = np.asarray(jconv.apply(variables, jnp.asarray(impulse)))
    tconv = tst.SteerableConv(in_orders, out_orders, K, padding=K // 2, device="cpu")
    tp.load_flax_variables(tconv, variables)
    with torch.no_grad():
        ours = tconv(torch.from_numpy(impulse).permute(0, 3, 1, 2))
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), ref, rtol=0, atol=1e-6)


def test_network_builds_at_the_yaml_widths():
    """configs/canonicalization/steerable.yaml's network (16 fields per
    order, kernel 9, 2 layers): the assembly keeps one signed ring basis
    and coefficient index per kernel channel pair, 21 MB for the hidden
    layer (a dense coefficient-to-kernel matrix of that layer would take
    41 GB)."""
    net = tp.SteerableNetwork(3, 16, 9, num_layers=2, device="cpu").eval()
    constants = sum(b.numel() * b.element_size() for b in net.buffers())
    assert constants < 2**25
    with torch.no_grad():
        out = net(torch.randn(2, 32, 32, 3))
        kernel = net.SteerableConv_1.kernel()
    assert out.shape == (2, 2, 2) and bool(torch.isfinite(out).all())
    assert kernel.shape == (80, 80, 9, 9)


def _net_variables():
    jnet = JNet(in_channels=3, out_channels=2, kernel_size=3, num_layers=1)
    return _redraw(jnet.init(jax.random.key(4), jnp.zeros((1, 8, 8, 3))), seed=5)


def test_weights_round_trip_fills_steerable_leaves():
    variables = _net_variables()
    tnet = tp.load_flax_variables(
        tp.SteerableNetwork(3, 2, 3, num_layers=1, device="cpu"), variables)
    p, s = variables["params"], variables["batch_stats"]
    assert np.array_equal(tnet.SteerableConv_1.w_1_3.detach().numpy(),
                          p["SteerableConv_1"]["w_1_3"])
    assert np.array_equal(tnet.NormNonlinearity_0.bias_3.detach().numpy(),
                          p["NormNonlinearity_0"]["bias_3"])
    assert np.array_equal(tnet.NormBatchNorm_0.scale.detach().numpy(),
                          p["NormBatchNorm_0"]["scale"])
    assert np.array_equal(tnet.NormBatchNorm_0.norm_sq.numpy(),
                          s["NormBatchNorm_0"]["norm_sq"])


@pytest.mark.parametrize("fault", ["extra_coefficient", "missing_norm_sq",
                                   "scale_as_batch_stat", "shape"])
def test_weights_round_trip_raises_on_mismatch(fault):
    variables = _net_variables()
    p, s = variables["params"], variables["batch_stats"]
    if fault == "extra_coefficient":
        p["SteerableConv_0"]["w_9_9"] = np.zeros((2, 2), np.float32)
    elif fault == "missing_norm_sq":
        del s["NormBatchNorm_0"]["norm_sq"]
    elif fault == "scale_as_batch_stat":
        s["NormBatchNorm_0"]["scale"] = p["NormBatchNorm_0"].pop("scale")
    else:
        p["NormNonlinearity_0"]["bias_3"] = np.zeros(2, np.float32)
    with pytest.raises((KeyError, ValueError)):
        load = tp.SteerableNetwork(3, 2, 3, num_layers=1, device="cpu")
        tp.load_flax_variables(load, variables)


# --- the slice -------------------------------------------------------------

NET = dict(in_channels=3, out_channels=4, kernel_size=5, num_layers=1)


def _canon_kwargs(group_type, warp_mode, bf16):
    return dict(in_shape=(IMG, IMG, 3), input_crop_ratio=0.9, resize_shape=16,
                group_type=group_type, warp_mode=warp_mode,
                output_dtype="compute" if bf16 else None)


@functools.lru_cache(maxsize=None)
def _resnets():
    jres = JResNet50(num_classes=10)
    variables = _numpy(jax.jit(jres.init)(jax.random.key(9),
                                          jnp.zeros((1, IMG, IMG, 3))))
    t32 = tp.load_flax_variables(tp.ResNet50(num_classes=10, device="cpu"),
                                 variables).eval()
    t16 = tp.ResNet50(num_classes=10, dtype=torch.bfloat16, device="cpu")
    t16.load_state_dict(t32.state_dict())
    return jres, variables, t32, t16.eval()


def _jax_fast(jcanon, variables, x, y):
    """The JAX fast slice through the three-shear function (see module
    docstring): canonical image, matrix rep, inverted map."""
    net_vars = {c: variables[c]["canonicalization_network"] for c in variables}
    x_in = jcanon.apply(
        variables, x,
        method=jcg.ContinuousGroupImageCanonicalization
        .transformations_before_canonicalization_network_forward)
    vectors = JNet(**NET).apply(net_vars, x_in)
    R = j_rotmat(vectors[:, 0])
    x_c = j_fast(x, jcg._transpose_trick(R), "border", interpret=True)
    y_inv = j_fast(y, R, "zeros", interpret=True)
    return x_c, R, y_inv


CASES = [("rotation", "exact", False), ("roto-reflection", "exact", False),
         ("rotation", "fast", False), ("rotation", "fast", True)]


@pytest.mark.parametrize("group_type,warp_mode,bf16", CASES)
def test_slice_matches_jax(group_type, warp_mode, bf16):
    rng = np.random.default_rng(0)
    x = _smooth(rng, 4, IMG)
    y = _smooth(rng, 4, IMG, c=5)
    kw = _canon_kwargs(group_type, warp_mode, bf16)
    jdt = jnp.bfloat16 if bf16 else None
    jcanon = jcg.SteerableImageCanonicalization(
        canonicalization_network=JNet(**NET), compute_dtype=jdt, **kw)
    variables = _redraw(jcanon.init(jax.random.key(3), jnp.asarray(x)), seed=6)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    if bf16:
        jx, jy = jx.astype(jnp.bfloat16), jy.astype(jnp.bfloat16)

    if warp_mode == "exact":
        j_xc, jinf = jcanon.apply(variables, jx)
        j_rep = jinf.matrix_rep
        j_yi = jcanon.apply(variables, jinf, jy, induced_rep_type="scalar",
                            method=jcg.SteerableImageCanonicalization
                            .invert_canonicalization)
    else:
        j_xc, j_rep, j_yi = _jax_fast(jcanon, variables, jx, jy)
        jinf = jinfo.ContinuousCanonicalizationInfo(
            matrix_rep=j_rep, element=jinfo.ContinuousGroupElement(rotation=j_rep))

    tcanon = tp.SteerableImageCanonicalization(
        tp.SteerableNetwork(**NET, device="cpu"),
        compute_dtype=torch.bfloat16 if bf16 else None, **kw)
    tp.load_flax_variables(tcanon, variables).eval()
    jres, rvars, t32, t16 = _resnets()
    with torch.no_grad():
        t_xc, tinf = tcanon.canonicalize(torch.from_numpy(x))
        t_yi = tcanon.invert_canonicalization(
            tinf, torch.from_numpy(y).to(t_xc.dtype), induced_rep_type="scalar")
        t_logits = (t16 if bf16 else t32)(t_xc).float().numpy()
    j_logits = np.asarray(jax.jit(JResNet50(num_classes=10, dtype=jdt or jnp.float32)
                                  .apply)(rvars, j_xc), np.float32)

    assert t_xc.shape == j_xc.shape and t_yi.shape == j_yi.shape
    assert t_xc.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert tinf.matrix_rep.dtype == torch.float32  # fp32 vectors, as in JAX
    rep, xc, yi = (np.asarray(a, np.float32) for a in (j_rep, j_xc, j_yi))
    t_rep, t_xc, t_yi = (a.float().numpy() for a in (tinf.matrix_rep, t_xc, t_yi))
    top = np.abs(j_logits).max()
    if not bf16:
        np.testing.assert_allclose(t_rep, rep, rtol=0, atol=1e-5)
        np.testing.assert_allclose(t_xc, xc, rtol=0, atol=1e-4)
        np.testing.assert_allclose(t_yi, yi, rtol=0, atol=1e-4)
        np.testing.assert_allclose(t_logits, j_logits, rtol=0, atol=1e-4 * top)
        assert tp.prior_regularization_loss(tinf).item() == pytest.approx(
            float(jinfo.prior_regularization_loss(jinf)), rel=1e-5)
        assert tp.identity_metric(tinf).item() == pytest.approx(
            float(jinfo.identity_metric(jinf)), rel=1e-5)
        return
    np.testing.assert_allclose(t_rep, rep, rtol=0, atol=1e-2)
    for ours, ref in ((t_xc, xc), (t_yi, yi)):
        err = np.abs(ours - ref)
        assert np.quantile(err, 0.99) <= 1e-2 and err.max() <= 5e-2, (
            np.quantile(err, 0.99), err.max())
    np.testing.assert_allclose(t_logits, j_logits, rtol=0, atol=5e-2 * top)


def test_training_and_vector_invert_raise():
    """`training` is an argument and the module mode is not read (training
    is ported); the "vector" invert raises, as in JAX."""
    canon = tp.SteerableImageCanonicalization(
        tp.SteerableNetwork(**NET, device="cpu"), **_canon_kwargs("rotation", "exact", False))
    x = torch.rand(2, IMG, IMG, 3)
    xc_train_mode, _ = canon.canonicalize(x)  # a fresh module is in train mode
    xc_eval, info = canon.eval().canonicalize(x)
    assert torch.equal(xc_train_mode, xc_eval)
    xc_t, info_t = canon.canonicalize(x, training=True)  # batch statistics
    assert xc_t.shape == x.shape and bool(torch.isfinite(xc_t).all())
    with pytest.raises(NotImplementedError):
        canon.invert_canonicalization(info, x)  # "vector", as in JAX
    with pytest.raises(ValueError):
        canon.invert_canonicalization(info, x, induced_rep_type="regular")
    net = canon.canonicalization_network
    assert torch.equal(net.train()(x), net.eval()(x))


def test_no_silent_cpu():
    """Without an explicit device the port builds on the card; where there
    is none it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        tp.SteerableNetwork(3, 4, 5)
