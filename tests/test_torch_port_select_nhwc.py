"""Port kernel K3 (the channels-last select) and the select kernels'
gradients against the JAX package, on the CPU.

* K3's plain version against the Pallas kernel `_pallas_selectn_ilv` in
  interpret mode, on the same numpy sources and indices: bit-identical
  (pure data movement).
* `rotate_select`'s NHWC route (K3) against `pallas_rotate_select_nhwc`
  in interpret mode: quarter-turn elements bit-identical, the 45-degree
  elements of C8 within 1e-5 (fp32; two residual warps whose sums XLA and
  PyTorch order differently) or one bf16 ulp.
* The two layout routes of `rotate_select`: an NHWC-contiguous batch (K3)
  and the same values in NCHW memory (K1) give `torch.equal` results in
  exact mode; in fast mode the quarter-turn elements are equal and the
  45-degree ones within 1e-6 (the two-pass products contract in another
  order per layout).
* The pipeline's hand-over (`to_network_layout`): the loader's NHWC batch
  reaches the canonicalizer and the ResNet in NCHW memory in fp32 and
  stays NHWC in bf16; the canonical images equal the NHWC route's.
* Gradients: `torch.autograd.grad` through the port's `rotate_select`
  (both routes) against `jax.grad` of the JAX `rotate_select` (a custom
  VJP), exact and fast, C4 and C8, within 1e-6; the select kernels'
  autograd backward against autograd through their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equiadapt_tpu.ops.pallas import select_warp as jsw
import equiadapt_tpu_torch as tp
from equiadapt_tpu_torch.ops.kernels import select_warp as tsw
from torch_port_cpu import one_intra_op_thread  # noqa: F401

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _tables(n, sign, B, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=B).astype(np.int32)
    residues, src_of, k_of = jsw._c_n_decomposition(n, sign)
    return (len(residues), np.asarray(src_of, np.int32)[idx],
            np.asarray(k_of, np.int32)[idx], idx, rng)


def _pair(a, dtype):
    """The same values as a torch and a JAX array of `dtype`."""
    t = _t(a).to(DTYPES[dtype][0])
    return t, jnp.asarray(t.float().numpy()).astype(DTYPES[dtype][1])


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("C", [1, 3, 4])
def test_k3_plain_bitidentical_to_pallas(C, n, dtype):
    S, src, k, _, rng = _tables(n, -1.0, 6, seed=C * n)
    B, H = 6, 12
    pairs = [_pair(rng.normal(size=(B, H, H, C)).astype(np.float32), dtype)
             for _ in range(S)]
    ours = tsw.select_planes_nhwc([p[0] for p in pairs], _t(src), _t(k))
    flat = [p[1].reshape(B, H, H * C) for p in pairs]
    if len(flat) == 1:
        flat = flat * 2  # the JAX entry's degenerate second source
    ref = jsw._pallas_selectn_ilv(tuple(flat), jnp.asarray(src), jnp.asarray(k),
                                  C, interpret=True)
    assert ours.is_contiguous() and ours.dtype == DTYPES[dtype][0]
    assert np.array_equal(ours.float().numpy(), _np(ref).reshape(B, H, H, C))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("C", [1, 3, 4])
def test_rotate_select_nhwc_matches_pallas(C, n, mode, dtype):
    _, _, k, idx, rng = _tables(n, -1.0, 8, seed=C + 10 * n)
    xt, xj = _pair(rng.normal(size=(8, 16, 16, C)).astype(np.float32), dtype)
    sw_launch = dict(tsw.launches)
    ours = tsw.rotate_select(xt, _t(idx), n, -1.0, "border", mode)
    assert tsw.launches == sw_launch  # the CPU takes the plain version
    ref = _np(jsw.pallas_rotate_select_nhwc(xj, jnp.asarray(idx), n, -1.0,
                                            "border", interpret=True, mode=mode))
    ours = ours.float().numpy()
    quarter = idx % (n // 4) == 0
    assert np.array_equal(ours[quarter], ref[quarter])
    if dtype == "float32":
        np.testing.assert_allclose(ours[~quarter], ref[~quarter], rtol=0, atol=1e-5)
    else:  # one bf16 ulp
        np.testing.assert_allclose(ours[~quarter], ref[~quarter], rtol=2.0**-7,
                                   atol=1e-6)


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("n", [4, 8, 16])
def test_layout_routes_agree(n, mode):
    _, _, _, idx, rng = _tables(n, -1.0, 8, seed=n)
    x = _t(rng.normal(size=(8, 20, 20, 3)).astype(np.float32))
    x_nchw = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert x.is_contiguous() and not x_nchw.is_contiguous()
    k3 = tsw.rotate_select(x, _t(idx), n, -1.0, "border", mode)
    k1 = tsw.rotate_select(x_nchw, _t(idx), n, -1.0, "border", mode)
    assert k3.is_contiguous()
    assert k1.permute(0, 3, 1, 2).is_contiguous()
    # other strides: one copy to NHWC memory, then K3
    wide = torch.cat([x, x[..., :1]], dim=-1)[..., :3]
    assert not wide.is_contiguous()
    assert torch.equal(tsw.rotate_select(wide, _t(idx), n, -1.0, "border", mode), k3)
    if mode == "exact":
        assert torch.equal(k3, k1)
        return
    quarter = torch.from_numpy(idx % (n // 4) == 0)
    assert torch.equal(k3[quarter], k1[quarter])
    assert (k3 - k1).abs().max().item() <= 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pipeline_hands_the_network_its_layout(dtype):
    torch.manual_seed(0)
    canon = tp.GroupEquivariantImageCanonicalization(
        tp.EquivariantNetwork(3, 4, 3, num_rotations=8, device="cpu"),
        in_shape=(20, 20, 3), input_crop_ratio=0.9, resize_shape=16,
        num_rotations=8, group_type="rotation")
    net = tp.ResNet18(num_classes=10, small_images=True, dtype=dtype,
                      device="cpu")
    pipe = tp.ImageClassifierPipeline(canon, net)
    x = torch.randn(4, 20, 20, 3)
    fp32 = dtype == torch.float32
    assert net.input_layout == ("nchw" if fp32 else "nhwc")
    xl = tp.to_network_layout(x, net)
    assert (xl is x) != fp32 and torch.equal(xl, x)
    assert xl.permute(0, 3, 1, 2).is_contiguous() == fp32
    x_c, info = pipe.canonicalize(x)
    ref, info_ref = canon.canonicalize(x)  # the NHWC route (K3)
    assert x_c.is_contiguous() != fp32 and ref.is_contiguous()
    assert torch.equal(x_c, ref)
    assert torch.equal(info.onehot, info_ref.onehot)
    logits, _ = pipe(x)
    torch.testing.assert_close(logits, net(x_c), rtol=0, atol=0)
    torch.testing.assert_close(logits.float(), net(ref).float(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("n", [4, 8])
def test_rotate_select_gradient_matches_jax(n, mode, layout):
    rng = np.random.default_rng(n + (mode == "fast"))
    x = rng.normal(size=(6, 16, 16, 3)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    idx = rng.integers(0, n, size=6).astype(np.int32)

    def jloss(xx):
        out = jsw.rotate_select(xx, jnp.asarray(idx), n, -1.0, "border", mode)
        return jnp.sum(out * jnp.asarray(w))

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = _t(x)
    if layout == "nchw":
        xt = xt.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    xt.requires_grad_(True)
    out = tsw.rotate_select(xt, _t(idx), n, -1.0, "border", mode)
    (grad,) = torch.autograd.grad(torch.sum(out * _t(w)), xt)
    np.testing.assert_allclose(grad.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kernel", ["select_planes", "select_planes_nhwc",
                                    "select_planes_rolled", "rolled_d4"])
def test_select_backward_matches_plain_autograd(kernel):
    """The kernels' backward (one more select of the cotangent, then a mask
    per source) against autograd through the plain versions' index ops."""
    rng = np.random.default_rng(7)
    B, C, N, S = 6, 8, 10, 3
    src = _t(rng.integers(0, S, size=B).astype(np.int32))
    k = _t(rng.integers(-4, 8, size=B).astype(np.int32))
    shift = _t(rng.integers(-8, 8, size=B).astype(np.int32))
    refl = _t(rng.integers(0, 2, size=B).astype(np.int32))
    shape = (B, N, N, C) if kernel == "select_planes_nhwc" else (B, C, N, N)
    srcs = [_t(rng.normal(size=shape).astype(np.float32)).requires_grad_(True)
            for _ in range(S)]
    g = _t(rng.normal(size=shape).astype(np.float32))
    if kernel == "select_planes":
        out = tsw.select_planes(srcs, src, k)
        ref = tsw.select_planes_plain(srcs, src, k)
    elif kernel == "select_planes_nhwc":
        out = tsw.select_planes_nhwc(srcs, src, k)
        ref = tsw.select_planes_nhwc_plain(srcs, src, k)
    elif kernel == "select_planes_rolled":
        out = tsw.select_planes_rolled(srcs, src, k, shift, 4, 4)
        ref = tsw.select_planes_plain(srcs, src, k, shift, None, 4, 4)
    else:
        out = tsw.select_planes_rolled(srcs, src, k, shift, 8, 4, refl)
        ref = tsw.select_planes_plain(srcs, src, k, shift, refl, 8, 4)
    assert out.grad_fn is not None and torch.equal(out, ref)
    ours = torch.autograd.grad(out, srcs, g)
    plain = torch.autograd.grad(ref, srcs, g)
    for a, b in zip(ours, plain):
        assert torch.equal(a, b)


def _bits(a: np.ndarray) -> np.ndarray:
    """The raw words of a float32 or bfloat16 array, as integers."""
    return a.view(np.int32 if a.dtype == np.float32 else np.int16)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("N", [7, 33])
@pytest.mark.parametrize("S", [1, 2, 3, 4])
@pytest.mark.parametrize("C", [1, 2, 3, 4, 5])
def test_k3_plain_bitidentical_to_pallas_any_sources(C, S, N, dtype):
    """K3's plain version against `_pallas_selectn_ilv` in interpret mode,
    compared as integers: 1-4 sources picked at random (not only the C_n
    tables), N not a multiple of the kernel's 32-pixel tiles, C = 1-5 and
    quarter-turn indices in [-8, 8), negative ones included."""
    rng = np.random.default_rng(100 * C + 10 * S + N)
    B = 5
    src = rng.integers(0, S, size=B).astype(np.int32)
    k = rng.integers(-8, 8, size=B).astype(np.int32)
    k[:2] = [-1, -3]
    pairs = [_pair(rng.normal(size=(B, N, N, C)).astype(np.float32), dtype)
             for _ in range(S)]
    ours = tsw.select_planes_nhwc([p[0] for p in pairs], _t(src), _t(k))
    flat = [p[1].reshape(B, N, N * C) for p in pairs]
    if len(flat) == 1:
        flat = flat * 2  # the JAX entry's degenerate second source
    ref = np.asarray(jsw._pallas_selectn_ilv(tuple(flat), jnp.asarray(src),
                                             jnp.asarray(k), C, interpret=True))
    ours_np = ours.view(torch.int32 if dtype == "float32" else torch.int16).numpy()
    assert np.array_equal(ours_np, _bits(ref).reshape(B, N, N, C))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [1, 3, 4, 8, 16])
def test_k3_launch_path_follows_channels_dtype_and_alignment(dtype, C):
    """K3 takes K5's 16-byte-word path when a pixel is whole words and every
    source and the output are 16-byte aligned, else the shared-memory tile
    path; the choice reads only shapes and pointers."""
    srcs = [torch.zeros(2, 9, 9, C, dtype=dtype) for _ in range(2)]
    out = torch.empty_like(srcs[0])
    whole = (C * srcs[0].element_size()) % 16 == 0
    assert tsw._nhwc_path(srcs, out) == ("word" if whole else "tile")
    view = torch.zeros(srcs[0].numel() + 1, dtype=dtype)[1:].view_as(srcs[0])
    assert tsw._nhwc_path([srcs[0], view], out) == "tile"
    assert tsw._nhwc_path(srcs, view) == "tile"


def test_k3_launch_checks_the_per_sample_offset_limit():
    """The kernels address a sample with int offsets: N * N * C >= 2^31 is
    refused before any launch."""
    big = torch.empty(1, 46341, 46341, 1, device="meta")
    zero = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        tsw._launch("select_planes_nhwc", [big], zero, zero, None, None, 1, 1)
