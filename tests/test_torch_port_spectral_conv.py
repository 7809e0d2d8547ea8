"""The spectral convolution (`ops/kernels/spectral_conv.py`) and
`SteerableConv`'s spectral path, on the CPU (the contraction's plain
version; the CUDA kernel runs in `chip_smoke.py`):

* `spectral_contraction_plain` against numpy's complex128 product bin by bin;
* `spectral_conv2d` with `kernel_spectrum` against `F.conv2d` in float64 on
  the same kernel: steerable.yaml's hidden layer (80 -> 80, kernel 9, 56
  px), its last layer (80 -> 4, 48 px), padded and non-square maps;
* `SteerableConv` at steerable.yaml's widths (16 fields of each order 0,
  1, 2; kernel 9; a batch of 2 at 56 px) under grad mode off, which takes
  the spectral path, against JAX's `SteerableConv` and against `F.conv2d`
  of its own kernel;
* the route (`conv_path`), read through `paths/steerable_conv/*`: grad on,
  bf16 and stride 2 go direct, the yaml hidden layer at 56 px goes
  spectral, a layer whose direct count wins goes direct;
* the FFT size rule, the output tiles, the kernel operator's fake;
* the CUDA branch's gradient guard (routed to the card, launch stubbed):
  a complex input that requires grad is refused before the launch.

Bar: every step of the spectral path is exact in real arithmetic, and in
fp32 the two transforms round at about 1e-7 of the maps' norm a pass (1e-6
relative to the largest output was read here and on the card, at the yaml
widths); the outputs agree within 1e-5 times the reference's largest value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from equiadapt_tpu.images.networks import steerable as jst
import equiadapt_tpu_torch as tp
from equiadapt_tpu_torch.images.networks import steerable as tst
from equiadapt_tpu_torch.ops.kernels import _build
from equiadapt_tpu_torch.ops.kernels import spectral_conv as sc
from equiadapt_tpu_torch.utils.jax_weights import flax_variables
from equiadapt_tpu_torch.utils.profiling import counters
from torch_port_cpu import one_intra_op_thread  # noqa: F401

HIDDEN = (0,) * 16 + (1,) * 16 + (2,) * 16  # steerable.yaml: 80 channels
BAR = 1e-5


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=BAR * np.abs(ref).max())


@pytest.mark.parametrize("B,Cin,Cout,Nh,Nf", [(2, 3, 5, 8, 5), (3, 80, 80, 56, 29),
                                               (1, 7, 4, 10, 6)])
def test_plain_contraction_matches_numpy_in_complex128(B, Cin, Cout, Nh, Nf):
    g = torch.Generator().manual_seed(Cin)
    x = torch.randn(B, Cin, Nh, Nf, dtype=torch.complex64, generator=g)
    k = torch.randn(Cin, Cout, Nh, Nf, dtype=torch.complex64, generator=g)
    got = sc.spectral_contraction(x, k)
    assert got.shape == (B, Cout, Nh, Nf) and got.dtype == torch.complex64
    assert torch.equal(got, sc.spectral_contraction_plain(x, k))
    xs, ks = x.numpy().astype(np.complex128), k.numpy().astype(np.complex128)
    ref = np.einsum("bihw,iohw->bohw", xs, ks)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=BAR * np.abs(ref).max())


@pytest.mark.parametrize("B,Cin,Cout,H,W,K,padding", [
    (2, 80, 80, 56, 56, 9, 0),   # steerable.yaml's hidden layer at the so2 cell's size
    (2, 80, 4, 48, 48, 9, 0),    # its last layer
    (3, 5, 3, 13, 17, 5, 2),     # padded, non-square
    (2, 4, 6, 9, 9, 3, 1),       # an odd size: the transforms at 12
])
def test_spectral_conv2d_matches_conv2d(B, Cin, Cout, H, W, K, padding):
    g = torch.Generator().manual_seed(H + K)
    x = torch.randn(B, Cin, H, W, generator=g)
    kernel = torch.randn(Cout, Cin, K, K, generator=g) / K
    fft = sc.fft_shape(H, W, padding)
    got = sc.spectral_conv2d(x, sc.kernel_spectrum(kernel, fft, padding), K, padding)
    _close(got, F.conv2d(x.double(), kernel.double(), padding=padding))


def _path_counts():
    c = counters()
    return {p: c.get(f"paths/steerable_conv/{p}", 0) for p in ("spectral", "direct")}


def _counted(fn):
    before = _path_counts()
    out = fn()
    after = _path_counts()
    return out, {p: after[p] - before[p] for p in after}


def test_spectral_path_matches_jax_steerable_conv_at_the_yaml_widths():
    """The yaml hidden layer under no_grad takes the spectral path; its
    output equals JAX's SteerableConv (the Flax module's own assembly and
    XLA convolution) and `F.conv2d` of the port's kernel in float64."""
    conv = tst.SteerableConv(HIDDEN, HIDDEN, 9, device="cpu",
                             generator=torch.Generator().manual_seed(5))
    x = np.random.default_rng(6).normal(size=(2, 56, 56, 80)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got, paths = _counted(lambda: conv(xt))
    assert paths == {"spectral": 1, "direct": 0}
    _close(got, F.conv2d(xt.double(), conv.kernel().detach().double()))
    jconv = jst.SteerableConv(in_orders=HIDDEN, out_orders=HIDDEN, kernel_size=9, padding=0)
    ref = np.asarray(jconv.apply(flax_variables(conv), jnp.asarray(x)))
    _close(got.permute(0, 2, 3, 1).numpy(), ref)


def _conv(cin_fields, cout_fields, K, stride=1):
    return tst.SteerableConv((0,) * cin_fields, (1,) * cout_fields, K, stride=stride,
                             device="cpu", generator=torch.Generator().manual_seed(0))


ROUTES = {
    # the conv, the input's shape and dtype, grad mode, the path
    "grad_on": (lambda: tst.SteerableConv(HIDDEN, HIDDEN, 9, device="cpu"),
                (1, 80, 56, 56), torch.float32, True, "direct"),
    "bf16": (lambda: tst.SteerableConv(HIDDEN, HIDDEN, 9, device="cpu"),
             (1, 80, 56, 56), torch.bfloat16, False, "direct"),
    "yaml_hidden_56px": (lambda: tst.SteerableConv(HIDDEN, HIDDEN, 9, device="cpu"),
                         (2, 80, 56, 56), torch.float32, False, "spectral"),
    "direct_count_wins": (lambda: _conv(3, 4, 3), (2, 3, 16, 16), torch.float32, False,
                          "direct"),
    "stride_2": (lambda: _conv(3, 4, 9, stride=2), (2, 3, 56, 56), torch.float32, False,
                 "direct"),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_the_route_follows_grad_dtype_stride_and_counts(case):
    make, shape, dtype, grad, path = ROUTES[case]
    conv = make()
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(1)).to(dtype)
    with torch.set_grad_enabled(grad):
        assert sc.conv_path(x, conv.kernel().shape[0], conv.kernel_size, conv.stride,
                            conv.padding) == path
        out, paths = _counted(lambda: conv(x))
    assert paths == {"spectral": int(path == "spectral"), "direct": int(path == "direct")}
    assert out.dtype == dtype
    B, C, H, W = shape
    direct, spectral = sc.conv_counts(B, C, conv.kernel().shape[0], H, W, conv.kernel_size, 0)
    if case in ("yaml_hidden_56px", "direct_count_wins"):
        assert (spectral * sc.MARGIN < direct) == (path == "spectral")


def test_fft_sizes_are_even_and_7_smooth():
    assert [sc._fft_size(n) for n in (1, 9, 20, 28, 48, 56, 57, 62, 97)] == [
        2, 10, 20, 28, 48, 56, 60, 64, 98]
    assert sc.fft_shape(13, 17, 2) == (18, 24)


def test_output_tiles_and_the_operator_fake():
    assert [sc._OUT_TILES[sc._out_tile(c)] for c in (1, 4, 8, 9, 80, 81)] == [
        8, 8, 8, 80, 80, 80]
    x = torch.empty(3, 80, 56, 29, dtype=torch.complex64, device="meta")
    k = torch.empty(80, 4, 56, 29, dtype=torch.complex64, device="meta")
    with _build.shapes_only():
        out = sc.spectral_contraction(x, k)
    assert out.device.type == "meta" and out.shape == (3, 4, 56, 29)
    assert out.dtype == torch.complex64
    assert sc._contraction_op(x, k).shape == (3, 4, 56, 29)
    with pytest.raises(ValueError):
        sc.spectral_contraction(torch.zeros(3, 5, 4, 3, dtype=torch.complex64),
                                torch.zeros(4, 2, 4, 3, dtype=torch.complex64))


@pytest.mark.parametrize("which", ["x_hat", "k_hat"])
def test_the_cuda_branch_refuses_grad_before_launch(which, monkeypatch):
    """Routed to the card (launch stubbed), `spectral_contraction` refuses
    a complex input that requires grad under grad mode, before it launches,
    since the kernel has no backward and the CPU's einsum is
    differentiable; it launches under no_grad or with the input
    detached."""
    calls = []

    def launch(x_hat, k_hat):
        calls.append(1)
        return sc._fake(x_hat, k_hat)

    monkeypatch.setattr(_build, "route", lambda tensors, kernels: "cuda")
    monkeypatch.setattr(sc, "_contraction_op", launch)
    inputs = {"x_hat": torch.zeros(2, 3, 4, 3, dtype=torch.complex64),
              "k_hat": torch.zeros(3, 5, 4, 3, dtype=torch.complex64)}
    inputs[which].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward on the card.*direct F.conv2d"):
        sc.spectral_contraction(inputs["x_hat"], inputs["k_hat"])
    assert calls == []
    with torch.no_grad():
        assert sc.spectral_contraction(inputs["x_hat"], inputs["k_hat"]).shape == (2, 5, 4, 3)
    sc.spectral_contraction(*(t.detach() for t in inputs.values()))
    assert len(calls) == 2
    # on the CPU the plain version is differentiable
    monkeypatch.undo()
    assert sc.spectral_contraction(inputs["x_hat"], inputs["k_hat"]).grad_fn is not None


def test_the_spectral_network_keeps_its_spectra():
    """steerable.yaml's network at 64 px under no_grad: the hidden layer's
    spectrum is built on the first call and reused after; a new image size
    builds a new one."""
    net = tp.SteerableNetwork(3, 16, 9, num_layers=2, device="cpu").eval()
    x = torch.randn(2, 64, 64, 3)
    with torch.no_grad():
        net(x)
        first = net.SteerableConv_1._cache.spectrum
        net(x)
        assert net.SteerableConv_1._cache.spectrum is first
        assert first.shape == (80, 80, 56, 29) and first.dtype == torch.complex64
        net(torch.randn(2, 72, 72, 3))
    assert net.SteerableConv_1._cache.fft == (64, 64)
