"""The BatchNorm-residual-ReLU kernel's plain version and its route, on the
CPU (`ops/kernels/bn_act.py`; the CUDA kernel runs in `chip_smoke.py`
phase 27). No JAX: the JAX package has no such kernel (XLA fuses the
passes into its convolutions).

`bn_act_plain` is held against today's composition (`F.batch_norm`, the
add, `torch.relu`); the ResNets against themselves with the fused path
unavailable, with the route made to take it on the CPU (`fused` below:
`takes` sees a card, the launch is the plain version, counted by form).
"""

import copy

import pytest
import torch
import torch.nn.functional as F

from equiadapt_tpu_torch.common.layers import BatchNorm
from equiadapt_tpu_torch.models.resnet import ResNet18, ResNet50, WideResNet50
from equiadapt_tpu_torch.ops.kernels import _build, bn_act
from equiadapt_tpu_torch.utils import profiling
from torch_port_cpu import one_intra_op_thread  # noqa: F401

FORMS = bn_act.FORMS
# one bf16 rounding: |round(x) - x| <= 2^-8 |x|
BF16_ROUNDING = 2.0 ** -8


def _bn(C, seed):
    """A BatchNorm with drawn parameters and statistics."""
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm(C, device="cpu")
    with torch.no_grad():
        bn.weight.copy_(1.0 + 0.3 * torch.randn(C, generator=g))
        bn.bias.copy_(0.3 * torch.randn(C, generator=g))
        bn.running_mean.copy_(0.5 * torch.randn(C, generator=g))
        bn.running_var.copy_(0.25 + 2.0 * torch.rand(C, generator=g))
    return bn


def _act(shape, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).contiguous(
        memory_format=torch.channels_last)


def _case(form, C, dtype, seed=0):
    y = _act((2, C, 5, 7), seed, dtype)
    r = None if form == "none" else _act((2, C, 5, 7), seed + 1, dtype)
    return y, _bn(C, seed + 2), r, _bn(C, seed + 3) if form == "projected" else None


def _composed(y, bn, r, rbn):
    """Today's composition: F.batch_norm, the residual (its BatchNorm), the add, ReLU."""
    def norm(x, m):
        return F.batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias, False, 0.0,
                            m.eps)
    out = norm(y, bn)
    if r is not None:
        out = out + (r if rbn is None else norm(r, rbn))
    return torch.relu(out)


# ------------------------------------------------ the plain version's arithmetic


@pytest.mark.parametrize("C", [64, 256, 2048])
@pytest.mark.parametrize("form", FORMS)
def test_plain_fp32_matches_the_composition(form, C):
    y, bn, r, rbn = _case(form, C, torch.float32)
    with torch.no_grad():
        got = bn_act.bn_act_plain(y, bn, r, rbn)
        want = _composed(y, bn, r, rbn)
    assert got.dtype == torch.float32 and got.shape == y.shape
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    assert (got >= 0).all()


@pytest.mark.parametrize("C", [64, 256, 2048])
@pytest.mark.parametrize("form", FORMS)
def test_plain_bf16_is_one_rounding_of_the_fp32_composition(form, C):
    """bf16 in, bf16 out, computed in fp32 and rounded once: within one
    bf16 rounding of the composition recomputed in fp32 from the same bf16
    inputs (and the fp32 versions' own 1e-6 of the largest value)."""
    y, bn, r, rbn = _case(form, C, torch.bfloat16, seed=10)
    with torch.no_grad():
        got = bn_act.bn_act_plain(y, bn, r, rbn)
        want = _composed(y.float(), bn, None if r is None else r.float(), rbn)
    assert got.dtype == torch.bfloat16
    err = (got.float() - want).abs()
    bar = BF16_ROUNDING * want.abs() + 1e-6 * float(want.abs().max())
    assert bool((err <= bar).all()), float((err - bar).max())


def test_plain_keeps_nan_and_clamps_negatives():
    y, bn, _, _ = _case("none", 8, torch.float32)
    y = y.clone()
    y[0, 0, 0, 0] = float("nan")
    with torch.no_grad():
        got = bn_act.bn_act_plain(y, bn)
    assert torch.isnan(got[0, 0, 0, 0])
    assert bool((got[~torch.isnan(got)] >= 0).all())


def test_forms_and_argument_checks():
    y, bn, r, rbn = _case("projected", 16, torch.float32)
    assert [bn_act._form(a, b) for a, b in ((None, []), (r, []), (r, [rbn.weight]))] == list(FORMS)
    with pytest.raises(ValueError, match="needs a residual"):
        bn_act.bn_act_plain(y, bn, None, rbn)
    with pytest.raises(ValueError, match="shape and dtype"):
        bn_act.bn_act_plain(y, bn, r[:1])
    with pytest.raises(ValueError, match="parameters and statistics"):
        bn_act.bn_act_plain(y, _bn(8, 1))
    with pytest.raises(ValueError, match=r"\(N, C, H, W\)"):
        bn_act.bn_act_plain(y[0], bn)


def test_wrapper_routes_cpu_to_plain_and_meta_to_its_shape():
    y, bn, r, rbn = _case("projected", 16, torch.float32)
    with torch.no_grad():
        assert torch.equal(bn_act.bn_act(y, bn, r, rbn), bn_act.bn_act_plain(y, bn, r, rbn))
    meta = torch.empty(y.shape, device="meta").contiguous(memory_format=torch.channels_last)
    with _build.shapes_only():
        out = bn_act.bn_act(meta, bn.to("meta"))
    assert out.device.type == "meta" and out.shape == y.shape
    assert out.is_contiguous(memory_format=torch.channels_last)


# ------------------------------------------------------------------ the route


def test_takes_only_what_the_kernel_takes(monkeypatch):
    monkeypatch.setattr(bn_act, "_on_card", lambda t: True)
    y = _act((2, 16, 5, 7), 0)
    with torch.no_grad():
        assert bn_act.takes(y, False)
        assert bn_act.takes(y, False, _act((2, 16, 5, 7), 1))
        assert bn_act.takes(y.bfloat16(), False, _act((2, 16, 5, 7), 1, torch.bfloat16))
        assert not bn_act.takes(y, True)  # train-mode statistics
        assert not bn_act.takes(y.contiguous(), False)  # NCHW
        assert not bn_act.takes(y.half(), False)
        assert not bn_act.takes(_act((2, 12, 5, 7), 0), False)  # C % 8
        assert not bn_act.takes(_act((1, 4096, 2, 2), 0), False)  # C > MAX_CHANNELS
        assert not bn_act.takes(y[0], False)
        # a start 4 bytes into its storage
        off = torch.empty(2 * 16 * 5 * 7 + 1)[1:].view(2, 5, 7, 16).permute(0, 3, 1, 2)
        assert off.is_contiguous(memory_format=torch.channels_last)
        assert not bn_act.takes(off, False)
        assert not bn_act.takes(y, False, y.contiguous())  # a residual in another layout
        assert not bn_act.takes(y, False, y.bfloat16())
        assert not bn_act.takes(y, False, y[:1])
    assert not bn_act.takes(y, False)  # grad mode on
    monkeypatch.setattr(bn_act, "_on_card", lambda t: t.device.type == "cuda")
    with torch.no_grad():
        assert not bn_act.takes(y, False)  # the CPU


@pytest.fixture
def fused(monkeypatch):
    """Turns the fused path on for the CPU when called: `takes` sees a card,
    every wrapper takes its CUDA branch, and the launch is the plain
    version, counted by dtype and form as the kernel's launches are.
    Returns `bn_act.path_launches`."""
    def on():
        monkeypatch.setattr(bn_act, "_on_card", lambda t: True)
        monkeypatch.setattr(_build, "route", lambda tensors, kernels: "cuda")

        def launch(y, params, eps, residual, r_params, r_eps):
            bn_act._count(y.dtype, bn_act._form(residual, r_params))
            return bn_act._plain(y, params, eps, residual, r_params, r_eps)

        monkeypatch.setattr(bn_act, "_launch", launch)
        bn_act.reset_launches()
        return bn_act.path_launches

    yield on
    bn_act.reset_launches()


def _randomize_norms(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                C = m.num_features
                m.weight.copy_(0.5 + 0.5 * torch.rand(C, generator=g))
                m.bias.copy_(0.2 * torch.randn(C, generator=g))
                m.running_mean.copy_(0.2 * torch.randn(C, generator=g))
                m.running_var.copy_(0.5 + torch.rand(C, generator=g))
    return model


ARCHS = {
    # (constructor, launches by form a forward: the stem, then each block's)
    "resnet50": (ResNet50, {"none": 33, "identity": 12, "projected": 4}),
    "resnet18": (ResNet18, {"none": 9, "identity": 5, "projected": 3}),
    "wide_resnet50": (WideResNet50, {"none": 33, "identity": 12, "projected": 4}),
}


def _model(arch, return_stages):
    build, _ = ARCHS[arch]
    kw = {"num_classes": None, "return_stages": True} if return_stages else {}
    torch.manual_seed(3)
    return _randomize_norms(build(device="cpu", **kw), 4)


def _images(seed=5, b=2, size=32):
    return torch.randn(b, size, size, 3, generator=torch.Generator().manual_seed(seed))


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("return_stages", [False, True], ids=["logits", "stages"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_fused_resnet_matches_the_composed_modules(arch, return_stages, fused):
    """Eval under no_grad on an NHWC batch (the convolutions channels-last):
    the fused path's logits (or the four stage maps) within fp32 rounding
    (1e-5 of the largest value) of the same module with the fused path
    unavailable; every site one launch, split by form as the architecture
    has them, and `counters()` reports them."""
    model = _model(arch, return_stages)
    x = _images()
    with torch.no_grad():
        want = _as_tuple(model(x, training=False))
    paths = fused()
    before = profiling.counters()
    with torch.no_grad():
        got = _as_tuple(model(x, training=False))
    assert len(got) == len(want) == (4 if return_stages else 1)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    by_form = {k.rsplit("/", 1)[1]: v for k, v in paths.items()}
    assert by_form == ARCHS[arch][1]
    after = profiling.counters()
    assert after["launches/bn_act/float32"] - before.get("launches/bn_act/float32", 0) == sum(
        ARCHS[arch][1].values())
    for form, n in ARCHS[arch][1].items():
        key = f"paths/bn_act/float32/{form}"
        assert after[key] - before.get(key, 0) == n


def _nchw_images():
    """An NHWC batch as a view of NCHW memory: the convolutions run NCHW
    (at 64 px the last stage is 2 x 2; at 1 x 1 the two layouts are one)."""
    return _images(size=64).permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)


@pytest.mark.parametrize("arch", ["resnet50", "resnet18"])
@pytest.mark.parametrize("case", ["training", "grad_enabled", "nchw"])
def test_present_path_runs_where_the_kernel_does_not(arch, case, fused):
    """With training=True, with grad mode on, or on NCHW activations the
    modules are composed as before (the output equal to the run without the
    route, statistics and gradients included) and no launch is counted."""
    model = _model(arch, False)
    twin = copy.deepcopy(model)
    x = _nchw_images() if case == "nchw" else _images()
    training = case == "training"
    grad = case != "nchw"

    def run(m):
        with torch.set_grad_enabled(grad):
            out = m(x, training=training)
            if grad:
                out.square().mean().backward()
        return out

    want = run(twin)
    paths = fused()
    got = run(model)
    assert paths == {} and bn_act.launches == {}
    assert torch.equal(got, want)
    if grad:
        for (name, a), b in zip(model.named_parameters(), twin.parameters()):
            assert torch.equal(a.grad, b.grad), name
    for a, b in zip(model.buffers(), twin.buffers()):
        assert torch.equal(a, b)


def test_present_path_in_bf16_is_the_composed_chain(fused):
    """A bf16 ResNet-18 under grad mode composes the modules as before: its
    logits bit-equal to a run without the route."""
    model = _model("resnet18", False)
    model.dtype = torch.bfloat16
    x = _images()
    with torch.enable_grad():
        want = model(x, training=False)
        paths = fused()
        got = model(x, training=False)
    assert paths == {} and torch.equal(got, want)


# -------------------------------------------------------------- the launch


class _StubLib:
    """Records the C call (`eqt_bn_act`) and returns `err`."""

    def __init__(self, err=0):
        self.calls, self.err = [], err

    def eqt_bn_act(self, *args):
        self.calls.append(args)
        return self.err


@pytest.fixture
def stub_lib(monkeypatch):
    lib = _StubLib()
    monkeypatch.setattr(bn_act, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 77})())
    bn_act.reset_launches()
    yield lib
    bn_act.reset_launches()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", FORMS)
def test_launch_hands_the_library_its_arguments(form, dtype, stub_lib):
    """Pointers, eps, rows (N H W), channels, the form's and the dtype's
    codes and the stream, as `csrc/bn_act.cu`'s `eqt_bn_act` reads them; a
    new channels-last output; the launch counted by dtype and form."""
    y, bn, r, rbn = _case(form, 24, dtype)
    params, r_params, _ = bn_act._args(y, bn, r, rbn)
    out = bn_act._launch(y, params, bn.eps, r, r_params, 1e-3)
    (args,) = stub_lib.calls
    y_p, r_p, out_p, ptrs, eps, r_eps, rows, C, form_code, dtype_code, stream = args
    assert (y_p, out_p) == (y.data_ptr(), out.data_ptr()) and out_p != y_p
    assert r_p == (None if r is None else r.data_ptr())
    want = [p.data_ptr() for p in params] + ([p.data_ptr() for p in r_params] or [None] * 4)
    assert list(ptrs) == want
    assert (eps, r_eps, rows, C, stream) == (bn.eps, 1e-3, 2 * 5 * 7, 24, 77)
    assert FORMS[form_code] == form and dtype_code == _build.DTYPE_CODES[dtype]
    assert out.shape == y.shape and out.dtype == dtype
    assert out.is_contiguous(memory_format=torch.channels_last)
    tag = str(dtype).removeprefix("torch.")
    assert bn_act.launches == {f"bn_act/{tag}": 1}
    assert bn_act.path_launches == {f"bn_act/{tag}/{form}": 1}


def test_a_module_with_bf16_parameters_launches_on_fp32_copies(stub_lib, monkeypatch):
    """A ResNet cast to bf16 whole (parameters and statistics) takes the
    kernel too: the wrapper hands it fp32 copies of the BatchNorm's values;
    the plain version reads the same values."""
    monkeypatch.setattr(_build, "route", lambda tensors, kernels: "cuda")
    y, bn, r, rbn = _case("projected", 16, torch.bfloat16)
    bn, rbn = bn.to(torch.bfloat16), rbn.to(torch.bfloat16)
    with torch.no_grad():
        bn_act.bn_act(y, bn, r, rbn)
        plain = bn_act.bn_act_plain(y, bn, r, rbn)
        want = bn_act.bn_act_plain(y, bn.float(), r, rbn.float())
    (args,) = stub_lib.calls
    assert all(p is not None for p in args[3])
    assert bn_act.path_launches == {"bn_act/bfloat16/projected": 1}
    assert torch.equal(plain, want)


def test_launch_refuses_what_the_kernel_cannot_read(stub_lib):
    y, bn, r, _ = _case("identity", 16, torch.float32)
    params = bn_act._args(y, bn, None, None)[0]
    for bad in (y.contiguous(), y.half(), _act((2, 12, 5, 7), 0)):
        with pytest.raises(ValueError, match="channels-last"):
            bn_act._launch(bad, bn_act._args(bad, _bn(bad.shape[1], 0), None, None)[0], 1e-5,
                           None, [], 0.0)
    with pytest.raises(ValueError, match="channels-last"):
        bn_act._launch(y, params, 1e-5, r.contiguous(), [], 0.0)
    with pytest.raises(TypeError, match="fp32"):
        bn_act._launch(y, [p.bfloat16() for p in params], 1e-5, None, [], 0.0)
    stub_lib.err = 9
    with pytest.raises(RuntimeError, match="cudaError 9"):
        bn_act._launch(y, params, 1e-5, None, [], 0.0)
    assert stub_lib.calls and bn_act.launches == {}


def test_the_card_refuses_a_call_that_needs_a_gradient(monkeypatch):
    """On the card a direct call under grad mode with parameters that
    require grad raises before it launches (`_build.refuse_grad`); the
    ResNets never send one there (`takes`)."""
    monkeypatch.setattr(_build, "route", lambda tensors, kernels: "cuda")
    monkeypatch.setattr(bn_act, "_launch", lambda *a: pytest.fail("launched"))
    y, bn, _, _ = _case("none", 8, torch.float32)
    with pytest.raises(RuntimeError, match="composed modules"):
        bn_act.bn_act(y, bn)


def test_an_exported_resnet_keeps_its_launches(fused):
    """`torch.export` of an eval ResNet-18 on the fused route, at a symbolic
    batch: the graph holds one `eqt.bn_act` node a site (the fake decides
    as the card does, from the storage offset), and the loaded artifact
    launches each at another batch and answers as the composed modules."""
    import io

    from equiadapt_tpu_torch.utils.export import export_apply, load_exported

    model = _model("resnet18", False)
    x = _images(b=3)
    with torch.no_grad():
        want = model(x, training=False)
    paths = fused()
    blob = export_apply(lambda m, b: m(b, training=False), model, _images(b=2),
                        symbolic_batch=True)
    assert paths == {}  # tracing launches nothing
    graph = torch.export.load(io.BytesIO(blob)).graph
    assert sum(str(n.target) == "eqt.bn_act.default" for n in graph.nodes) == 17
    with torch.no_grad():
        got = load_exported(blob)(x)
    assert {k.rsplit("/", 1)[1]: v for k, v in paths.items()} == ARCHS["resnet18"][1]
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
