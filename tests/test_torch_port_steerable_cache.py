"""The steerable network's grad-off kernel reuse and device-resident field
indices (`images/networks/steerable.py`), on the CPU at
`configs/canonicalization/steerable.yaml`'s widths and a small image:

* grad off (`torch.no_grad()`, `torch.inference_mode()`): the first call
  assembles each `SteerableConv`'s kernel (3 misses), the second reuses
  it (3 hits), both `torch.equal` to a new network's first grad-off call
  with the same weights, which assembles live on the same path. The
  hidden layer takes the spectral path there and the grad-on call the
  direct one, so the grad-on output is held within the spectral path's
  bar (`test_torch_port_spectral_conv.py`: 1e-5 times the largest value);
* every way of changing the weights (an in-place copy, an AdamW step,
  `.data` reassignment, `load_state_dict(assign=True)`, `.to(float64)` and
  back, the Flax loader) is seen: the next grad-off output is
  `torch.equal` to a fresh network's with the same weights, and misses
  are counted;
* grad on: no kept kernel is read, the output is `torch.equal` to a new
  network's grad-on call (and the kept grad-off output to a new network's
  grad-off call: each on its own path), the gradients reach every leaf;
* `NormNonlinearity`'s index buffers are int64 tensors on the module's
  device, outside the `state_dict`, and index as the Python lists did.

The card test (`card` marker; skips without CUDA; this file imports no
JAX) runs the so2 canonicalizer's eval forward at the serving shapes under
`torch.cuda.set_sync_debug_mode("error")`, its hidden layer on the spectral
path through the contraction kernel:

    python -m pytest --noconftest tests/test_torch_port_steerable_cache.py
"""

import numpy as np
import pytest
import torch

import equiadapt_tpu_torch as tp
from equiadapt_tpu_torch.images.networks import steerable as tst
from equiadapt_tpu_torch.utils.jax_weights import flax_variables
from equiadapt_tpu_torch.utils.profiling import counters
from torch_port_cpu import one_intra_op_thread  # noqa: F401

YAML = dict(in_channels=3, out_channels=16, kernel_size=9, num_layers=2)
HIT, MISS = "steerable/kernel_cache_hit", "steerable/kernel_cache_miss"
# the spectral path against the direct one: fp32 transforms, 1e-5 times the
# largest value (test_torch_port_spectral_conv.py)
SPECTRAL_BAR = 1e-5


def _spectral_close(got, ref):
    got, ref = got.double().cpu().numpy(), ref.double().cpu().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=SPECTRAL_BAR * np.abs(ref).max())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the H100")
    return "cuda:0"


def _cache_counts():
    c = counters()
    return c.get(HIT, 0), c.get(MISS, 0)


class _Counted:
    """Hits and misses counted inside the block (`.hits`, `.misses`)."""

    def __enter__(self):
        self._start = _cache_counts()
        return self

    def __exit__(self, *exc):
        hits, misses = _cache_counts()
        self.hits, self.misses = hits - self._start[0], misses - self._start[1]


def _net(seed=0, **kw):
    gen = torch.Generator().manual_seed(seed)
    return tp.SteerableNetwork(**(kw or YAML), device="cpu", generator=gen).eval()


def _images(seed=1, b=2, size=28):
    return torch.randn(b, size, size, 3, generator=torch.Generator().manual_seed(seed))


def _fresh_output(net, x, **kw):
    """The grad-off output of a new network holding `net`'s weights."""
    fresh = _net(seed=99, **kw)
    fresh.load_state_dict(net.state_dict())
    with torch.no_grad():
        return fresh(x)


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_grad_off_reuses_the_assembled_kernel(mode):
    net, x = _net(), _images()
    live = net(x).detach()
    off = torch.no_grad if mode == "no_grad" else torch.inference_mode
    with off():
        with _Counted() as first:
            a = net(x)
        with _Counted() as second:
            b = net(x)
    assert (first.misses, first.hits) == (3, 0)
    assert (second.misses, second.hits) == (0, 3)
    fresh = _fresh_output(net, x)
    assert torch.equal(a, fresh) and torch.equal(b, fresh)
    _spectral_close(a, live)


def _inplace_copy(net):
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn_like(p))


def _adamw_step(net):
    for p in net.parameters():
        p.grad = torch.randn_like(p)
    torch.optim.AdamW(net.parameters(), lr=0.1).step()


def _data_reassign(net):
    for conv in (m for m in net.modules() if isinstance(m, tst.SteerableConv)):
        for n in conv._names:
            p = getattr(conv, n)
            p.data = p.detach().double()
            p.data = (2 * p.detach()).float()  # may land where the fp32 leaf was


def _load_state_dict_assign(net):
    state = {k: 1.5 * v.clone() for k, v in net.state_dict().items()}
    net.load_state_dict(state, assign=True)


def _to_float64_and_back(net):
    net.to(torch.float64)
    net.to(torch.float32)


def _flax_loader(net):
    tp.load_flax_variables(net, flax_variables(_net(seed=7)))


CHANGES = {"inplace_copy": _inplace_copy, "adamw_step": _adamw_step,
           "data_reassign": _data_reassign,
           "load_state_dict_assign": _load_state_dict_assign,
           "to_float64_and_back": _to_float64_and_back, "flax_loader": _flax_loader}


@pytest.mark.parametrize("change", list(CHANGES))
def test_a_weight_change_is_seen(change):
    net, x = _net(), _images()
    with torch.no_grad():
        before = net(x)
        net(x)
    CHANGES[change](net)
    with _Counted() as counted, torch.no_grad():
        after = net(x)
    assert (counted.misses, counted.hits) == (3, 0)
    assert torch.equal(after, _fresh_output(net, x))
    if change != "to_float64_and_back":  # the only change that keeps the values
        assert not torch.equal(after, before)


def test_grad_on_assembles_live_and_reaches_every_leaf():
    net, x = _net(), _images()
    with torch.inference_mode():
        kept = net(x)
        net(x)
    with _Counted() as counted:
        out = net(x)
    assert (counted.hits, counted.misses) == (0, 0)
    fresh = _net(seed=99)
    fresh.load_state_dict(net.state_dict())
    assert out.grad_fn is not None and torch.equal(out.detach(), fresh(x).detach())
    assert torch.equal(kept, _fresh_output(net, x))
    assert all(conv._cache is None for conv in net.modules()
               if isinstance(conv, tst.SteerableConv))
    out.square().sum().backward()
    leaves = [(n, p) for n, p in net.named_parameters() if ".w_" in n]
    assert len(leaves) == 144 + 2304 + 96
    for n, p in leaves:
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), n
    assert sum(bool(p.grad.abs().sum() > 0) for _, p in leaves) == len(leaves)


def test_traced_calls_keep_nothing():
    """`torch.export` under no_grad after a kernel was kept: the program
    assembles from the leaves (no kept kernel as a constant), and no hit or
    miss is counted."""
    kw = dict(in_channels=3, out_channels=2, kernel_size=3, num_layers=1)
    net, x = _net(**kw), _images(size=12)
    with torch.no_grad():
        eager = net(x)
    with _Counted() as counted, torch.no_grad():
        program = torch.export.export(net, (x,))
    assert (counted.hits, counted.misses) == (0, 0)
    assert set(program.constants) <= {n for n, _ in net.named_buffers()}
    assert torch.equal(program.module()(x), eager)


def _expected_keys(cfg):
    hidden = (0,) * cfg["out_channels"] + (1,) * cfg["out_channels"] + (2,) * cfg["out_channels"]
    keys, cur = [], (0,) * cfg["in_channels"]
    for i in range(cfg["num_layers"]):
        keys += [f"SteerableConv_{i}.w_{fo}_{fi}"
                 for fi in range(len(cur)) for fo in range(len(hidden))]
        keys += [f"NormBatchNorm_{i}.scale", f"NormBatchNorm_{i}.norm_sq"]
        keys += [f"NormNonlinearity_{i}.bias_{fi}" for fi, m in enumerate(hidden) if m]
        cur = hidden
    i = cfg["num_layers"]
    keys += [f"SteerableConv_{i}.w_{fo}_{fi}" for fi in range(len(cur)) for fo in range(2)]
    return keys


def test_index_buffers_stay_on_the_device_and_out_of_the_state_dict():
    net = _net()
    assert sorted(net.state_dict()) == sorted(_expected_keys(YAML))
    assert all(v.dim() == 2 and v.shape[1] == 2
               for k, v in net.state_dict().items() if ".w_" in k)
    nl = net.NormNonlinearity_0
    for name in ("_scalar", "_re", "_im", "_order"):
        index = getattr(nl, name)
        assert isinstance(index, torch.Tensor) and index.dtype == torch.int64
        assert index.device.type == "cpu"
    assert nl._scalar.tolist() == list(range(16))
    assert nl._re.tolist() == list(range(16, 80, 2))
    assert nl._im.tolist() == list(range(17, 80, 2))
    moved = net.NormNonlinearity_1.to("meta")
    assert all(getattr(moved, n).device.type == "meta" for n in ("_scalar", "_order"))


@pytest.mark.parametrize("grad", [False, True])
def test_norm_nonlinearity_indexes_as_the_lists_did(grad):
    orders = (0, 1, 2, 0, 1)
    nl = tst.NormNonlinearity(orders, device="cpu")
    with torch.no_grad():
        for n in nl._bias_names:
            getattr(nl, n).normal_()
    x = torch.randn(2, 8, 5, 5, requires_grad=grad)
    scalar, re, im = [0, 5], [1, 3, 6], [2, 4, 7]
    order = list(np.argsort(scalar + re + im))
    parts = [torch.nn.functional.gelu(x[:, scalar], approximate="tanh")]
    z_re, z_im = x[:, re], x[:, im]
    norm = torch.sqrt(z_re * z_re + z_im * z_im + 1e-8)
    b = torch.cat([getattr(nl, n) for n in nl._bias_names])
    gate = torch.relu(norm + b[None, :, None, None])
    ref = torch.cat(parts + [gate * z_re / norm, gate * z_im / norm], dim=1)[:, order]
    with torch.set_grad_enabled(grad):
        assert torch.equal(nl(x), ref)


@pytest.mark.card
def test_so2_canonicalizer_eval_forward_makes_no_host_sync(card):
    """The serving build of `steerable.yaml` at the so2 cell's shapes
    (batch 256, 224 px, resize 64, fast warps, bf16): after a warm-up and a
    weight change, the canonicalizer's grad-off forward (3 misses, then 3
    hits) makes no host sync; the kept kernels and spectra give the
    network vectors a copy of the network assembling live gives, bit for
    bit, and the grad-on (direct) vectors within the spectral bar. The
    hidden and last layers take the spectral path through the contraction
    kernel, the bf16 first layer the direct one."""
    import copy

    from equiadapt_tpu_torch.cli import classification_serve as serve
    from equiadapt_tpu_torch.cli import classification_train as train
    from equiadapt_tpu_torch.ops.kernels import spectral_conv as sc

    cfg = train.compose(["canonicalization=steerable", "dataset.dataset_name=synthetic",
                         "dataset.image_size=224", "dataset.num_classes=10",
                         "prediction.architecture=resnet18"])
    canon = serve.build_serving_pipeline(cfg, card).canonicalizer.eval()
    net = canon.canonicalization_network
    x = torch.rand(256, 224, 224, 3, device=card,
                   generator=torch.Generator(card).manual_seed(0))
    seen = {}
    net.register_forward_hook(lambda _m, args, out: seen.update(x=args[0], v=out))
    deterministic, tf32 = torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32
    # fp32 convolutions in fp32, as the serving cell runs them: the grad-on
    # direct path is held to the spectral one within an fp32 bar
    torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = True, False
    try:
        with torch.no_grad():
            canon.canonicalize(x)  # builds the warp kernels
            for p in net.parameters():
                p.mul_(1.0)  # a weight change: the next call assembles
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                with _Counted() as first:
                    assembled, _ = canon.canonicalize(x)
                sc.reset_launches()
                before = counters()
                with _Counted() as second:
                    kept, _ = canon.canonicalize(x)
                after, launched = counters(), dict(sc.launches)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            kept_vectors = seen["v"]
            fresh_vectors = copy.deepcopy(net)(seen["x"])  # a copy keeps no kernel
        live_vectors = net(seen["x"]).detach()  # grad on: live assembly, direct
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = deterministic, tf32
    paths = {p: after.get(f"paths/steerable_conv/{p}", 0)
             - before.get(f"paths/steerable_conv/{p}", 0) for p in ("spectral", "direct")}
    assert (first.misses, first.hits, second.misses, second.hits) == (3, 0, 0, 3)
    assert paths == {"spectral": 2, "direct": 1}
    assert launched == {"spectral_contraction/float32": 2}
    assert torch.equal(assembled, kept)
    assert torch.equal(kept_vectors, fresh_vectors)
    _spectral_close(kept_vectors, live_vectors)


@pytest.mark.card
def test_a_reassigned_leaf_is_seen_on_the_card(card):
    """`p.data = ...` keeps the version counter, and the caching allocator
    hands a freed block straight back: the kept leaves' storages are held,
    so a new leaf cannot take the old address and pass for unchanged."""
    kw = dict(in_channels=3, out_channels=2, kernel_size=3, num_layers=1)
    gen = torch.Generator(card).manual_seed(0)
    net = tp.SteerableNetwork(**kw, device=card, generator=gen).eval()
    x = torch.randn(2, 12, 12, 3, device=card, generator=gen)
    with torch.no_grad():
        net(x)
        net(x)
    for p in net.parameters():
        value = 3.0 * p.detach()
        p.data = torch.empty(0, device=card)  # frees the old block
        p.data = value.clone()
    with _Counted() as counted, torch.no_grad():
        after = net(x)
    fresh = tp.SteerableNetwork(**kw, device=card).eval()
    fresh.load_state_dict(net.state_dict())
    with torch.no_grad():
        assert torch.equal(after, fresh(x))
    assert (counted.misses, counted.hits) == (2, 0)
