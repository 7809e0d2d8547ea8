"""`utils/flops.py`, `utils/tuner.py` and `utils/profiling.py` against the
JAX package's.

`count_flops` (meta-device copies under `FlopCounterMode`): the closed
forms of tests/test_flops.py exactly; forward + backward within 1% of three
forwards; ResNet-50 at 224 px within 2% of 8.18 GFLOP an image; the port's
ResNet-18 / ResNet-50 forward within 0.5% of JAX `count_flops` of the Flax
modules; a pipeline's kernels count 0; the caller's modules are left as
they were; inside the count each kernel wrapper gives only its result's
shape on meta tensors and counts no launch. `lr_find`: the ramp against `optax.exponential_decay` (rel
1e-6), the learning rate each step ran at, and `_suggest` against JAX's on
the same curves. The profiler on a CPU trace: annotated names show.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import equiadapt_tpu_torch as tp
from equiadapt_tpu.models import resnet as jresnet
from equiadapt_tpu.utils import flops as jflops
from equiadapt_tpu.utils import tuner as jtuner
from equiadapt_tpu_torch.utils import flops as tflops
from equiadapt_tpu_torch.utils import profiling as tprof
from equiadapt_tpu_torch.utils import tuner as ttuner
from torch_port_cpu import one_intra_op_thread  # noqa: F401


def test_matmul_and_batched_matmul_closed_forms():
    a, b = torch.zeros(4, 8), torch.zeros(8, 16)
    assert tflops.count_flops(lambda x, y: x @ y, a, b) == 2 * 4 * 8 * 16
    a, b = torch.zeros(3, 4, 8), torch.zeros(3, 8, 16)
    assert tflops.count_flops(lambda x, y: torch.einsum("bij,bjk->bik", x, y),
                              a, b) == 3 * 2 * 4 * 8 * 16


def test_same_padded_and_grouped_conv_closed_forms():
    x, w = torch.zeros(2, 8, 32, 32), torch.zeros(16, 8, 3, 3)
    assert tflops.count_flops(lambda a, b: F.conv2d(a, b, padding=1), x, w) == (
        2 * 2 * 32 * 32 * 16 * 9 * 8)
    x, w = torch.zeros(1, 8, 16, 16), torch.zeros(8, 2, 3, 3)
    assert tflops.count_flops(lambda a, b: F.conv2d(a, b, padding=1, groups=4),
                              x, w) == 2 * 16 * 16 * 8 * 9 * 2


def test_grad_counts_forward_and_backward():
    a = torch.zeros(8, 8, requires_grad=True)
    b = torch.zeros(8, 8, requires_grad=True)
    fwd = tflops.count_flops(lambda x, y: (x @ y).sum(), a, b)

    def fwd_bwd(x, y):
        torch.autograd.grad((x @ y).sum(), (x, y))

    assert tflops.count_flops(fwd_bwd, a, b) == pytest.approx(3 * fwd, rel=0.01)


def test_resnet50_224_matches_the_published_count():
    net = tp.ResNet50(num_classes=1000, device="cpu")
    x = torch.zeros(2, 224, 224, 3)
    got = tflops.count_flops(lambda m, v: m(v), net, x)
    assert got == pytest.approx(tflops.resnet50_eval_flops(2), rel=0.02)
    assert tflops.resnet50_eval_flops(2, 112) == pytest.approx(8.18e9 / 2)


@pytest.mark.parametrize("arch,size,small", [("ResNet18", 32, True),
                                              ("ResNet50", 64, False)])
def test_resnet_forward_matches_jax_count(arch, size, small):
    jnet = getattr(jresnet, arch)(num_classes=10, small_images=small)
    xj = jnp.zeros((2, size, size, 3))
    shapes = jax.eval_shape(jnet.init, jax.random.key(0), xj)
    variables = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    ref = jflops.count_flops(lambda v, x: jnet.apply(v, x), variables, xj)
    net = getattr(tp, arch)(num_classes=10, small_images=small, device="cpu")
    got = tflops.count_flops(lambda m, v: m(v), net, torch.zeros(2, size, size, 3))
    assert got == pytest.approx(ref, rel=0.005)


def _tiny_pipeline(num_rotations=4):
    cfg = tp.Config().override(
        "canonicalization.network_hyperparams.out_channels=4",
        f"canonicalization.network_hyperparams.num_rotations={num_rotations}",
        "canonicalization.resize_shape=8", "prediction.architecture=resnet18")
    in_shape = (16, 16, 3)
    net = tp.get_image_canonicalization_network(cfg.canonicalization, in_shape,
                                                device="cpu")
    canon = tp.get_image_canonicalizer(cfg.canonicalization, net, in_shape, device="cpu")
    pred = tp.get_image_prediction_network(cfg.prediction, 10, True, device="cpu")
    return tp.ImageClassifierPipeline(canon, pred)


@pytest.mark.parametrize("num_rotations", [4, 8])
def test_pipeline_kernels_count_zero_and_state_is_left_alone(num_rotations):
    """The canonicalize -> predict forward counts the energy network and the
    ResNet and nothing for the select (its plain version on meta tensors);
    the training step's count leaves the weights and statistics alone."""
    pipe = _tiny_pipeline(num_rotations)
    x = torch.randn(4, 16, 16, 3)
    total = tflops.count_flops(lambda m, v: m(v), pipe, x)
    canon = pipe.canonicalizer
    energy = tflops.count_flops(
        lambda m, v: m.canonicalization_network(
            m.transformations_before_canonicalization_network_forward(v)), canon, x)
    resnet = tflops.count_flops(lambda m, v: m(v), pipe.prediction_network, x)
    assert energy > 0 and total == energy + resnet
    before = {k: v.clone() for k, v in pipe.state_dict().items()}

    def fwd_bwd(m, batch, gen):
        logits, info = m(batch["image"], training=True, generator=gen)
        loss, _ = tp.classification_loss(logits, batch["label"], info)
        torch.autograd.grad(loss, [p for p in m.parameters() if p.requires_grad])

    batch = {"image": x, "label": torch.tensor([0, 1, 2, 3])}
    step = tflops.count_flops(fwd_bwd, pipe, batch, torch.Generator().manual_seed(0))
    assert step == pytest.approx(3 * total, rel=0.1)
    assert all(torch.equal(before[k], v) for k, v in pipe.state_dict().items())
    assert all(p.grad is None and p.device.type == "cpu" for p in pipe.parameters())


@pytest.mark.parametrize("min_lr,max_lr,steps", [(1e-6, 1.0, 60), (1e-4, 0.3, 7)])
def test_ramp_matches_optax_exponential_decay(min_lr, max_lr, steps):
    ref = optax.exponential_decay(
        init_value=min_lr, transition_steps=1,
        decay_rate=(max_lr / min_lr) ** (1.0 / max(steps - 1, 1)))
    ramp = ttuner._ramp(min_lr, max_lr, steps)
    for i in range(steps):
        assert ramp(i) == pytest.approx(float(ref(i)), rel=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_suggest_matches_jax(seed):
    rng = np.random.default_rng(seed)
    lrs = np.geomspace(1e-6, 1.0, 40)
    losses = 2.0 - np.tanh(np.log10(lrs) + 3 + rng.normal(0, 0.3)) + rng.normal(0, 0.05, 40)
    if seed % 2:
        losses[30:] = np.geomspace(3, 300, 10)  # a divergence tail
    assert ttuner._suggest(lrs, losses) == jtuner._suggest(lrs, losses)


def test_lr_find_runs_each_step_on_the_ramp():
    model = torch.nn.Linear(3, 1)
    ramp = ttuner._ramp(1e-4, 0.1, 8)
    seen = []

    def make_step(state):
        def step(state, batch, generator):
            opt = state.optimizers[0]
            seen.append(opt.param_groups[0]["lr"])
            opt.zero_grad()
            loss = torch.mean((model(batch["x"]) - batch["y"]) ** 2)
            loss.backward()
            state.apply_gradients()
            return state, {"loss/total": loss.detach()}
        return step

    g = torch.Generator().manual_seed(0)
    x = torch.randn(16, 3, generator=g)
    batches = iter([{"x": x, "y": x.sum(1, keepdim=True)}] * 8)
    result = ttuner.lr_find(model, make_step, batches, min_lr=1e-4, max_lr=0.1,
                            num_steps=8)
    assert seen == pytest.approx([ramp(i) for i in range(8)], rel=1e-12)
    assert list(result.lrs) == pytest.approx(seen, rel=1e-12)
    assert len(result.losses) == 8 and result.suggestion in list(result.lrs)


def test_profile_trace_and_attribution_on_the_cpu(tmp_path):
    with tprof.profile_trace(str(tmp_path)):
        with tprof.annotate("canon/warp"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    with tprof.profile_trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()
    rows = tprof.device_op_attribution(str(tmp_path))
    names = [name for name, _ in rows]
    assert "canon/warp" in names and "aten::mm" in names
    assert all(ms >= 0 for _, ms in rows)
    assert rows == sorted(rows, key=lambda r: -r[1])
    with pytest.raises(FileNotFoundError):
        tprof.device_op_attribution(str(tmp_path / "none"))
    assert tprof.device_memory_stats() == {}


def _kernel_calls():
    from equiadapt_tpu_torch.ops.kernels import bilinear_warp as tbw
    from equiadapt_tpu_torch.ops.kernels import knn as tknn
    from equiadapt_tpu_torch.ops.kernels import orbit as torbit
    from equiadapt_tpu_torch.ops.kernels import select_warp as tsw
    from equiadapt_tpu_torch.ops.kernels import shear_rotate as tsr

    def idx(dev):
        return torch.tensor([1, 3], dtype=torch.int32, device=dev)

    return {
        "K1": (tsw, lambda d: tsw.select_planes(
            [torch.ones(2, 3, 8, 8, device=d)] * 2, idx(d) % 2, idx(d))),
        "K2": (tsw, lambda d: tsw.select_planes_rolled(
            [torch.ones(2, 8, 8, 8, device=d)], idx(d) * 0, idx(d), idx(d), 4, 4)),
        "K3": (tsw, lambda d: tsw.select_planes_nhwc(
            [torch.ones(2, 8, 8, 3, device=d)], idx(d) * 0, idx(d))),
        "K4": (torbit, lambda d: torbit.rot90_flip_orbit(
            torch.ones(2, 8, 8, 3, device=d), 4, reflections=True)),
        "K5": (tsr, lambda d: tsr.rot90_centered_select(
            torch.ones(2, 8, 8, 3, device=d), idx(d), 4, 4)),
        "K6": (tsr, lambda d: tsr.shear_rotate_residual(
            torch.ones(2, 8, 8, 3, device=d), torch.full((2,), 0.3, device=d), 4.0, 4.0)),
        "K7": (tbw, lambda d: tbw.warp_rotate_center_exact(
            torch.ones(2, 8, 8, 3, device=d), torch.eye(2, device=d).expand(2, 2, 2))),
        "K8": (tknn, lambda d: tknn.knn_indices(torch.ones(2, 6, 3, device=d), 4)),
    }


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8"])
def test_wrappers_give_shapes_only_inside_a_count(kernel):
    """Inside `shapes_only` (a FLOP count) a wrapper given meta tensors
    returns an empty result of its plain version's shape and dtype and
    counts no launch; outside it, meta tensors raise."""
    from equiadapt_tpu_torch.ops.kernels import _build

    mod, call = _kernel_calls()[kernel]
    ref = call("cpu")
    before = dict(mod.launches)
    with _build.shapes_only():
        out = call("meta")
    assert out.device.type == "meta"
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert mod.launches == before
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        call("meta")
