"""The port's first slice end to end against the JAX package, and the
port's boundaries.

Slice: C8 / D8 `GroupEquivariantImageCanonicalization` -> `ResNet50` ->
`invert_canonicalization` of a regular-rep map, Flax weights carried
across. The JAX side runs on the CPU, where it takes its blend / roll
formulations (held bit-equal to its Pallas kernels by the JAX tests); the
port takes the plain versions of K1 / K2 on CPU tensors. Bars (fp32):
identical elements (each seed is checked for a top-2 margin > 1e-3 first),
canonical images within 1e-5, logits within 1e-4 of the largest logit,
inverted maps within 1e-5, equal prior loss and identity metric.
"""

import ast
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equiadapt_tpu.common import info as jinfo
from equiadapt_tpu.images import (
    EquivariantNetwork as JNet,
    GroupEquivariantImageCanonicalization as JCanon,
)
from equiadapt_tpu.models import ResNet50 as JResNet50
import equiadapt_tpu_torch as tp
from equiadapt_tpu_torch.ops.warp import group_angles
from torch_port_cpu import one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]

# (group_type, preset) -> (init key, input seed) with clear argmax margins
CASES = {
    ("rotation", "exact"): (3, 0),
    ("rotation", "serving"): (0, 0),
    ("roto-reflection", "exact"): (0, 0),
}


def _canon_kwargs(group_type, preset):
    net = dict(in_channels=3, out_channels=8, kernel_size=3,
               group_type=group_type, num_rotations=8, num_layers=2,
               fused_pool_lift=preset == "serving")
    canon = dict(in_shape=(32, 32, 3), resize_shape=16, num_rotations=8,
                 group_type=group_type,
                 input_crop_ratio=0.9 if preset == "exact" else 1.0,
                 warp_mode="exact" if preset == "exact" else "fast",
                 output_dtype=None if preset == "exact" else "compute")
    return net, canon


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


@functools.lru_cache(maxsize=None)
def _resnet():
    jnet = JResNet50(num_classes=10)
    variables = _numpy(jnet.init(jax.random.key(9), jnp.zeros((1, 32, 32, 3))))
    tnet = tp.load_flax_variables(tp.ResNet50(num_classes=10, device="cpu"),
                                  variables).eval()
    return jnet, variables, tnet


@pytest.mark.parametrize("group_type,preset", sorted(CASES))
def test_slice_matches_jax(group_type, preset):
    key, seed = CASES[(group_type, preset)]
    net_kw, canon_kw = _canon_kwargs(group_type, preset)
    jcanon = JCanon(canonicalization_network=JNet(**net_kw), **canon_kw)
    rng = np.random.default_rng(seed)
    x = (4.0 * rng.normal(size=(8, 32, 32, 3))).astype(np.float32)
    G = 16 if group_type == "roto-reflection" else 8
    y = rng.normal(size=(8, 32, 32, 2 * G)).astype(np.float32)
    variables = _numpy(jcanon.init(jax.random.key(key), jnp.zeros((2, 32, 32, 3))))

    jx, jinf = jcanon.apply(variables, jnp.asarray(x))
    jy = jcanon.apply(variables, jinf, jnp.asarray(y),
                      method=JCanon.invert_canonicalization)
    jres, rvars, tres = _resnet()
    jlogits = np.asarray(jres.apply(rvars, jx))

    tcanon = tp.GroupEquivariantImageCanonicalization(
        tp.EquivariantNetwork(**net_kw, device="cpu"), **canon_kw)
    tp.load_flax_variables(tcanon, variables).eval()
    with torch.no_grad():
        tx, tinf = tcanon.canonicalize(torch.from_numpy(x))
        ty = tcanon.invert_canonicalization(tinf, torch.from_numpy(y))
        tlogits = tres(tx).numpy()

    acts = np.asarray(jinf.group_activations)
    top2 = np.sort(acts, axis=-1)[:, -2:]
    assert np.all(top2[:, 1] - top2[:, 0] > 1e-3), "seed without clear margins"
    np.testing.assert_allclose(tinf.group_activations.numpy(), acts, rtol=0, atol=1e-5)
    assert np.array_equal(tinf.onehot.numpy().argmax(-1), acts.argmax(-1))
    assert np.array_equal(tinf.element.rotation_deg.numpy(),
                          np.asarray(jinf.element.rotation_deg))
    if group_type == "roto-reflection":
        assert np.array_equal(tinf.element.reflection.numpy(),
                              np.asarray(jinf.element.reflection))
    assert tx.shape == jx.shape and tx.dtype == torch.float32
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tlogits, jlogits, rtol=0,
                               atol=1e-4 * np.abs(jlogits).max())
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    assert tp.prior_regularization_loss(tinf).item() == pytest.approx(
        float(jinfo.prior_regularization_loss(jinf)), rel=1e-6)
    assert tp.identity_metric(tinf).item() == float(jinfo.identity_metric(jinf))


def test_bf16_serving_path_runs_on_cpu():
    """The serving preset's reduced-precision path (bf16 energy, warp,
    ResNet and invert) runs end to end; values are checked on the card."""
    net_kw, canon_kw = _canon_kwargs("rotation", "serving")
    torch.manual_seed(0)
    canon = tp.GroupEquivariantImageCanonicalization(
        tp.EquivariantNetwork(**net_kw, device="cpu"),
        **dict(canon_kw, compute_dtype=torch.bfloat16)).eval()
    resnet = tp.ResNet50(num_classes=10, dtype=torch.bfloat16, device="cpu").eval()
    x = torch.randn(4, 32, 32, 3)
    y = torch.randn(4, 32, 32, 16, dtype=torch.bfloat16)
    with torch.no_grad():
        xc, info = canon.canonicalize(x)
        logits = resnet(xc)
        yi = canon.invert_canonicalization(info, y)
    assert xc.dtype == logits.dtype == yi.dtype == torch.bfloat16
    assert info.group_activations.dtype == torch.float32
    assert logits.shape == (4, 10) and yi.shape == y.shape
    assert torch.isfinite(logits.float()).all() and torch.isfinite(yi.float()).all()


def test_training_and_targets_raise():
    """Training is ported (the module mode is not read); co-canonicalized
    targets are ported too (`(x, targets, info)`), and targets without boxes
    and masks raise."""
    net_kw, canon_kw = _canon_kwargs("rotation", "exact")
    canon = tp.GroupEquivariantImageCanonicalization(
        tp.EquivariantNetwork(**dict(net_kw, dropout_rate=0.0), device="cpu"),
        **canon_kw)
    x = torch.zeros(2, 32, 32, 3)
    xc, _ = canon.canonicalize(x)  # a fresh module is in train mode
    xt, _ = canon.canonicalize(x, training=True)
    assert xc.shape == xt.shape == x.shape
    targets = {"boxes": torch.zeros(2, 3, 4), "masks": torch.zeros(2, 3, 32, 32)}
    xc2, tc, _ = canon.canonicalize(x, targets)
    assert torch.equal(xc2, xc) and tc["masks"].shape == (2, 3, 32, 32)
    with pytest.raises(KeyError):
        canon.canonicalize(x, targets={"boxes": None})


def test_no_silent_cpu():
    """Without an explicit device the port builds on the card; where there
    is none it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        tp.EquivariantNetwork(3, 8, 3, num_rotations=8)
    with pytest.raises((RuntimeError, AssertionError)):
        tp.ResNet50(num_classes=10)
    with pytest.raises((RuntimeError, AssertionError)):
        group_angles(8)
    for build in (tp.VNSmall, tp.DGCNN, tp.PointNet, lambda: tp.VNLinear(3, 4)):
        with pytest.raises((RuntimeError, AssertionError)):
            build()
    with pytest.raises((RuntimeError, AssertionError)):
        tp.ConvNetwork(3, 8, 5, input_size=96)
    with pytest.raises((RuntimeError, AssertionError)):
        tp.OptimizedGroupEquivariantImageCanonicalization(
            torch.nn.Identity(), in_shape=(96, 96, 3))
    with pytest.raises((RuntimeError, AssertionError)):
        tp.rot90_flip_orbit(torch.zeros(1, 4, 4, 3, device="cuda"))


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "equiadapt_tpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax():
    files = sorted((REPO / "equiadapt_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    covered = {str(f.relative_to(REPO)) for f in files}
    for module in ("common/math.py", "ops/kernels/shear_rotate.py",
                   "ops/kernels/bilinear_warp.py", "images/networks/steerable.py",
                   "images/canonicalization/continuous_group.py",
                   "common/lie.py", "ops/kernels/knn.py",
                   "pointcloud/vector_neurons.py", "pointcloud/networks.py",
                   "pointcloud/canonicalization.py", "models/pointnet.py",
                   "pipelines/pointcloud.py", "ops/kernels/orbit.py",
                   "images/networks/conv.py", "pipelines/classification.py",
                   "utils/config.py", "utils/registry.py", "common/layers.py",
                   "ops/kernels/select_warp.py", "ops/group_action.py",
                   "models/resnet.py", "utils/jax_weights.py",
                   "data/synthetic.py", "data/images.py", "data/autoaugment.py",
                   "utils/flops.py", "utils/profiling.py", "utils/tuner.py",
                   "cli/classification_train.py", "cli/classification_serve.py",
                   "data/pointcloud.py", "cli/pointcloud_train.py",
                   "cli/partseg_train.py", "parallel/__init__.py",
                   "parallel/mesh.py", "parallel/fsdp.py", "parallel/tp.py",
                   "parallel/pp.py", "parallel/group_parallel.py",
                   "parallel/launch.py"):
        assert f"equiadapt_tpu_torch/{module}" in covered, module
    bad = [
        (str(f.relative_to(REPO)), name)
        for f in files for name in _imports(f)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert bad == []
