"""`torch.export` artifacts (`utils/export.py`) on the CPU.

Counterpart of tests/test_export.py. An artifact must be self-contained
(weights baked in), reload through `load_exported` (in a fresh process that
imports only `equiadapt_tpu_torch` and torch too) and reproduce the live
call; a symbolic batch serves sizes 1, 3 and 8; the fast mode composes; the
point-cloud canonicalizer exports; the port's artifact answers as the JAX
package's StableHLO artifact does on the same batch (fp32: within 1e-5 of
the largest logit, the selected elements equal).

The hand kernels stay in an artifact: with the wrappers routed to their
CUDA branch (`_build.route` stubbed, the launches replaced by their plain
versions, counted) the exported graph holds the `torch.ops.eqt.*` nodes
and a call of the loaded artifact launches each once. Each registered
operator's fake implementation gives its plain version's output shape and
dtype at the shapes the paths use (meta tensors, no card).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import equiadapt_tpu_torch as tp
from equiadapt_tpu.images import EquivariantNetwork as JNet
from equiadapt_tpu.images import GroupEquivariantImageCanonicalization as JCanon
from equiadapt_tpu.models import ResNet18 as JResNet18
from equiadapt_tpu.utils.export import export_apply as jax_export_apply
from equiadapt_tpu.utils.export import load_exported as jax_load_exported
from equiadapt_tpu_torch.ops.kernels import _build
from equiadapt_tpu_torch.ops.kernels import bilinear_warp as tbw
from equiadapt_tpu_torch.ops.kernels import bn_act as tba
from equiadapt_tpu_torch.ops.kernels import knn as tknn
from equiadapt_tpu_torch.ops.kernels import nms as tnms
from equiadapt_tpu_torch.ops.kernels import orbit as torbit
from equiadapt_tpu_torch.ops.kernels import roi_align as tra
from equiadapt_tpu_torch.ops.kernels import sam_attention as tsa
from equiadapt_tpu_torch.ops.kernels import spectral_conv as tsc
from equiadapt_tpu_torch.ops.kernels import select_warp as tsw
from equiadapt_tpu_torch.ops.kernels import shear_rotate as tsr
from equiadapt_tpu_torch.utils.export import (
    export_apply,
    export_sharded_apply,
    load_exported,
)
from torch_port_cpu import one_intra_op_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-6)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def random_variables(module, *args, seed=0):
    """Flax variables drawn from `seed` at `jax.eval_shape`'s shapes:
    kernels N(0, 1 / fan_in), biases and means 0.1 N(0, 1), scales and
    variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.key(0), *args)

    def draw(path, s):
        name = path[-1].key
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, s.shape).astype(s.dtype)
        if name in ("mean", "bias"):
            return (0.1 * rng.normal(size=s.shape)).astype(s.dtype)
        fan_in = int(np.prod(s.shape[:-1])) if name == "kernel" else 1
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def _port_pipeline(warp_mode="exact", seed=0):
    torch.manual_seed(seed)
    canon = tp.GroupEquivariantImageCanonicalization(
        tp.EquivariantNetwork(3, 4, 3, "rotation", 4, 2, device="cpu"),
        (16, 16, 3), num_rotations=4, group_type="rotation", warp_mode=warp_mode)
    model = tp.ResNet18(num_classes=5, small_images=True, device="cpu")
    return torch.nn.ModuleList([canon, model]).eval()


def _apply(mods, batch):
    x_c, info = mods[0].canonicalize(batch)
    return mods[1](x_c), info.element.rotation_deg


def _x(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


def test_export_roundtrip_matches_live_apply():
    mods = _port_pipeline()
    x = _x((2, 16, 16, 3), 0)
    blob = export_apply(_apply, mods, x)
    assert isinstance(blob, bytes) and len(blob) > 1000
    logits, deg = load_exported(blob)(x)
    with torch.no_grad():
        ref_logits, ref_deg = _apply(mods, x)
    np.testing.assert_allclose(logits.numpy(), ref_logits.numpy(), **TOL)
    assert torch.equal(deg, ref_deg)


def test_port_artifact_answers_as_the_jax_artifact():
    """The same weights and batch through the JAX StableHLO artifact
    (platforms=("cpu",)) and the port's torch.export artifact."""
    net = JNet(in_channels=3, out_channels=4, kernel_size=3, group_type="rotation",
               num_rotations=4, num_layers=2)
    jcanon = JCanon(canonicalization_network=net, in_shape=(16, 16, 3),
                    num_rotations=4, group_type="rotation")
    jmodel = JResNet18(num_classes=5, small_images=True)
    x = np.random.default_rng(1).normal(size=(4, 16, 16, 3)).astype(np.float32)
    variables = {"canon": random_variables(jcanon, jnp.asarray(x), seed=2),
                 "model": random_variables(jmodel, jnp.asarray(x), seed=3)}

    def japply(v, batch):
        x_c, info = jcanon.apply(v["canon"], batch, training=False)
        return jmodel.apply(v["model"], x_c, training=False), info.element.rotation_deg

    jlogits, jdeg = jax_load_exported(
        jax_export_apply(japply, variables, jnp.asarray(x), platforms=("cpu",)))(
        jnp.asarray(x))
    mods = _port_pipeline()
    tp.load_flax_variables(mods[0], variables["canon"])
    tp.load_flax_variables(mods[1], variables["model"])
    with torch.no_grad():
        acts = mods[0].canonicalize(torch.from_numpy(x))[1].group_activations
    top2 = acts.sort(dim=-1).values[:, -2:]
    assert bool((top2[:, 1] - top2[:, 0] > 1e-3).all()), "seed without clear margins"
    logits, deg = load_exported(export_apply(_apply, mods, torch.from_numpy(x)))(
        torch.from_numpy(x))
    np.testing.assert_array_equal(deg.numpy(), np.asarray(jdeg))
    ref = np.asarray(jlogits)
    assert np.abs(logits.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_export_symbolic_batch_serves_any_batch_size():
    mods = _port_pipeline()
    fn = load_exported(export_apply(lambda m, b: _apply(m, b)[0], mods,
                                    _x((2, 16, 16, 3), 0), symbolic_batch=True))
    for bs in (1, 3, 8):
        xb = _x((bs, 16, 16, 3), bs)
        out = fn(xb)
        assert out.shape == (bs, 5)
        with torch.no_grad():
            np.testing.assert_allclose(out.numpy(), _apply(mods, xb)[0].numpy(), **TOL)


def test_export_symbolic_batch_composes_with_fast_mode():
    """The fast warp and the regular-rep invert (C = 8 fibres over |G| = 4)
    in one symbolic-batch artifact."""
    canon = _port_pipeline("fast")[0]

    def apply_fn(c, batch):
        x_c, info = c.canonicalize(batch)
        feats = torch.cat([x_c, x_c, x_c[..., :2]], dim=-1)
        return x_c, c.invert_canonicalization(info, feats, induced_rep_type="regular")

    fn = load_exported(export_apply(apply_fn, canon, _x((2, 16, 16, 3), 0),
                                    symbolic_batch=True))
    for bs in (2, 5):
        xb = _x((bs, 16, 16, 3), 10 + bs)
        x_c, inv = fn(xb)
        assert x_c.shape == (bs, 16, 16, 3) and inv.shape == (bs, 16, 16, 8)
        with torch.no_grad():
            ref_c, ref_i = apply_fn(canon, xb)
        np.testing.assert_allclose(x_c.numpy(), ref_c.numpy(), **TOL)
        np.testing.assert_allclose(inv.numpy(), ref_i.numpy(), **TOL)


def _pointcloud():
    torch.manual_seed(4)
    canon = tp.EquivariantPointcloudCanonicalization(
        tp.VNSmall(6, "mean", knn_mode="fused", device="cpu")).eval()
    pts = _x((2, 64, 3), 2) * torch.tensor([1.0, 0.6, 0.3])
    return canon, pts, lambda c, b: c.canonicalize(b)[0]


def test_export_pointcloud_canonicalizer_roundtrip():
    canon, pts, apply_fn = _pointcloud()
    fn = load_exported(export_apply(apply_fn, canon, pts))
    with torch.no_grad():
        np.testing.assert_allclose(fn(pts).numpy(), apply_fn(canon, pts).numpy(), **TOL)


def test_artifact_loads_in_a_fresh_process(tmp_path):
    """The bytes alone, in a process that imports only torch and
    equiadapt_tpu_torch, answer as the live call."""
    mods = _port_pipeline()
    x = _x((3, 16, 16, 3), 7)
    (tmp_path / "model.pt2").write_bytes(
        bytes(bytearray(export_apply(lambda m, b: _apply(m, b)[0], mods, x,
                                     symbolic_batch=True))))
    torch.save(x, tmp_path / "x.pt")
    code = (
        "import sys, torch, equiadapt_tpu_torch\n"
        "from equiadapt_tpu_torch.utils.export import load_exported\n"
        "fn = load_exported(open(sys.argv[1], 'rb').read())\n"
        "torch.save(fn(torch.load(sys.argv[2])), sys.argv[3])\n"
        "assert 'jax' not in sys.modules and 'equiadapt_tpu' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, "-c", code, str(tmp_path / "model.pt2"),
                    str(tmp_path / "x.pt"), str(tmp_path / "y.pt")],
                   check=True, env=env, cwd=tmp_path, timeout=300)
    with torch.no_grad():
        ref = _apply(mods, x)[0]
    np.testing.assert_allclose(torch.load(tmp_path / "y.pt").numpy(), ref.numpy(), **TOL)


def test_scalar_leaf_and_sharded_export_raise():
    """A scalar leaf under `symbolic_batch` raises. `export_sharded_apply`
    is ported (item 16): in a single process (mesh None, a world of one
    rank) its artifact answers as `export_apply`'s, and an artifact written
    for another world size is refused (worlds of several ranks:
    tests/test_torch_port_parallel.py)."""
    mods = _port_pipeline()
    with pytest.raises(ValueError, match="scalar leaf"):
        export_apply(lambda m, b: _apply(m, b["x"])[0], mods,
                     {"x": _x((2, 16, 16, 3), 0), "t": torch.tensor(1.0)},
                     symbolic_batch=True)
    x = _x((2, 16, 16, 3), 0)
    blob = export_sharded_apply(_apply, mods, x, mesh=None)
    got, ref = load_exported(blob)(x), load_exported(export_apply(_apply, mods, x))(x)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    with pytest.raises(ValueError, match="exported for 2 ranks"):
        load_exported(blob.replace(b'"world": 1', b'"world": 2', 1))


# ------------------------------------------- the kernels stay in the graph


@pytest.fixture
def cuda_route(monkeypatch):
    """Every wrapper takes its CUDA branch; each launch is its plain version,
    counted by operator."""
    counts = {}

    def plain(op, fn):
        def launch(*args):
            counts[op] = counts.get(op, 0) + 1
            return fn(*args)
        return launch

    monkeypatch.setattr(_build, "route", lambda tensors, kernels: "cuda")
    monkeypatch.setattr(tsw, "_launch", plain("select_warp", lambda name, s, src, k, sh, rf, G, n: (
        tsw.select_planes_nhwc_plain(s, src, k) if name == "select_planes_nhwc"
        else tsw.select_planes_plain(s, src, k, sh, rf, G, n))))
    monkeypatch.setattr(tknn, "_launch", plain("knn_indices", tknn.knn_indices_plain))
    return counts


def _eqt_nodes(blob):
    program = torch.export.load(__import__("io").BytesIO(blob))
    return sorted(str(n.target) for n in program.graph.nodes
                  if str(n.target).startswith("eqt."))


@pytest.mark.parametrize("symbolic", [False, True])
def test_serving_artifact_holds_the_select_kernel(cuda_route, symbolic):
    """The bf16 serving preset's canonicalize (fast warp, NHWC batch: K3 with
    two sources) exported on the CUDA route: one eqt.select_warp node, one
    launch a call of the loaded artifact, the live call's output."""
    torch.manual_seed(5)
    canon = tp.GroupEquivariantImageCanonicalization(
        tp.EquivariantNetwork(3, 4, 3, "rotation", 8, 1, fused_pool_lift=True,
                              device="cpu"),
        (16, 16, 3), num_rotations=8, group_type="rotation", warp_mode="fast",
        compute_dtype=torch.bfloat16).eval()
    x = _x((2, 16, 16, 3), 6)
    apply_fn = lambda c, b: c.canonicalize(b)[0]
    blob = export_apply(apply_fn, canon, x, symbolic_batch=symbolic)
    assert cuda_route == {}  # tracing launches nothing
    assert _eqt_nodes(blob) == ["eqt.select_warp.default"]
    fn = load_exported(blob)
    xb = _x((3 if symbolic else 2, 16, 16, 3), 7)
    out = fn(xb)
    assert cuda_route == {"select_warp": 1}
    with torch.no_grad():
        assert torch.equal(out, apply_fn(canon, xb))


def test_pointcloud_artifact_holds_the_knn_kernel(cuda_route):
    canon, pts, apply_fn = _pointcloud()
    blob = export_apply(apply_fn, canon, pts)
    assert _eqt_nodes(blob) == ["eqt.knn_indices.default"]
    out = load_exported(blob)(pts)
    assert cuda_route == {"knn_indices": 1}
    with torch.no_grad():
        np.testing.assert_allclose(out.numpy(), apply_fn(canon, pts).numpy(), **TOL)


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _shape_cases(dtype):
    """(operator, its arguments, the plain version's output) at the paths'
    shapes, batch cut to 2."""
    g = torch.Generator().manual_seed(0)
    idx = torch.tensor([1, 3], dtype=torch.int32)
    zero = torch.zeros(2, dtype=torch.int32)
    nchw = [torch.randn(2, 3, 224, 224, generator=g).to(dtype) for _ in range(2)]
    nhwc = [torch.randn(2, 224, 224, 3, generator=g).to(dtype) for _ in range(2)]
    feat = [torch.randn(2, 16, 224, 224, generator=g).to(dtype)]
    img16 = torch.randn(2, 224, 224, 16, generator=g).to(dtype)
    R = torch.tensor([[[0.8, -0.6], [0.6, 0.8]], [[1.0, 0.0], [0.0, 1.0]]])
    r = torch.tensor([0.3, -0.5])
    pts = torch.randn(2, 1024, 3, generator=g).to(dtype)
    qkv = torch.randn(2, 196, 3, 12, 64, generator=g).to(dtype)
    rel_h, rel_w = (torch.randn(2, 12, 196, 14, generator=g).to(dtype) for _ in range(2))
    # the spectral contraction takes complex64 whatever the dtype (so2's hidden layer)
    x_hat = torch.randn(2, 80, 56, 29, dtype=torch.complex64, generator=g)
    k_hat = torch.randn(80, 80, 56, 29, dtype=torch.complex64, generator=g)
    # Mask R-CNN's RoIAlign over two levels and its NMS (fp32 boxes whatever the dtype)
    maps = [torch.randn(2, 8, 32, 32, generator=g).to(dtype),
            torch.randn(2, 8, 16, 16, generator=g).to(dtype)]
    rois = torch.tensor([[1.0, 2.0, 30.0, 20.0], [4.0, 4.0, 90.0, 100.0]])
    ri = torch.tensor([0, 1], dtype=torch.int32)
    sboxes = torch.rand(3, 40, 4, generator=g).cumsum(-1) * 10.0
    counts = torch.tensor([40, 7, 0], dtype=torch.int32)
    # a ResNet's BatchNorm-residual-ReLU (channels-last; fp32 BatchNorm parameters)
    act, res = (torch.randn(2, 64, 56, 56, generator=g).to(dtype)
                .contiguous(memory_format=torch.channels_last) for _ in range(2))
    bn = [torch.rand(64, generator=g) + 0.5 for _ in range(4)]
    return [
        (tsw._select_op, ("select_planes", nchw, zero, idx, None, None, 1, 1),
         tsw.select_planes_plain(nchw, zero, idx)),
        (tsw._select_op, ("select_planes_nhwc", nhwc, idx % 2, idx, None, None, 1, 1),
         tsw.select_planes_nhwc_plain(nhwc, idx % 2, idx)),
        (tsw._select_op, ("select_planes_rolled", feat, zero, idx, idx, None, 4, 4),
         tsw.select_planes_plain(feat, zero, idx, idx, None, 4, 4)),
        (torbit._orbit_op, (nhwc[0], [0, 3, 2, 1], [False] * 4),
         torbit.rot90_flip_orbit_plain(nhwc[0], 4)),
        (tsr._select_op, (img16, idx, 112, 112, "border"),
         tsr.rot90_centered_select_plain(img16, idx, 112, 112, "border")),
        (tsr._shear_op, (img16, r, 112.0, 112.0, "zeros"),
         tsr.shear_rotate_residual_plain(img16, r, 112.0, 112.0, "zeros")),
        (tbw._warp_op, (img16, R, "border"), tbw._warp_center_affine(img16, R, "border")),
        (tknn._knn_op, (pts, 20), tknn.knn_indices_plain(pts, 20)),
        (tsa._attention_op, (*qkv.unbind(2), rel_h, rel_w, 14, 14),
         tsa.sam_attention_plain(*qkv.unbind(2), rel_h, rel_w, 14, 14)),
        (tsc._contraction_op, (x_hat, k_hat), tsc.spectral_contraction_plain(x_hat, k_hat)),
        (tra._roi_align_op, (maps, rois, ri, ri, [0.25, 0.125], 7, 2),
         tra.roi_align_plain(maps, rois, ri, ri, [0.25, 0.125], 7, 2)),
        (tnms._nms_op, (sboxes, counts, 0.5), tnms.nms_keep_plain(sboxes, counts, 0.5)),
        (tba._bn_act_op, (act, bn, 1e-5, res, bn, 1e-5), tba._plain(act, bn, 1e-5, res, bn, 1e-5)),
    ]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_kernel_operator_has_a_fake_of_its_plain_shape(dtype):
    cases = _shape_cases(dtype)
    ops = {str(op) for op, _, _ in cases}
    # K1-K3 share one operator; K4-K8, SAM's attention, the spectral contraction,
    # Mask R-CNN's RoIAlign and NMS, the BatchNorm-residual-ReLU
    assert len(ops) == 11
    for op, args, plain in cases:
        meta_args = [[_meta(t) for t in a] if isinstance(a, list) and a
                     and isinstance(a[0], torch.Tensor)
                     else _meta(a) if isinstance(a, torch.Tensor) else a for a in args]
        out = op(*meta_args)
        assert out.device.type == "meta"
        assert out.shape == plain.shape and out.dtype == plain.dtype, (op, out, plain.shape)
    registered = {name for name in dir(torch.ops.eqt)
                  if isinstance(getattr(torch.ops.eqt, name), torch._ops.OpOverloadPacket)}
    assert registered == {"select_warp", "rot90_flip_orbit", "rot90_centered_select",
                          "shear_rotate_residual", "warp_rotate_center_exact",
                          "knn_indices", "sam_attention", "spectral_contraction",
                          "roi_align", "nms_keep", "bn_act"}
