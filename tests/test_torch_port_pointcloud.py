"""The port's point-cloud path against the JAX package: vector-neuron
layers, VNSmall, the SO(3) / SE(3) canonicalizer, the Lie-group
representations, PointNet, DGCNN and the classification pipeline, with the
Flax variables carried across by `load_flax_variables`.

Both sides get the same numpy inputs, and every bias, BatchNorm scale and
running statistic is redrawn from a numpy seed, so a leaf carried to the
wrong place shows. The port's kNN graphs take K8's plain version; the JAX
side runs "exact" or "fused" (the Pallas kernel in interpret mode). Each
seed is checked for a kNN margin at every graph the path builds: the
k-th and (k+1)-th float64 squared distances lie more than 1e-5 apart
(relative), so an fp32 difference in a stage's input cannot change a
neighbour set. Bars (fp32): layer outputs, frames, canonical clouds and
group representations within 1e-5; logits within 1e-4 of the largest
logit; equivariance of every VN layer under a random SO(3) within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from equiadapt_tpu.common import info as jinfo
from equiadapt_tpu.common import lie as jlie
from equiadapt_tpu.models import pointnet as jpn
from equiadapt_tpu.pipelines import pointcloud as jpipe
from equiadapt_tpu.pointcloud import canonicalization as jcan
from equiadapt_tpu.pointcloud import networks as jnet
from equiadapt_tpu.pointcloud import vector_neurons as jvn
import equiadapt_tpu_torch as tp
from equiadapt_tpu_torch.common import lie as tlie
from equiadapt_tpu_torch.models import pointnet as tpn
from equiadapt_tpu_torch.ops.kernels import knn as tknn
from equiadapt_tpu_torch.pipelines import pointcloud as tpipe
from equiadapt_tpu_torch.pointcloud import networks as tnet
from equiadapt_tpu_torch.pointcloud import vector_neurons as tvn

from test_torch_port_knn import knn_margin
from torch_port_cpu import one_intra_op_thread  # noqa: F401

KEY = jax.random.key(0)
TOL = dict(rtol=1e-5, atol=1e-5)


def numpy_variables(variables, seed=0):
    """Flax variables as nested dicts of numpy arrays, with biases, BN
    scales and running statistics redrawn from `seed`."""
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        leaf = np.asarray(leaf)
        name = path[-1].key
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(leaf.dtype)
        if name in ("mean", "bias"):
            return (0.1 * rng.normal(size=leaf.shape)).astype(leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(redraw, jax.tree_util.tree_map(
        np.asarray, dict(variables)))


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rot(seed, b=2):
    """Random proper rotations (b, 3, 3) from numpy."""
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(b, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    return q.astype(np.float32)


def _rotate(x, Q):
    """Rotate every 3-vector of x (B, ..., 3, C): v -> v @ Q."""
    return torch.einsum("b...vc,bvw->b...wc", x, _t(Q))


def _carry(jmodule, tmodule, *args, seed=0, **kwargs):
    """Init the Flax module, redraw its variables, load them into the torch
    module: (variables, torch module in eval mode)."""
    variables = numpy_variables(jmodule.init(KEY, *args, **kwargs), seed)
    return variables, tp.load_flax_variables(tmodule, variables).eval()


@pytest.fixture
def knn_inputs(monkeypatch):
    """Records every point set the port hands to K8."""
    seen = []
    run = tknn.knn_indices

    def record(points, k):
        seen.append((points.numpy().copy(), k))
        return run(points, k)

    monkeypatch.setattr(tknn, "knn_indices", record)
    return seen


def assert_margins(seen, margin=1e-5):
    assert seen, "no kNN graph was built"
    for points, k in seen:
        assert knn_margin(points, k, order=False) > margin, "pick another seed"


VN_LAYERS = {
    "VNLinear": (lambda: jvn.VNLinear(out_channels=5),
                 lambda: tvn.VNLinear(4, 5, device="cpu")),
    "VNLeakyReLU": (lambda: jvn.VNLeakyReLU(),
                    lambda: tvn.VNLeakyReLU(4, device="cpu")),
    "VNLeakyReLU_shared": (lambda: jvn.VNLeakyReLU(share_nonlinearity=True),
                           lambda: tvn.VNLeakyReLU(4, True, device="cpu")),
    "VNSoftplus": (lambda: jvn.VNSoftplus(),
                   lambda: tvn.VNSoftplus(4, device="cpu")),
    "VNLinearLeakyReLU": (lambda: jvn.VNLinearLeakyReLU(out_channels=6),
                          lambda: tvn.VNLinearLeakyReLU(4, 6, device="cpu")),
    "VNLinearLeakyReLU_nobn": (
        lambda: jvn.VNLinearLeakyReLU(out_channels=6, use_batchnorm=False,
                                      share_nonlinearity=True),
        lambda: tvn.VNLinearLeakyReLU(4, 6, share_nonlinearity=True,
                                      use_batchnorm=False, device="cpu")),
    "VNBatchNorm": (lambda: jvn.VNBatchNorm(),
                    lambda: tvn.VNBatchNorm(4, device="cpu")),
}


@pytest.mark.parametrize("name", sorted(VN_LAYERS))
def test_vn_layer_matches_jax_and_is_equivariant(name):
    jctor, tctor = VN_LAYERS[name]
    x = _x((2, 16, 5, 3, 4), seed=1)  # (B, N, k, 3, C)
    variables, layer = _carry(jctor(), tctor(), jnp.asarray(x))
    ref = np.asarray(jctor().apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        ours = layer(_t(x))
        Q = _rot(2)
        rotated = layer(_rotate(_t(x), Q))
    np.testing.assert_allclose(ours.numpy(), ref, **TOL)
    np.testing.assert_allclose(rotated.numpy(), _rotate(ours, Q).numpy(), **TOL)


def test_vn_bilinear_maxpool_meanpool_match_jax():
    x = _x((2, 16, 3, 4), seed=3)
    labels = _x((2, 16, 6), seed=4)
    Q = _rot(5)
    variables, bil = _carry(jvn.VNBilinear(out_channels=5),
                            tvn.VNBilinear(4, 6, 5, device="cpu"),
                            jnp.asarray(x), jnp.asarray(labels))
    ref = jvn.VNBilinear(out_channels=5).apply(variables, jnp.asarray(x),
                                              jnp.asarray(labels))
    with torch.no_grad():
        ours = bil(_t(x), _t(labels))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
        np.testing.assert_allclose(bil(_rotate(_t(x), Q), _t(labels)).numpy(),
                                   _rotate(ours, Q).numpy(), **TOL)

        variables, pool = _carry(jvn.VNMaxPool(), tvn.VNMaxPool(4, device="cpu"),
                                 jnp.asarray(x))
        ref = jvn.VNMaxPool().apply(variables, jnp.asarray(x))
        ours = pool(_t(x))  # (B, 3, C)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
        np.testing.assert_allclose(
            pool(_rotate(_t(x), Q)).numpy(),
            torch.einsum("bvc,bvw->bwc", ours, _t(Q)).numpy(), **TOL)

    np.testing.assert_allclose(
        tvn.mean_pool(_t(x), axis=2, keepdims=True).numpy(),
        np.asarray(jvn.mean_pool(jnp.asarray(x), axis=2, keepdims=True)), **TOL)


@pytest.mark.parametrize("normalize_frame", [False, True])
def test_vn_std_feature_matches_jax(normalize_frame):
    x = _x((2, 16, 3, 8), seed=6)
    jmod = jvn.VNStdFeature(normalize_frame=normalize_frame)
    variables, std = _carry(jmod, tvn.VNStdFeature(
        8, normalize_frame=normalize_frame, device="cpu"), jnp.asarray(x))
    ref, ref_frame = jmod.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        ours, frame = std(_t(x))
        rotated, _ = std(_rotate(_t(x), _rot(7)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(frame.numpy(), np.asarray(ref_frame), **TOL)
    if normalize_frame:  # an orthonormal frame makes the features invariant
        np.testing.assert_allclose(rotated.numpy(), ours.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_graph_features_match_jax():
    x = _x((2, 40, 3, 2), seed=8)  # kNN on 6 flattened coordinates
    assert knn_margin(x.reshape(2, 40, 6), 5, order=False) > 1e-5
    ref = jnet.graph_feature_cross(jnp.asarray(x), 5)
    ours = tnet.graph_feature_cross(_t(x), 5)
    assert ours.shape == (2, 40, 5, 3, 6)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    idx = np.random.default_rng(9).integers(0, 40, (2, 40, 3)).astype(np.int32)
    np.testing.assert_allclose(
        tnet.graph_feature_cross(_t(x), 3, idx=_t(idx)).numpy(),
        np.asarray(jnet.graph_feature_cross(jnp.asarray(x), 3, idx=jnp.asarray(idx))),
        **TOL)

    h = _x((2, 40, 16), seed=10)
    assert knn_margin(h, 6, order=False) > 1e-5
    for knn_mode in ("exact", "fused"):
        ref = jpn.get_graph_feature(jnp.asarray(h), 6, knn_mode=knn_mode)
        ours = tpn.get_graph_feature(_t(h), 6, knn_mode=knn_mode)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("knn_mode", ["exact", "fused"])
@pytest.mark.parametrize("pooling", ["mean", "max"])
def test_vnsmall_matches_jax(pooling, knn_mode, knn_inputs):
    pts = _x((2, 64, 3), seed=11)
    jmod = jnet.VNSmall(n_knn=8, pooling=pooling, knn_mode=knn_mode)
    variables, net = _carry(jmod, tp.VNSmall(8, pooling, knn_mode, device="cpu"),
                            jnp.asarray(pts))
    ref = np.asarray(jmod.apply(variables, jnp.asarray(pts)))
    with torch.no_grad():
        ours = net(_t(pts))
        Q = _rot(12)
        rotated = net(torch.einsum("bnd,bdw->bnw", _t(pts), _t(Q)))
    assert_margins(knn_inputs)
    assert ours.shape == (2, 3, 3)
    np.testing.assert_allclose(ours.numpy(), ref, **TOL)
    np.testing.assert_allclose(
        rotated.numpy(), torch.einsum("bkd,bdw->bkw", ours, _t(Q)).numpy(),
        rtol=1e-4, atol=1e-4)


def _lie_params(seed, b=4, n=3, scale=0.5):
    rng = np.random.default_rng(seed)
    k = n * (n - 1) // 2
    return ((rng.normal(size=(b, k + n)) * scale).astype(np.float32),
            rng.uniform(size=(b, 1)).astype(np.float32))


def _expm64(params, n):
    """exp of the so(n) element in float64 (scipy): the ground truth."""
    A = np.einsum("bs,sij->bij", np.asarray(params, np.float64),
                  tlie.son_bases(n).astype(np.float64))
    return np.stack([scipy.linalg.expm(a) for a in A])


@pytest.mark.parametrize("n", [2, 3])
def test_lie_representations_match_jax(n):
    """Parity at rotation vectors of norm about 1; at the norms of
    `random_rotate` (N(0, 1) * pi, up to about 6) JAX's fp32 `expm` is off
    the float64 exponential by up to 4e-5, the port's by about 1e-6, so
    there the port is held to the float64 ground truth."""
    params, refl = _lie_params(13 + n, n=n)
    k = n * (n - 1) // 2
    np.testing.assert_array_equal(tlie.son_bases(n), jlie.son_bases(n))
    pairs = [
        (tlie.son_rep(_t(params[:, :k]), n), jlie.son_rep(jnp.asarray(params[:, :k]), n)),
        (tlie.on_rep(_t(params[:, :k]), _t(refl), n),
         jlie.on_rep(jnp.asarray(params[:, :k]), jnp.asarray(refl), n)),
        (tlie.sen_rep(_t(params), n), jlie.sen_rep(jnp.asarray(params), n)),
        (tlie.en_rep(_t(params), _t(refl), n),
         jlie.en_rep(jnp.asarray(params), jnp.asarray(refl), n)),
    ]
    for group in ("SOn", "SEn", "On", "En"):
        p = params if group in ("SEn", "En") else params[:, :k]
        ours = tlie.LieParameterization(group, n)
        assert ours.num_rot_params == k
        pairs.append((ours.get_group_rep(_t(p)),
                      jlie.LieParameterization(group, n).get_group_rep(jnp.asarray(p))))
    for ours, ref in pairs:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    rot = tlie.son_rep(_t(params[:, :k]), n)
    np.testing.assert_allclose((rot @ rot.transpose(1, 2)).numpy(),
                               np.broadcast_to(np.eye(n), rot.shape), atol=1e-5)
    with pytest.raises(ValueError):
        tlie.LieParameterization("SLn", n).get_group_rep(_t(params))
    wide, _ = _lie_params(15 + n, n=n, scale=np.pi)
    np.testing.assert_allclose(tlie.son_rep(_t(wide[:, :k]), n).numpy(),
                               _expm64(wide[:, :k], n), rtol=0, atol=1e-5)


@pytest.mark.parametrize("translation", [False, True])
def test_canonicalizer_matches_jax(translation, knn_inputs):
    pts = _x((2, 64, 3), seed=16) * np.array([1.0, 0.6, 0.3], np.float32)
    if translation:
        pts = pts + _x((2, 1, 3), seed=17)
    jmod = jcan.EquivariantPointcloudCanonicalization(
        canonicalization_network=jnet.VNSmall(n_knn=8, knn_mode="fused"),
        enable_translation=translation)
    tmod = tp.EquivariantPointcloudCanonicalization(
        tp.VNSmall(8, knn_mode="fused", device="cpu"), enable_translation=translation)
    variables, canon = _carry(jmod, tmod, jnp.asarray(pts), seed=1)
    jx, jinf = jmod.apply(variables, jnp.asarray(pts))
    with torch.no_grad():
        tx, tinf = canon.canonicalize(_t(pts))
    assert_margins(knn_inputs)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(tinf.element.rotation.numpy(),
                               np.asarray(jinf.element.rotation), **TOL)
    if translation:
        np.testing.assert_allclose(tinf.element.translation.numpy(),
                                   np.asarray(jinf.element.translation), **TOL)
        np.testing.assert_allclose(tx.mean(dim=1).numpy(), 0.0, atol=1e-5)
    else:
        assert tinf.element.translation is None
    assert tp.prior_regularization_loss(tinf).item() == pytest.approx(
        float(jinfo.prior_regularization_loss(jinf)), rel=1e-5)
    assert tp.identity_metric(tinf).item() == pytest.approx(
        float(jinfo.identity_metric(jinf)), rel=1e-5)

    back = canon.invert_canonicalization(tinf, tx)
    np.testing.assert_allclose(back.numpy(), pts, atol=1e-5)
    dirs = canon.invert_canonicalization(tinf, tx, points=False)
    np.testing.assert_allclose(
        dirs.numpy(),
        np.asarray(jmod.invert_canonicalization(jinf, jx, points=False)), **TOL)


def test_pointnet_matches_jax():
    pts = _x((2, 32, 3), seed=18)
    jmod = jpn.PointNet(num_classes=5, emb_dims=32)
    variables, net = _carry(jmod, tp.PointNet(5, 32, device="cpu"),
                            jnp.asarray(pts))
    ref = np.asarray(jmod.apply(variables, jnp.asarray(pts)))
    with torch.no_grad():
        ours = net(_t(pts)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("knn_mode", ["exact", "fused"])
def test_dgcnn_matches_jax(knn_mode, knn_inputs):
    pts = _x((2, 64, 3), seed=19)
    jmod = jpn.DGCNN(num_classes=10, k=8, emb_dims=64, knn_mode=knn_mode)
    variables, net = _carry(jmod, tp.DGCNN(10, 8, 64, knn_mode, device="cpu"),
                            jnp.asarray(pts), seed=2)
    ref = np.asarray(jmod.apply(variables, jnp.asarray(pts)))
    with torch.no_grad():
        ours = net(_t(pts)).numpy()
    assert [p.shape[-1] for p, _ in knn_inputs] == [3, 64, 64, 128]
    assert_margins(knn_inputs)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_pipeline_matches_jax(knn_inputs):
    """The slice at a small size: VNSmall (fused kNN) canonicalize ->
    DGCNN (fused kNN) -> logits, and the point-valued invert."""
    pts = _x((2, 128, 3), seed=20) * np.array([1.0, 0.6, 0.3], np.float32)
    jmod = jpipe.PointcloudClassificationPipeline(
        canonicalizer=jcan.EquivariantPointcloudCanonicalization(
            canonicalization_network=jnet.VNSmall(n_knn=8, knn_mode="fused")),
        prediction_network=jpn.DGCNN(num_classes=40, k=8, emb_dims=64,
                                     knn_mode="fused"))
    tmod = tp.PointcloudClassificationPipeline(
        tp.EquivariantPointcloudCanonicalization(
            tp.VNSmall(8, knn_mode="fused", device="cpu")),
        tp.DGCNN(40, 8, 64, knn_mode="fused", device="cpu"))
    variables, pipe = _carry(jmod, tmod, jnp.asarray(pts), seed=3)
    jlogits, jinf = jmod.apply(variables, jnp.asarray(pts))
    jlogits = np.asarray(jlogits)
    with torch.no_grad():
        logits, info = pipe(_t(pts))
    assert len(knn_inputs) == 5  # VNSmall's graph and DGCNN's four
    assert_margins(knn_inputs)
    assert logits.shape == (2, 40)
    np.testing.assert_allclose(info.element.rotation.numpy(),
                               np.asarray(jinf.element.rotation), **TOL)
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=0,
                               atol=1e-4 * np.abs(jlogits).max())
    assert np.array_equal(logits.argmax(-1).numpy(), jlogits.argmax(-1))


@pytest.mark.parametrize("mode", ["z", "so3", "none"])
def test_random_rotate_matches_jax(mode):
    """The same draws on both sides. For "so3" the rotation vectors are
    N(0, 1) * pi, where JAX's fp32 `expm` strays from the float64
    exponential by up to 4e-5 (test_lie_representations_match_jax): there
    the port is held to the float64 rotation within 1e-5 and to JAX
    within 1e-4."""
    pts = _x((3, 20, 3), seed=21)
    rng = jax.random.key(22)
    if mode == "z":
        draws = np.array(jax.random.uniform(rng, (3,)))
    else:
        draws = np.array(jax.random.normal(rng, (3, 3)))
    ref = np.asarray(jpipe.random_rotate(rng, jnp.asarray(pts), mode))
    ours = tpipe.random_rotate(_t(pts), mode, draws=_t(draws))
    if mode == "so3":
        truth = np.einsum("bnd,bdw->bnw", pts.astype(np.float64),
                          _expm64(draws * np.float32(np.pi), 3))
        np.testing.assert_allclose(ours.numpy(), truth, rtol=0, atol=1e-5)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-4)
    else:
        np.testing.assert_allclose(ours.numpy(), ref, **TOL)
    gen = torch.Generator().manual_seed(0)
    drawn = tpipe.random_rotate(_t(pts), mode, generator=gen)
    np.testing.assert_allclose(np.linalg.norm(drawn.numpy(), axis=-1),
                               np.linalg.norm(pts, axis=-1), rtol=1e-5)


def test_classification_metrics_match_jax():
    rng = np.random.default_rng(23)
    logits = rng.normal(size=(16, 5)).astype(np.float32)
    labels = rng.integers(0, 4, 16).astype(np.int32)
    ref = jpipe.classification_metrics(jnp.asarray(logits), jnp.asarray(labels), 5)
    ours = tpipe.classification_metrics(_t(logits), _t(labels), 5)
    assert sorted(ours) == sorted(ref)
    for key in ref:
        assert ours[key].item() == pytest.approx(float(ref[key]), rel=1e-6)


def test_training_and_targets_raise():
    """Training is ported and the module mode is not read: a module in
    either mode gives the eval output unless training=True is passed; in
    training, dropout above rate 0 needs a generator. Bad options still
    raise."""
    x = torch.randn(2, 16, 3)
    for module in (tp.VNSmall(8, device="cpu"), tp.DGCNN(4, 4, 16, device="cpu"),
                   tp.PointNet(4, 16, device="cpu")):
        module.train()
        y_train_mode = module(x)
        module.eval()
        torch.testing.assert_close(module(x), y_train_mode, rtol=0, atol=0)
        with pytest.raises(ValueError, match="generator"):
            module(x, training=True)
        out = module(x, training=True, generator=torch.Generator().manual_seed(0))
        assert torch.isfinite(out).all()
    canon = tp.EquivariantPointcloudCanonicalization(
        tp.VNSmall(8, dropout_rate=0.0, device="cpu"))
    xc, _ = canon.canonicalize(x)  # a fresh module is in train mode
    xt, _ = canon.canonicalize(x, training=True)
    assert xc.shape == xt.shape == x.shape
    bn = tvn.VNBatchNorm(2, device="cpu")
    assert bn(torch.ones(2, 3, 2), training=True).shape == (2, 3, 2)
    with pytest.raises(ValueError):
        tp.VNSmall(8, pooling="sum", device="cpu")
    with pytest.raises(ValueError):
        tp.VNSmall(8, knn_mode="sorted", device="cpu")


@pytest.mark.parametrize("fault", ["missing", "extra"])
def test_dgcnn_weights_raise_on_mismatch(fault):
    pts = jnp.zeros((1, 16, 3))
    variables = numpy_variables(jpn.DGCNN(num_classes=4, k=4, emb_dims=16).init(
        KEY, pts))
    params = variables["params"]
    if fault == "missing":
        del params["Dense_7"]
    else:
        params["Dense_8"] = params["Dense_7"]
    with pytest.raises(KeyError):
        tp.load_flax_variables(tp.DGCNN(4, 4, 16, device="cpu"), variables)
