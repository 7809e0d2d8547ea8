"""Port `ops/warp`, `common/` and `ops/group_action` against the JAX package.

Same numpy inputs through both. Tolerances: 1e-5 absolute in fp32 for
interpolating warps (float32 sums in another order), bit-identity for pure
permutations (multiples of 90 degrees, crops, flips, rolls).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equiadapt_tpu.common import info as jinfo
from equiadapt_tpu.common import selector as jsel
from equiadapt_tpu.ops import group_action as jga
from equiadapt_tpu.ops import warp as jw
from equiadapt_tpu_torch.common import info as tinfo
from equiadapt_tpu_torch.common import selector as tsel
from equiadapt_tpu_torch.ops import group_action as tga
from equiadapt_tpu_torch.ops import warp as tw
from torch_port_cpu import one_intra_op_thread  # noqa: F401

ATOL = 1e-5


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


@pytest.mark.parametrize("padding", ["border", "zeros"])
@pytest.mark.parametrize("angle", [45.0, 30.0, 90.0, 270.0])
def test_static_rotate_matches_jax(padding, angle):
    x = _x((2, 16, 16, 3))
    ref = np.asarray(jw._static_rotate(_j(x), angle, padding))
    ours = tw._static_rotate(_t(x), angle, padding).numpy()
    ours_nchw = tw._static_rotate_from_nchw(
        _t(x).permute(0, 3, 1, 2), angle, padding
    ).permute(0, 2, 3, 1).numpy()
    if angle % 90 == 0:
        assert np.array_equal(ours, ref) and np.array_equal(ours_nchw, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)
        np.testing.assert_allclose(ours_nchw, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("padding", ["border", "zeros"])
@pytest.mark.parametrize("angle", [45.0, -20.0, 135.0, 180.0])
def test_rotate_twopass_matches_jax(padding, angle):
    x = _x((2, 16, 16, 5), seed=1)
    ref = np.asarray(jw.rotate_twopass(_j(x), angle, padding))
    ref_nchw = np.asarray(jw.rotate_twopass_nchw(_j(x), angle, padding))
    ref_from = np.asarray(jw.rotate_twopass_from_nchw(
        _j(x).transpose(0, 3, 1, 2), angle, padding))
    ours = tw.rotate_twopass(_t(x), angle, padding).numpy()
    ours_nchw = tw.rotate_twopass_nchw(_t(x), angle, padding).numpy()
    ours_from = tw.rotate_twopass_from_nchw(
        _t(x).permute(0, 3, 1, 2), angle, padding).numpy()
    for a, b in ((ours, ref), (ours_nchw, ref_nchw), (ours_from, ref_from)):
        if angle % 90 == 0:
            assert np.array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def test_twopass_matrices_match_jax():
    for padding in ("border", "zeros"):
        jm = jw._twopass_matrices(12, 12, 33.0, padding, jnp.float32)
        tm = tw._twopass_matrices(12, 12, 33.0, padding, torch.float32, "cpu")
        for a, b in zip(tm, jm):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_reference_selects_match_jax(n, sign):
    x = _x((8, 16, 16, 3), seed=2)
    idx = np.arange(8) % n
    onehot = np.eye(n, dtype=np.float32)[idx]
    for mode in ("exact", "fast"):
        ref = np.asarray(jw.rotate_discrete(_j(x), _j(onehot), n, sign,
                                            "border", mode))
        ours = tw.rotate_discrete(_t(x), _t(onehot), n, sign, "border",
                                  mode).numpy()
        np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)
    ref = np.asarray(jw.rotate_select_fast(_j(x), _j(idx), n, sign, "border"))
    ours = tw.rotate_select_fast(_t(x), _t(idx), n, sign, "border").numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


def test_center_crop_and_hflip_are_exact():
    x = _x((2, 32, 30, 3), seed=3)
    for size in ((29, 27), (16, 16), (32, 30)):
        assert np.array_equal(tw.center_crop(_t(x), size).numpy(),
                              np.asarray(jw.center_crop(_j(x), size)))
    assert np.array_equal(tw.hflip(_t(x)).numpy(), np.asarray(jw.hflip(_j(x))))


@pytest.mark.parametrize("src,dst", [(224, 64), (224, 56), (202, 64), (32, 16),
                                     (16, 24)])
def test_resize_matches_jax_antialiased(src, dst):
    x = _x((2, src, src, 3), seed=src)
    ref = np.asarray(jw.resize(_j(x), (dst, dst)))
    ours = tw.resize(_t(x), (dst, dst)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n", [1, 4, 6, 8, 16])
def test_group_angles_identical(n):
    ours = tw.group_angles(n, device="cpu").numpy()
    assert np.array_equal(ours, np.asarray(jw.group_angles(n)))
    assert ours.dtype == np.float32


def test_selectors_match_jax():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(6, 8)).astype(np.float32)
    a[0, 3] = a[0, 5] = a[0].max() + 1.0  # tie: first occurrence wins
    assert np.array_equal(tsel.hard_onehot(_t(a)).numpy(),
                          np.asarray(jsel.hard_onehot(_j(a))))
    for training in (False, True):
        ours = tsel.select_onehot(_t(a), beta=2.0, training=training).numpy()
        ref = jsel.select_onehot(_j(a), beta=2.0, training=training)
        np.testing.assert_allclose(ours, np.asarray(ref), rtol=0, atol=1e-6)
    g = rng.gumbel(size=a.shape).astype(np.float32)
    ours = tsel.select_onehot(_t(a), gradient_trick="gumbel_softmax",
                              training=True, gumbels=_t(g)).numpy()
    ref = jsel.hard_onehot(_j(a + g))  # forward values of the hard sample
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=0, atol=1e-6)


def test_straight_through_gradient_is_softmax():
    a = _x((3, 8), seed=5)
    ta = _t(a).requires_grad_(True)
    w = _x((3, 8), seed=6)
    (tsel.straight_through_onehot(ta, beta=1.5) * _t(w)).sum().backward()
    ref = jax.grad(lambda z: jnp.sum(
        jsel.straight_through_onehot(z, beta=1.5) * _j(w)))(_j(a))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_prior_loss_and_identity_metric_match_jax():
    acts = _x((8, 16), seed=7)
    acts[:3, 0] += 10.0
    el = dict(rotation_deg=np.zeros(8, np.float32))
    j = jinfo.DiscreteCanonicalizationInfo(
        group_activations=_j(acts), onehot=_j(acts),
        element=jinfo.DiscreteGroupElement(_j(el["rotation_deg"])),
        num_rotations=8, group_type="roto-reflection",
    )
    t = tinfo.DiscreteCanonicalizationInfo(
        group_activations=_t(acts), onehot=_t(acts),
        element=tinfo.DiscreteGroupElement(_t(el["rotation_deg"])),
        num_rotations=8, group_type="roto-reflection",
    )
    assert t.num_group == j.num_group == 16
    np.testing.assert_allclose(tinfo.prior_regularization_loss(t).item(),
                               float(jinfo.prior_regularization_loss(j)),
                               rtol=1e-6)
    assert tinfo.identity_metric(t).item() == float(jinfo.identity_metric(j))
    ident = tinfo.IdentityCanonicalizationInfo()
    assert tinfo.prior_regularization_loss(ident).item() == 0.0
    assert tinfo.identity_metric(ident).item() == 1.0


def test_roll_by_gather_matches_jax():
    fm = _x((4, 5, 5, 2, 8), seed=8)
    shifts = np.array([0.0, 1.7, -3.2, 13.0], np.float32)
    ref = np.asarray(jga.roll_by_gather(_j(fm), _j(shifts)))
    assert np.array_equal(tga.roll_by_gather(_t(fm), _t(shifts)).numpy(), ref)


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("group,rep", [
    (g, r) for g in ("C8", "D8", "C4") for r in ("regular", "scalar", "vector")
    # the vector rep has no reflection action in either package
    if (g, r) != ("D8", "vector")
])
def test_group_action_matches_jax(mode, group, rep):
    n = 4 if group == "C4" else 8
    reflect = group == "D8"
    G = 2 * n if reflect else n
    rng = np.random.default_rng(G)
    fm = rng.normal(size=(8, 16, 16, 2 * G)).astype(np.float32)
    idx = np.arange(8) % n
    deg = (idx * (360.0 / n)).astype(np.float32)
    refl = (np.arange(8) // 4 % 2).astype(np.float32) if reflect else None
    kw = dict(num_rotations=n, num_group=G, induced_rep_type=rep, mode=mode)
    ref = np.asarray(jga.get_action_on_image_features(
        _j(fm), rotation_deg=_j(deg),
        reflection=None if refl is None else _j(refl), **kw))
    ours = tga.get_action_on_image_features(
        _t(fm), rotation_deg=_t(deg),
        reflection=None if refl is None else _t(refl), **kw).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=ATOL)


def test_group_action_rejects_what_jax_rejects():
    fm = torch.zeros(2, 8, 8, 12)
    deg = torch.zeros(2)
    with pytest.raises(ValueError):
        tga.get_action_on_image_features(fm, num_rotations=8, num_group=8,
                                         rotation_deg=deg)
    with pytest.raises(NotImplementedError):
        tga.get_action_on_image_features(
            torch.zeros(2, 8, 8, 16), num_rotations=8, num_group=16,
            rotation_deg=deg, reflection=deg, induced_rep_type="vector")
