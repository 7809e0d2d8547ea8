"""The discrete main path's training half against the JAX package, on the
CPU: the same Flax variables (drawn from a numpy seed) in both packages and
the same numpy batch.

Bars (fp32): forward values within 1e-5 of the largest (1e-4 for logits);
gradients within 1e-5 of the largest gradient of the module (2e-5 through
the warp blends); a train step's loss, metrics and gradient norms within
1e-5 relative, its BatchNorm statistics within 1e-5 and its updates as
`test_train_step_matches_jax` states (that step in float64); optimizer trajectories against
optax within 1e-6. Dropout is 0 in every parity test; one port-only test
checks the masks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from equiadapt_tpu.common import info as jinfo
from equiadapt_tpu.common import selector as jsel
from equiadapt_tpu.images import EquivariantNetwork as JNet
from equiadapt_tpu.images import GroupEquivariantImageCanonicalization as JCanon
from equiadapt_tpu.images.networks.equivariant import FiberBatchNorm as JFiberBN
from equiadapt_tpu.models import ResNet18 as JResNet18
from equiadapt_tpu.ops import group_action as jga
from equiadapt_tpu.pipelines import classification as jcls
import equiadapt_tpu_torch as tp
from equiadapt_tpu_torch.common import layers as tlayers
from equiadapt_tpu_torch.common import selector as tsel
from equiadapt_tpu_torch.images.networks.equivariant import FiberBatchNorm
from equiadapt_tpu_torch.ops import group_action as tga
from equiadapt_tpu_torch.pipelines import classification as tcls
from test_torch_port_optimized import random_variables
from torch_port_cpu import one_intra_op_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _close_tree(ours, ref, rel=1e-5, path="", scale=None):
    """Leafwise |ours - ref| <= rel * max|ref| over two nested dicts; with
    scale="tree" the largest value of the whole tree sets every leaf's bar
    (gradients of a bias that a BatchNorm cancels are rounding noise)."""
    assert set(ours) == set(ref), (path, sorted(ours), sorted(ref))
    if scale == "tree":
        scale = max(np.abs(np.asarray(v)).max()
                    for v in jax.tree_util.tree_leaves(ref))
    for key, value in ref.items():
        if isinstance(value, dict):
            _close_tree(ours[key], value, rel, f"{path}/{key}", scale)
        else:
            value = np.asarray(value, np.float32)
            bar = scale if scale is not None else np.abs(value).max()
            np.testing.assert_allclose(
                ours[key], value, rtol=0, atol=rel * max(bar, 1e-30),
                err_msg=f"{path}/{key}")


def _grad_tree(module):
    """The module's parameter gradients as a Flax-path tree (zeros where a
    parameter took none)."""
    params = list(module.parameters())
    saved = [p.detach().clone() for p in params]
    with torch.no_grad():
        for p in params:
            p.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
        tree = tp.flax_variables(module)["params"]
        for p, s in zip(params, saved):
            p.copy_(s)
    return tree


def test_fiber_batchnorm_train_matches_flax():
    jbn = JFiberBN(num_group=8)
    x = _x((4, 6, 6, 16), seed=1, scale=3.0) + 0.5
    variables = random_variables(jbn, jnp.zeros((1, 6, 6, 16)), seed=2)
    jy, upd = jbn.apply(variables, jnp.asarray(x), training=True,
                        mutable=["batch_stats"])
    tbn = tp.load_flax_variables(FiberBatchNorm(2, 8, device="cpu"), variables)
    ty = tbn(_t(x).permute(0, 3, 1, 2).contiguous(), training=True)
    np.testing.assert_allclose(ty.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(jy), rtol=0, atol=1e-5)
    _close_tree(tp.flax_variables(tbn)["batch_stats"],
                jax.tree_util.tree_map(np.asarray, dict(upd["batch_stats"])), 1e-6)
    # eval reads the updated statistics
    jy_eval = jbn.apply({**variables, **upd}, jnp.asarray(x))
    ty_eval = tbn(_t(x).permute(0, 3, 1, 2).contiguous())
    np.testing.assert_allclose(ty_eval.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(jy_eval), rtol=0, atol=1e-5)


def test_resnet_train_forward_matches_flax():
    jnet = JResNet18(num_classes=10, small_images=True)
    x = _x((4, 16, 16, 3), seed=3)
    variables = random_variables(jnet, jnp.zeros((1, 16, 16, 3)), seed=4)
    jlogits, upd = jax.jit(functools.partial(
        jnet.apply, training=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    tnet = tp.load_flax_variables(
        tp.ResNet18(num_classes=10, small_images=True, device="cpu"), variables)
    tlogits = tnet(_t(x), training=True).detach().numpy()
    ref = np.asarray(jlogits)
    np.testing.assert_allclose(tlogits, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    _close_tree(tp.flax_variables(tnet)["batch_stats"],
                jax.tree_util.tree_map(np.asarray, dict(upd["batch_stats"])), 1e-5)
    # bf16 computation keeps fp32 parameters and statistics
    t16 = tp.ResNet18(num_classes=10, small_images=True, dtype=torch.bfloat16,
                      device="cpu")
    tp.load_flax_variables(t16, variables)
    out = t16(_t(x), training=True)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert all(p.dtype == torch.float32 for p in t16.parameters())


@pytest.mark.parametrize("group_type,fused", [("rotation", False),
                                              ("rotation", True),
                                              ("roto-reflection", False)])
def test_equivariant_network_gradients_match_jax(group_type, fused):
    """Train-mode GCNN (batch statistics, dropout 0): activations, batch
    statistics and the parameter gradients through the filter-bank assembly
    (`_rotate_bank`, `_fold_avg_pool`)."""
    kw = dict(in_channels=3, out_channels=4, kernel_size=3, group_type=group_type,
              num_rotations=4, num_layers=3, dropout_rate=0.0, fused_pool_lift=fused)
    jnet = JNet(**kw)
    x = _x((4, 14, 14, 3), seed=5)
    variables = random_variables(jnet, jnp.zeros((1, 14, 14, 3)), seed=6)
    G = 8 if group_type == "roto-reflection" else 4
    w = _x((4, G), seed=7)

    def jloss(params):
        acts, upd = jnet.apply({"params": params,
                                "batch_stats": variables["batch_stats"]},
                               jnp.asarray(x), training=True, mutable=["batch_stats"])
        return jnp.sum(acts * w), (acts, upd)

    (_, (jacts, upd)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    tnet = tp.load_flax_variables(tp.EquivariantNetwork(**kw, device="cpu"),
                                  variables)
    acts = tnet(_t(x), training=True)
    torch.sum(acts * _t(w)).backward()
    np.testing.assert_allclose(acts.detach().numpy(), np.asarray(jacts), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jacts)).max())
    _close_tree(tp.flax_variables(tnet)["batch_stats"],
                jax.tree_util.tree_map(np.asarray, dict(upd["batch_stats"])), 1e-5)
    _close_tree(_grad_tree(tnet), jax.tree_util.tree_map(np.asarray, dict(jgrads)),
                scale="tree")


def test_dropout_mask_rate_scale_and_generator():
    drop = tlayers.Dropout(0.5)
    x = torch.ones(200, 100)
    assert drop(x) is x  # eval: identity
    with pytest.raises(ValueError, match="generator"):
        drop(x, training=True)
    a = drop(x, True, torch.Generator().manual_seed(3))
    b = drop(x, True, torch.Generator().manual_seed(3))
    c = drop(x, True, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(a.unique().tolist()) == {0.0, 2.0}  # kept values scaled by 1/(1-p)
    assert abs((a > 0).float().mean().item() - 0.5) < 0.02
    net = tp.EquivariantNetwork(3, 4, 3, num_rotations=4, device="cpu")
    xs = torch.randn(2, 10, 10, 3)
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    assert torch.equal(net(xs, True, g1), net(xs, True, g2))


def test_selectors_gradients_match_jax():
    acts = _x((6, 8), seed=8, scale=2.0)
    w = _x((6, 8), seed=9)
    key = jax.random.key(11)
    noise = np.asarray(jax.random.gumbel(key, acts.shape, jnp.float32))
    cases = {
        "straight_through": (
            lambda a: jsel.select_onehot(a, beta=2.0, training=True),
            lambda a: tsel.select_onehot(a, beta=2.0, training=True)),
        "gumbel_softmax": (
            lambda a: jsel.select_onehot(a, gradient_trick="gumbel_softmax",
                                         training=True, rng=key),
            lambda a: tsel.select_onehot(a, gradient_trick="gumbel_softmax",
                                         training=True, gumbels=_t(noise))),
    }
    for name, (jfn, tfn) in cases.items():
        jout = jfn(jnp.asarray(acts))
        jgrad = jax.grad(lambda a: jnp.sum(jfn(a) * w))(jnp.asarray(acts))
        ta = _t(acts).requires_grad_(True)
        tout = tfn(ta)
        (tgrad,) = torch.autograd.grad(torch.sum(tout * _t(w)), ta)
        np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                                   rtol=0, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=0,
                                   atol=1e-6, err_msg=name)
    # drawn from a generator: a hard one-hot, reproducible from the seed
    draws = [tsel.select_onehot(_t(acts), gradient_trick="gumbel_softmax",
                                training=True,
                                generator=torch.Generator().manual_seed(s))
             for s in (1, 1, 2)]
    assert torch.equal(draws[0], draws[1])
    assert torch.equal(draws[0].argmax(-1), draws[0].round().argmax(-1))
    np.testing.assert_allclose(draws[0].sum(-1).numpy(), 1.0, atol=1e-6)


def test_prior_and_identity_metric_gradients_match_jax():
    acts = _x((5, 8), seed=12)
    info_j = jinfo.DiscreteCanonicalizationInfo(
        group_activations=jnp.asarray(acts), onehot=jnp.zeros((5, 8)),
        element=None, num_rotations=8)
    jgrad = jax.grad(lambda a: jinfo.prior_regularization_loss(
        info_j.replace(group_activations=a)) + jinfo.identity_metric(
        info_j.replace(group_activations=a)))(jnp.asarray(acts))
    ta = _t(acts).requires_grad_(True)
    info_t = tp.DiscreteCanonicalizationInfo(ta, torch.zeros(5, 8), None, 8)
    assert tp.identity_metric(info_t).grad_fn is None  # an argmax count
    (tgrad,) = torch.autograd.grad(tp.prior_regularization_loss(info_t), ta)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=0, atol=1e-7)


CANON_CASES = {  # (group_type, warp_mode, induced rep of the invert): seed
    ("rotation", "exact", "regular"): 20,
    ("roto-reflection", "exact", "regular"): 21,
    ("rotation", "fast", "scalar"): 22,
}


@pytest.mark.parametrize("case", sorted(CANON_CASES))
def test_canonicalize_and_invert_training_match_jax(case):
    """canonicalize(training=True) -> a feature map -> invert(training=True)
    and the prior loss: the loss, the batch statistics and jax.grad with
    respect to the energy network's parameters and the input."""
    group_type, mode, rep = case
    seed = CANON_CASES[case]
    G = 16 if group_type == "roto-reflection" else 8
    net_kw = dict(in_channels=3, out_channels=4, kernel_size=3,
                  group_type=group_type, num_rotations=8, num_layers=2,
                  dropout_rate=0.0)
    canon_kw = dict(in_shape=(24, 24, 3), input_crop_ratio=0.9, resize_shape=16,
                    num_rotations=8, group_type=group_type, warp_mode=mode, beta=2.0)
    jcanon = JCanon(canonicalization_network=JNet(**net_kw), **canon_kw)
    x = _x((6, 24, 24, 3), seed=seed, scale=2.0)
    w1 = _x(x.shape, seed=seed + 1)
    C = 2 * G if rep == "regular" else 3
    v = _x((C,), seed=seed + 2)
    w2 = _x((6, 24, 24, C), seed=seed + 3)
    variables = random_variables(jcanon, jnp.zeros((1, 24, 24, 3)), seed=seed)

    def feature(xc):
        return xc[..., :1] * v if rep == "regular" else xc * v

    # The blend invert rolls the fiber by trunc(rotation_deg / 360 * n), and
    # the straight-through one-hot's selected value is 1 to within an ulp
    # that each framework rounds its own way (a rotation of 89.999995
    # degrees rolls one fiber less): the invert term counts only the
    # samples whose JAX angle is an exact multiple of the step.
    (_, jinf0), _ = jax.jit(functools.partial(
        jcanon.apply, training=True, mutable=["batch_stats"]))(variables,
                                                              jnp.asarray(x))
    steps = np.asarray(jinf0.element.rotation_deg) / 45.0
    exact = steps == np.round(steps)
    assert exact.sum() >= 3
    w2[~exact] = 0.0

    def jloss(params, xx):
        vs = {"params": params, "batch_stats": variables["batch_stats"]}
        (xc, info), upd = jcanon.apply(vs, xx, training=True, mutable=["batch_stats"])
        yi = jcanon.apply(vs, info, feature(xc), induced_rep_type=rep, training=True,
                          method=JCanon.invert_canonicalization)
        loss = (jnp.sum(xc * w1) + jnp.sum(yi * w2)
                + 100.0 * jinfo.prior_regularization_loss(info))
        return loss, (upd, info.group_activations)

    (jl, (upd, jacts)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(variables["params"], jnp.asarray(x))
    top2 = np.sort(np.asarray(jacts), -1)[:, -2:]
    assert np.all(top2[:, 1] - top2[:, 0] > 1e-4), "seed without clear margins"

    tcanon = tp.load_flax_variables(tp.GroupEquivariantImageCanonicalization(
        tp.EquivariantNetwork(**net_kw, device="cpu"), **canon_kw), variables)
    tx = _t(x).requires_grad_(True)
    xc, info = tcanon.canonicalize(tx, training=True)
    yt = xc[..., :1] * _t(v) if rep == "regular" else xc * _t(v)
    yi = tcanon.invert_canonicalization(info, yt, rep, training=True)
    tl = (torch.sum(xc * _t(w1)) + torch.sum(yi * _t(w2))
          + 100.0 * tp.prior_regularization_loss(info))
    tl.backward()
    # three terms of a few hundred that cancel to about 10
    assert tl.item() == pytest.approx(float(jl), rel=1e-4)
    _close_tree(tp.flax_variables(tcanon)["batch_stats"],
                jax.tree_util.tree_map(np.asarray, dict(upd["batch_stats"])), 1e-5)
    _close_tree(_grad_tree(tcanon), jax.tree_util.tree_map(np.asarray, dict(jgp)),
                2e-5, scale="tree")
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=2e-5 * np.abs(np.asarray(jgx)).max())


@pytest.mark.parametrize("n,reflect", [(4, False), (4, True), (8, False), (8, True)])
def test_invert_regular_fast_diff_matches_jax(n, reflect):
    """Forward (K2's plain version against the Pallas kernel in interpret
    mode) and the three cotangents of the custom VJP: the map's (quarter
    turns bit-equal, a permutation), the one-hot's (angle pathway) and the
    reflection's."""
    rng = np.random.default_rng(30 + n + reflect)
    B, H = 6, 16
    G = 2 * n if reflect else n
    fm = rng.normal(size=(B, H, H, 2 * G)).astype(np.float32)
    idx = rng.integers(0, n, size=B)
    onehot = np.eye(n, dtype=np.float32)[idx]
    refl = rng.integers(0, 2, size=B).astype(np.float32) if reflect else None
    w = rng.normal(size=fm.shape).astype(np.float32)

    def jloss(f, oh, r):
        out = jga.invert_regular_fast_diff(f, oh, r, n, True)
        return jnp.sum(out * w), out

    argnums = (0, 1, 2) if reflect else (0, 1)
    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, argnums=argnums,
                                                   has_aux=True))(
        jnp.asarray(fm), jnp.asarray(onehot),
        None if refl is None else jnp.asarray(refl))
    tf, toh = _t(fm).requires_grad_(True), _t(onehot).requires_grad_(True)
    tr = None if refl is None else _t(refl).requires_grad_(True)
    out = tga.invert_regular_fast_diff(tf, toh, tr, n)
    inputs = [tf, toh] + ([tr] if reflect else [])
    tgrads = torch.autograd.grad(torch.sum(out * _t(w)), inputs)
    quarter = idx % (n // 4) == 0
    jout, jgf = np.asarray(jout), np.asarray(jgrads[0])
    assert np.array_equal(out.detach().numpy()[quarter], jout[quarter])
    assert np.array_equal(tgrads[0].numpy()[quarter], jgf[quarter])
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tgrads[0].numpy(), jgf, rtol=0, atol=1e-5)
    for ours, ref in zip(tgrads[1:], jgrads[1:]):
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_training_invert_takes_the_fused_kernel_in_fast_mode():
    """Regular rep, fast mode: the training invert is
    `invert_regular_fast_diff` (K2 forward and backward)."""
    fm = torch.randn(2, 8, 8, 16, requires_grad=True)
    oh = torch.eye(8)[[1, 6]].requires_grad_(True)
    deg = torch.tensor([45.0, 270.0])
    kw = dict(num_rotations=8, num_group=8, rotation_deg=deg, rotation_onehot=oh)
    fused = tga.get_action_on_image_features(fm, mode="fast", **kw)
    assert type(fused.grad_fn).__name__ == "_InvertFastDiffBackward"
    blend = tga.get_action_on_image_features(fm, mode="exact", **kw)
    assert type(blend.grad_fn).__name__ != "_InvertFastDiffBackward"


POLICIES = {
    "sgd_milestone": dict(architecture="resnet50", dataset_name="cifar10",
                          learning_rate=0.1, milestones=(2,), decay_factor=0.1),
    "adamw": dict(architecture="resnet18", dataset_name="cifar10",
                  learning_rate=0.01, canonicalization_learning_rate=0.003),
    "frozen": dict(architecture="resnet18", freeze_prediction=True),
}


class _Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.canonicalizer = torch.nn.Linear(3, 4)
        self.prediction_network = torch.nn.Linear(4, 2)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_make_optimizer_matches_optax(policy):
    kw = dict(POLICIES[policy], weight_decay=1e-2)
    torch.manual_seed(0)
    model = _Toy()
    state = tcls.create_train_state(model, tcls.make_optimizer(model, **kw))
    names = dict(model.named_parameters())
    params = {top: {leaf: names[f"{top}.{leaf}"].detach().numpy().copy()
                    for leaf in ("weight", "bias")}
              for top in ("canonicalizer", "prediction_network")}
    tx = jcls.make_optimizer(**kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt = tx.init(jparams)
    rng = np.random.default_rng(1)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        for top, leaves in grads.items():
            for leaf, g in leaves.items():
                names[f"{top}.{leaf}"].grad = torch.from_numpy(g)
        state.apply_gradients()
        updates, opt = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), opt,
                                 jparams)
        jparams = optax.apply_updates(jparams, updates)
        for top, leaves in jparams.items():
            for leaf, ref in leaves.items():
                np.testing.assert_allclose(
                    names[f"{top}.{leaf}"].detach().numpy(), np.asarray(ref),
                    rtol=0, atol=1e-6, err_msg=f"{policy} {top}.{leaf}")
    assert state.step == 3


def _pipelines(seed, x64=False):
    """A C4 GCNN canonicalizer (dropout 0) before ResNet-18 (CIFAR stem) at
    32 px in both packages, from one draw of Flax variables. With `x64` both
    ResNets compute in float64 and the port's pipeline is `.double()` (the
    JAX side then needs `jax.enable_x64` and float64 variables)."""
    net_kw = dict(in_channels=3, out_channels=4, kernel_size=3,
                  group_type="rotation", num_rotations=4, num_layers=2,
                  dropout_rate=0.0)
    canon_kw = dict(in_shape=(32, 32, 3), input_crop_ratio=0.9, resize_shape=16,
                    num_rotations=4, group_type="rotation")
    jpipe = jcls.ImageClassifierPipeline(
        canonicalizer=JCanon(canonicalization_network=JNet(**net_kw), **canon_kw),
        prediction_network=JResNet18(num_classes=10, small_images=True))
    variables = random_variables(jpipe, jnp.zeros((2, 32, 32, 3)), seed=seed)
    if x64:  # the same variables (fp32 parameters); float64 computation
        jpipe = jpipe.clone(prediction_network=JResNet18(
            num_classes=10, small_images=True, dtype=jnp.float64))

    def port(remat=False):
        tpipe = tcls.ImageClassifierPipeline(
            tp.GroupEquivariantImageCanonicalization(
                tp.EquivariantNetwork(**net_kw, device="cpu"), **canon_kw),
            tp.ResNet18(num_classes=10, small_images=True, device="cpu",
                        dtype=torch.float64 if x64 else torch.float32),
            remat=remat)
        tp.load_flax_variables(tpipe, variables)
        return tpipe.double() if x64 else tpipe

    return jpipe, variables, port


def _batch(seed, b=4):
    rng = np.random.default_rng(seed)
    return {"image": (2.0 * rng.normal(size=(b, 32, 32, 3))).astype(np.float32),
            "label": rng.integers(0, 10, size=b).astype(np.int32)}


def test_train_step_matches_jax():
    """One `make_train_step` (SGD + decay for ResNet-18, AdamW for the
    canonicalizer, prior weight 100, gradient norms) against JAX's, both in
    float64 (`jax.enable_x64`, the port `.double()`). In fp32 a ReLU input
    within rounding of 0 takes the other branch in one framework, and the
    gradients of the layers below it then differ: on one intra-op thread a
    single such input moved the port's update by 1.3e-3 of its norm from
    the float64 step's (3.5e-6 on eight), past this test's 1e-3."""
    jpipe, variables, port = _pipelines(seed=40, x64=True)
    batch = _batch(41)
    opt_kw = dict(architecture="resnet50", dataset_name="cifar10",
                  learning_rate=0.05, milestones=(1,))
    loss_kw = {"prior_weight": 100.0}
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        tx = jcls.make_optimizer(**opt_kw)
        jstate = jcls.TrainState(
            step=jnp.zeros((), jnp.int32), params=v64["params"],
            batch_stats=v64["batch_stats"], opt_state=tx.init(v64["params"]),
            tx=tx, apply_fn=jpipe.apply)
        jstep = jcls.make_train_step(loss_kw, watch_gradients=True)
        jstate, jm = jstep(jstate, {"image": jnp.asarray(batch["image"], jnp.float64),
                                    "label": jnp.asarray(batch["label"])},
                           jax.random.key(0))
        jm = {k: float(v) for k, v in jm.items()}
        ref = jax.tree_util.tree_map(np.asarray, dict(jstate.params))
        ref_stats = jax.tree_util.tree_map(np.asarray, dict(jstate.batch_stats))

    tpipe = port()
    state = tcls.create_train_state(tpipe, tcls.make_optimizer(tpipe, **opt_kw))
    tstep = tcls.make_train_step(loss_kw, watch_gradients=True)
    state, tm = tstep(state, {"image": torch.from_numpy(batch["image"]).double(),
                              "label": torch.from_numpy(batch["label"])})
    assert state.step == 1
    assert set(tm) == set(jm)
    for key in jm:
        assert tm[key].item() == pytest.approx(jm[key], rel=1e-5, abs=1e-7), key
    ours = tp.flax_variables(tpipe)
    _close_tree(ours["batch_stats"], ref_stats, 1e-5)
    before = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    step_ours = jax.tree_util.tree_map(lambda a, b: a - b, ours["params"], before)
    step_ref = jax.tree_util.tree_map(lambda a, b: a - b, ref, before)
    # SGD (prediction network): each leaf's update within 1e-2 of its norm,
    # all of them within 1e-3 (the port's updates read from its fp32
    # snapshot).
    diff = ref_sq = 0.0
    for o, r in zip(jax.tree_util.tree_leaves(step_ours["prediction_network"]),
                    jax.tree_util.tree_leaves(step_ref["prediction_network"])):
        d2, r2 = np.sum((o - r) ** 2), np.sum(r ** 2)
        assert d2 <= 1e-4 * r2, (np.sqrt(d2 / r2), o.shape)
        diff, ref_sq = diff + d2, ref_sq + r2
    assert diff <= 1e-6 * ref_sq
    # AdamW (canonicalizer): a first step moves each element by about
    # lr * sign(grad), so the biases that a BatchNorm cancels, whose
    # gradients are rounding noise, may move either way
    o = np.concatenate([a.ravel() for a in
                        jax.tree_util.tree_leaves(step_ours["canonicalizer"])])
    r = np.concatenate([a.ravel() for a in
                        jax.tree_util.tree_leaves(step_ref["canonicalizer"])])
    assert np.mean(np.abs(o - r) <= 1e-6) >= 0.97


def test_remat_matches_plain_step():
    """remat=True gives the plain step's loss, gradients and BatchNorm
    statistics: the recomputed forward leaves the statistics alone."""
    _, _, port = _pipelines(seed=50)
    batch = {"image": _t(_batch(51)["image"]),
             "label": torch.from_numpy(_batch(51)["label"])}
    results = []
    for remat in (False, True):
        pipe = port(remat)
        logits, info = pipe(batch["image"], training=True)
        loss, _ = tcls.classification_loss(logits, batch["label"], info)
        loss.backward()
        results.append((loss.item(), _grad_tree(pipe),
                        tp.flax_variables(pipe)["batch_stats"]))
    (l0, g0, s0), (l1, g1, s1) = results
    assert l0 == l1
    _close_tree(g1, g0, 1e-6)
    _close_tree(s1, s0, 0.0)
