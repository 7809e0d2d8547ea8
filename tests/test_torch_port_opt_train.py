"""The optimized canonicalizer's training half and the `custom` /
`equivariant_wrn` energy networks against the JAX package.

Networks: `CustomEquivariantNetwork` and `EquivariantWideResNet` (basic
and bottleneck blocks, C4 and D4) in eval and train mode (outputs and the
updated BatchNorm statistics within 1e-5 of the largest), weights carried
across by `load_flax_variables` and back by `flax_variables`; their
registry keys. Optimized training at C4 / D4 / C8 / D8, with and without
`learn_ref_vec`, with the artifact dummies (their rotations handed to both
packages): activations, extras, `optimization_specific_loss` and the prior
loss within 1e-5, the canonical image within 1e-5, the gradients of the
energy network and the reference vector within 1e-5 of the largest
against `jax.grad`; none on the reference vector without
`learn_ref_vec`. The dropout masks and artifact rotations the JAX module
draws from `jax.random` are numpy draws handed to both. One
`make_train_step` on a small optimized config against JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import equiadapt_tpu_torch as tp
from equiadapt_tpu.common.info import prior_regularization_loss as jprior
from equiadapt_tpu.images.canonicalization import discrete_group as jdg
from equiadapt_tpu.images.networks import conv as jconv
from equiadapt_tpu.images.networks import equivariant as jeq
from equiadapt_tpu.models.resnet import ResNet18 as JResNet18
from equiadapt_tpu.pipelines import classification as jcls
from equiadapt_tpu.utils import registry as jreg
from equiadapt_tpu.utils.config import Config as JConfig
from equiadapt_tpu_torch.images.networks import conv as tconv
from equiadapt_tpu_torch.pipelines import classification as tcls
from equiadapt_tpu_torch.utils import registry as treg
from equiadapt_tpu_torch.utils.jax_weights import flax_placements
from test_torch_port_optimized import random_variables
from torch_port_cpu import one_intra_op_thread  # noqa: F401


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _close(ours, ref, rel=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-30))


def _close_tree(ours, ref, rel=1e-5):
    for key, r in ref.items():
        if isinstance(r, dict):
            _close_tree(ours[key], r, rel)
        else:
            _close(ours[key], r, rel)


def _flat(ours, ref):
    """The leaves of two trees of the same keys, flattened in one order."""
    pairs = []

    def walk(o, r):
        for key, rv in r.items():
            if isinstance(rv, dict):
                walk(o[key], rv)
            else:
                pairs.append((np.ravel(o[key]), np.ravel(rv)))

    walk(ours, ref)
    return (np.concatenate([a for a, _ in pairs]),
            np.concatenate([b for _, b in pairs]))


NETS = [("custom", "rotation", None), ("custom", "roto-reflection", None)] + [
    ("wrn", g, block) for g in ("rotation", "roto-reflection")
    for block in ("basic", "bottleneck")]


def _nets(kind, group_type, block):
    kw = dict(in_channels=3, out_channels=4, kernel_size=3, group_type=group_type,
              num_rotations=4)
    if kind == "custom":
        return (jeq.CustomEquivariantNetwork(**kw, num_layers=3),
                tp.CustomEquivariantNetwork(**kw, num_layers=3, device="cpu"))
    return (jeq.EquivariantWideResNet(**kw, block_type=block),
            tp.EquivariantWideResNet(**kw, block_type=block, device="cpu"))


@pytest.mark.parametrize("kind,group_type,block", NETS)
@pytest.mark.parametrize("training", [False, True])
def test_energy_networks_match_flax(kind, group_type, block, training):
    x = _x((3, 12, 12, 3), seed=len(group_type))
    jnet, tnet = _nets(kind, group_type, block)
    variables = random_variables(jnet, jnp.asarray(x), seed=3)
    tp.load_flax_variables(tnet, variables)
    if training:
        ref, upd = jnet.apply(variables, jnp.asarray(x), training=True,
                              mutable=["batch_stats"])
    else:
        ref, upd = jnet.apply(variables, jnp.asarray(x)), {}
    ours = tnet(torch.from_numpy(x), training=training)
    G = 4 * (2 if group_type == "roto-reflection" else 1)
    assert ours.shape == ref.shape == (3, G)
    _close(ours.detach().numpy(), ref)
    back = tp.flax_variables(tnet)
    if "batch_stats" in upd:
        _close_tree(back["batch_stats"],
                    jax.tree_util.tree_map(np.asarray, dict(upd["batch_stats"])))
    _close_tree(back["params"], variables["params"], 0.0)


@pytest.mark.parametrize("network_type", ["custom", "equivariant_wrn"])
def test_registry_builds_the_jax_module_tree(network_type):
    """Same module tree as the JAX registry's: every leaf of the Flax
    variables (shapes by `jax.eval_shape`) has a torch tensor of its
    shape."""
    args = ["canonicalization.canonicalization_type=group_equivariant",
            f"canonicalization.network_type={network_type}",
            "canonicalization.network_hyperparams.num_layers=3",
            "canonicalization.network_hyperparams.group_type=roto-reflection"]
    jcfg, tcfg = JConfig().override(*args), tp.Config().override(*args)
    jnet = jreg.get_image_canonicalization_network(jcfg.canonicalization, (32, 32, 3))
    shapes = jax.eval_shape(jnet.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    variables = jax.tree_util.tree_map(
        lambda s: np.lib.stride_tricks.as_strided(
            np.zeros(1, s.dtype), s.shape, (0,) * len(s.shape)), dict(shapes))
    tnet = treg.get_image_canonicalization_network(tcfg.canonicalization,
                                                   (32, 32, 3), device="meta")
    assert type(tnet).__name__ == type(jnet).__name__
    placed = flax_placements(tnet, variables)
    assert len(placed) == len(jax.tree_util.tree_leaves(variables))


class _Masks:
    """Dropout masks drawn with numpy when the JAX module asks (by shape),
    replayed to the port in the same order."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.drawn = []

    def bernoulli(self, key, p=0.5, shape=None):
        mask = self.rng.uniform(size=shape) < p
        self.drawn.append(mask)
        return jnp.asarray(mask)

    def replay(self, net):
        masks = iter(self.drawn)

        def dropout(y, training=False, generator=None):
            if not training:
                return y
            keep = torch.from_numpy(next(masks))
            return torch.where(keep, y / 0.5, torch.zeros_like(y))

        net.Dropout_0.forward = dropout


CANON_KW = dict(in_shape=(24, 24, 3), input_crop_ratio=0.9, resize_shape=16,
                out_vector_size=16)
NET_KW = dict(in_channels=3, out_channels=8, kernel_size=3, num_layers=2,
              out_vector_size=16)
OPT_CASES = [(n, g, learn, art) for n in (4, 8)
             for g in ("rotation", "roto-reflection")
             for learn, art in ((False, 0.0), (True, 0.5))] + [(8, "rotation", False, 0.5)]


@pytest.mark.parametrize("n,group_type,learn_ref_vec,artifact_err_wt", OPT_CASES)
def test_optimized_training_matches_jax(n, group_type, learn_ref_vec,
                                        artifact_err_wt, monkeypatch):
    B = 3
    G = n * (2 if group_type == "roto-reflection" else 1)
    kw = dict(num_rotations=n, group_type=group_type, learn_ref_vec=learn_ref_vec,
              artifact_err_wt=artifact_err_wt, **CANON_KW)
    jcanon = jdg.OptimizedGroupEquivariantImageCanonicalization(
        canonicalization_network=jconv.ConvNetwork(**NET_KW), **kw)
    variables = random_variables(jcanon, jnp.zeros((2, 24, 24, 3)), seed=n + G)
    x = _x((B, 24, 24, 3), seed=G, scale=2.0)
    idx = np.random.default_rng(G).integers(0, n, G * B)
    masks = _Masks(G + learn_ref_vec)
    monkeypatch.setattr(jax.random, "bernoulli", masks.bernoulli)
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, minval, maxval, *a, **k: jnp.asarray(idx))

    def jloss(params):
        (xc, info), upd = jcanon.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), training=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.key(0), "artifact": jax.random.key(1)})
        opt = jdg.optimization_specific_loss(info, out_vector_size=16,
                                             artifact_err_wt=artifact_err_wt)
        prior = jprior(info)
        loss = opt + prior + 1e-2 * jnp.sum(xc ** 2)
        return loss, (xc, info, opt, prior, upd)

    (jl, (jxc, jinf, jopt, jpr, upd)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(variables["params"])
    monkeypatch.undo()

    net = tconv.ConvNetwork(**NET_KW, input_size=16, device="cpu")
    masks.replay(net)
    tcanon = tp.load_flax_variables(
        tp.OptimizedGroupEquivariantImageCanonicalization(net, device="cpu", **kw),
        variables)
    assert tcanon.reference_vector.requires_grad == learn_ref_vec
    xc, info = tcanon.canonicalize(torch.from_numpy(x), training=True,
                                   artifact_idx=torch.from_numpy(idx))
    opt = tp.optimization_specific_loss(info, out_vector_size=16,
                                        artifact_err_wt=artifact_err_wt)
    prior = tp.prior_regularization_loss(info)
    loss = opt + prior + 1e-2 * torch.sum(xc ** 2)
    loss.backward()
    acts = np.asarray(jinf.group_activations)
    assert acts.shape == tuple(info.group_activations.shape) == (B, G)
    top2 = np.sort(acts, axis=-1)[:, -2:]
    assert np.all(top2[:, 1] - top2[:, 0] > 1e-4), "seed without clear margins"
    np.testing.assert_allclose(info.group_activations.detach().numpy(), acts,
                               rtol=0, atol=1e-5)
    # the straight-through one-hot, hard + (soft - soft), within rounding
    np.testing.assert_allclose(info.onehot.detach().numpy(), np.asarray(jinf.onehot),
                               rtol=0, atol=1e-6)
    assert np.array_equal(info.onehot.detach().numpy().argmax(-1), acts.argmax(-1))
    keys = {"vector_out"} | ({"vector_out_dummy"} if artifact_err_wt else set())
    assert set(info.extras) == set(jinf.extras) == keys
    for key in keys:
        _close(info.extras[key].detach().numpy(), jinf.extras[key])
    assert opt.item() == pytest.approx(float(jopt), rel=1e-5)
    assert prior.item() == pytest.approx(float(jpr), rel=1e-5)
    np.testing.assert_allclose(xc.detach().numpy(), np.asarray(jxc), rtol=0, atol=1e-5)
    back = tp.flax_variables(tcanon)
    _close_tree(back["batch_stats"],
                jax.tree_util.tree_map(np.asarray, dict(upd["batch_stats"])))
    ref_grads = jax.tree_util.tree_map(np.asarray, dict(jgrads))
    ours = {"canonicalization_network": {}}
    for name, p in net.named_parameters():
        *scope, attr = name.split(".")
        leaf = {"weight": "kernel"}.get(attr, attr)
        if scope[0].startswith("BatchNorm") and attr == "weight":
            leaf = "scale"
        g = p.grad.numpy()
        if attr == "weight" and scope[0].startswith("Conv"):
            g = g.transpose(2, 3, 1, 0)
        elif attr == "weight" and scope[0].startswith("Dense"):
            g = g.T
        ours["canonicalization_network"].setdefault(scope[0], {})[leaf] = g
    # one bar for the whole network: the biases of the convolutions before
    # a BatchNorm, which it cancels, have gradients of rounding size
    flat_ours, flat_ref = _flat(ours["canonicalization_network"],
                                ref_grads["canonicalization_network"])
    _close(flat_ours, flat_ref)
    if learn_ref_vec:
        _close(tcanon.reference_vector.grad.numpy(), ref_grads["reference_vector"])
    else:
        assert tcanon.reference_vector.grad is None
        assert np.all(ref_grads["reference_vector"] == 0)


def test_optimized_train_step_matches_jax(monkeypatch):
    """One `make_train_step` of an optimized D4 canonicalizer (learned
    reference vector, artifact dummies, group-contrast weight 1) before
    ResNet-18 at 24 px, AdamW for the canonicalizer and SGD + decay for
    ResNet-18 (the "resnet50" policy, as in test_torch_port_train.py):
    loss and metrics within 1e-5 (ResNet-18's gradient norm 1e-4),
    BatchNorm statistics within 1e-5, and the updates by their norms."""
    B = 4
    kw = dict(num_rotations=4, group_type="roto-reflection", learn_ref_vec=True,
              artifact_err_wt=0.5, **CANON_KW)
    jpipe = jcls.ImageClassifierPipeline(
        canonicalizer=jdg.OptimizedGroupEquivariantImageCanonicalization(
            canonicalization_network=jconv.ConvNetwork(**NET_KW), **kw),
        prediction_network=JResNet18(num_classes=10, small_images=True))
    variables = random_variables(jpipe, jnp.zeros((2, 24, 24, 3)), seed=61)
    rng = np.random.default_rng(62)
    batch = {"image": (2.0 * rng.normal(size=(B, 24, 24, 3))).astype(np.float32),
             "label": rng.integers(0, 10, B).astype(np.int32)}
    idx = rng.integers(0, 4, 8 * B)
    masks = _Masks(63)
    loss_kw = {"prior_weight": 100.0, "group_contrast_weight": 1.0,
               "canonicalization_type": "opt_group_equivariant",
               "out_vector_size": 16, "artifact_err_wt": 0.5}
    lr = 1e-3
    opt_kw = dict(architecture="resnet50", dataset_name="cifar10", learning_rate=lr)
    tx = jcls.make_optimizer(**opt_kw)
    jstate = jcls.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]),
        tx=tx, apply_fn=jpipe.apply)
    monkeypatch.setattr(jax.random, "bernoulli", masks.bernoulli)
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, minval, maxval, *a, **k: jnp.asarray(idx))
    jstep = jcls.make_train_step(loss_kw, rng_names=("dropout", "artifact"),
                                 watch_gradients=True)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.key(0))
    monkeypatch.undo()

    net = tconv.ConvNetwork(**NET_KW, input_size=16, device="cpu")
    masks.replay(net)
    tpipe = tp.load_flax_variables(tcls.ImageClassifierPipeline(
        tp.OptimizedGroupEquivariantImageCanonicalization(net, device="cpu", **kw),
        tp.ResNet18(num_classes=10, small_images=True, device="cpu")), variables)
    orig = tpipe.canonicalizer.get_group_activations
    tpipe.canonicalizer.get_group_activations = (
        lambda x, training=False, generator=None: orig(
            x, training, generator, artifact_idx=torch.from_numpy(idx)))
    state = tcls.create_train_state(tpipe, tcls.make_optimizer(tpipe, **opt_kw))
    state, tm = tcls.make_train_step(loss_kw, watch_gradients=True)(
        state, {"image": torch.from_numpy(batch["image"]),
                "label": torch.from_numpy(batch["label"])}, torch.Generator())
    assert set(tm) == set(jm)
    # ResNet-18's gradient norm takes the ReLU branches below (measured
    # 1.2e-5 relative): 1e-4 there and in the global norm, 1e-5 elsewhere
    spread = ("grad/prediction_network/norm", "grad/global_norm")
    for key in jm:
        assert tm[key].item() == pytest.approx(
            float(jm[key]), rel=1e-4 if key in spread else 1e-5, abs=1e-7), key
    ours = tp.flax_variables(tpipe)
    _close_tree(ours["batch_stats"],
                jax.tree_util.tree_map(np.asarray, dict(jstate.batch_stats)), 1e-5)
    before = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    ref = jax.tree_util.tree_map(np.asarray, dict(jstate.params))
    step_ours = jax.tree_util.tree_map(lambda a, b: a - b, ours["params"], before)
    step_ref = jax.tree_util.tree_map(lambda a, b: a - b, ref, before)

    def rel(o, r):
        """|o - r| / |r| over the leaves of two trees (or two arrays)."""
        o, r = jax.tree_util.tree_leaves(o), jax.tree_util.tree_leaves(r)
        d2 = sum(float(np.sum((a - b) ** 2)) for a, b in zip(o, r))
        return np.sqrt(d2 / sum(float(np.sum(b ** 2)) for b in r))

    # canonicalizer (AdamW: a first step moves each element by about
    # lr * sign(grad)): each leaf within 2e-4 of its norm (measured 6e-5,
    # at the BatchNorm scales), the reference vector's too (measured
    # 5e-5). The biases of the convolutions a BatchNorm follows have a
    # gradient that is rounding noise (checked), so their sign, and their
    # step, is either way: each element moves at most lr on both sides.
    net_o = step_ours["canonicalizer"]["canonicalization_network"]
    net_r = step_ref["canonicalizer"]["canonicalization_network"]
    grads = {n: p.grad for n, p in tpipe.canonicalizer.canonicalization_network
             .named_parameters()}
    largest = max(g.abs().max().item() for g in grads.values())
    for mod, leaves in net_r.items():
        for leaf, r in leaves.items():
            o = net_o[mod][leaf]
            if mod.startswith("Conv_") and leaf == "bias":
                assert grads[f"{mod}.bias"].abs().max().item() <= 1e-6 * largest, mod
                assert np.abs(o).max() <= 1.01 * lr and np.abs(r).max() <= 1.01 * lr
                continue
            assert rel(o, r) <= 2e-4, (mod, leaf, rel(o, r))
    assert rel(step_ours["canonicalizer"]["reference_vector"],
               step_ref["canonicalizer"]["reference_vector"]) <= 2e-4
    # ResNet-18 (SGD): a ReLU input within rounding of 0 takes the other
    # branch in one framework, and the gradients of the layers below it
    # then differ at a few positions (measured: 4e-3 to 8e-3 by top-level
    # module, 6e-3 over all, 6e-6 at the head): each top-level module
    # within 2e-2 of its norm, all of them within 1.5e-2, the head within
    # 1e-4
    pred_o, pred_r = step_ours["prediction_network"], step_ref["prediction_network"]
    for mod in pred_r:
        assert rel(pred_o[mod], pred_r[mod]) <= 2e-2, (mod, rel(pred_o[mod], pred_r[mod]))
    assert rel(pred_o, pred_r) <= 1.5e-2
    assert rel(pred_o["Dense_0"], pred_r["Dense_0"]) <= 1e-4
