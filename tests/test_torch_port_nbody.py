"""The port's n-body family against the JAX package: the simulator,
VN-DeepSets, the SE(3) canonicalizer, the EGNN-style networks and the
Transformer, the pipeline and its train step, the registry keys and the
loader's attention / LayerNorm / Embed leaves.

Both sides get the same numpy inputs; Flax variables are carried across by
`load_flax_variables`, with every bias, LayerNorm scale and embedding
redrawn from a numpy seed, so a leaf carried to the wrong place shows.
Bars (fp32): network outputs within 1e-5 (relative and absolute); frames,
canonical states and the invert within a bar scaled by the condition
number of the network's three vectors (`_frame_bar`); the Transformer within 1e-4 (two LayerNorms a
block: Flax's variance is E[x^2] - E[x]^2, torch's a two-pass one); the
port's SE(3) invariance within 1e-3 and its invert within 1e-4 (the bars
of tests/test_nbody.py). A train step (dropout 0): the loss within 1e-5
relative, each gradient within 1e-4 of the largest gradient element, and
the first AdamW update within 1e-6 (1e-3 of the learning rate) where
|g| > 1e-3 max |g|: Adam's first step moves an element by about the
learning rate whatever its size, so elements of gradient at rounding level
may move either way. The integrator against JAX `_simulate` from the same
initial state: 200 leaps, a frame every 50; its measured drift is in the
test's docstring.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from equiadapt_tpu.data import nbody_sim as jsim
from equiadapt_tpu.models import egnn as jegnn
from equiadapt_tpu.nbody import canonicalization as jcan
from equiadapt_tpu.nbody import vn_deepsets as jvn
from equiadapt_tpu.pipelines import nbody as jpipe
from equiadapt_tpu.utils import config as jcfg
from equiadapt_tpu.utils import registry as jreg
import equiadapt_tpu_torch as tp
from equiadapt_tpu_torch.data import nbody_sim as tsim
from equiadapt_tpu_torch.models import egnn as tegnn
from equiadapt_tpu_torch.nbody import canonicalization as tcan
from equiadapt_tpu_torch.nbody import vn_deepsets as tvn
from equiadapt_tpu_torch.pipelines import nbody as tpipe
from equiadapt_tpu_torch.utils import config as tcfg
from equiadapt_tpu_torch.utils import registry as treg
from torch_port_cpu import one_intra_op_thread  # noqa: F401

KEY = jax.random.key(0)
TOL = dict(rtol=1e-5, atol=1e-5)
B, N = 3, 5


def numpy_variables(variables, seed=0):
    """Flax variables as nested dicts of numpy arrays, with biases, LayerNorm
    scales and embeddings redrawn from `seed`."""
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        leaf = np.asarray(leaf)
        name = path[-1].key
        if name == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(leaf.dtype)
        if name in ("bias", "embedding"):
            return (0.1 * rng.normal(size=leaf.shape)).astype(leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(redraw, jax.tree_util.tree_map(
        np.asarray, dict(variables)))


def _carry(jmodule, tmodule, *args, seed=0, **kwargs):
    """Init the Flax module, redraw its variables and load them into the
    torch module: (variables, torch module)."""
    variables = numpy_variables(jmodule.init(KEY, *args, **kwargs), seed)
    return variables, tp.load_flax_variables(tmodule, variables)


def _t(a):
    return torch.from_numpy(np.array(a))


def _data(b=B, n=N, seed=0):
    rng = np.random.default_rng(seed)
    loc = rng.normal(size=(b, n, 3)).astype(np.float32)
    vel = rng.normal(size=(b, n, 3)).astype(np.float32)
    charges = rng.choice([-1.0, 1.0], size=(b, n, 1)).astype(np.float32)
    return loc, vel, charges


def _rot(seed, b=B):
    """Random proper rotations (b, 3, 3) from numpy."""
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(b, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    return q.astype(np.float32)


def _asymmetric_adjacency(n=N, seed=3):
    """A random digraph without self-loops, not symmetric, with node 0 of
    in-degree 0 (the mean pooling's clamp) and out-degree > 0."""
    rng = np.random.default_rng(seed)
    a = (rng.uniform(size=(n, n)) < 0.5).astype(np.float32)
    np.fill_diagonal(a, 0.0)
    a[:, 0] = 0.0
    a[0, 1:] = 1.0
    assert not np.array_equal(a, a.T)
    return a


def _close(ours, ref, **tol):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), **(tol or TOL))


# ---- VN-DeepSets ----------------------------------------------------------

GRID = [(f, nl, pool) for f in ("p", "pv", "pva", "pvc", "pvac")
        for nl in ("relu", "leakyrelu", "softplus") for pool in ("mean", "sum", "max")]


@pytest.mark.parametrize("feature,nonlinearity,pooling", GRID)
def test_vndeepsets_matches_jax(feature, nonlinearity, pooling):
    kw = dict(hidden_dim=6, num_layers=2, layer_pooling=pooling, final_pooling=pooling,
              nonlinearity=nonlinearity, canon_feature=feature)
    loc, vel, charges = _data()
    jnet = jvn.VNDeepSets(**kw)
    variables, net = _carry(jnet, tvn.VNDeepSets(**kw, device="cpu"), loc, vel, charges)
    vec, t = jnet.apply(variables, loc, vel, charges)
    got_vec, got_t = net(_t(loc), _t(vel), _t(charges))
    assert got_vec.shape == (B, 3, 3) and got_t.shape == (B, 3)
    _close(got_vec, vec)
    _close(got_t, t)


@pytest.mark.parametrize("pooling", ["mean", "sum", "max"])
@pytest.mark.parametrize("out_dim,canon_translation", [(4, False), (4, True), (1, False)])
def test_vndeepsets_asymmetric_adjacency_prediction_and_translation(
        pooling, out_dim, canon_translation):
    """Node v sums (or averages over) its in-neighbours u, a[u, v] = 1; an
    asymmetric graph tells that from the transpose. Prediction mode returns
    per-node vectors; canon_translation adds the fourth channel vector."""
    kw = dict(hidden_dim=6, num_layers=3, layer_pooling=pooling, final_pooling="mean",
              canon_feature="pvac", canon_translation=canon_translation, out_dim=out_dim)
    loc, vel, charges = _data(seed=1)
    adj = _asymmetric_adjacency()
    jnet = jvn.VNDeepSets(**kw)
    variables, net = _carry(jnet, tvn.VNDeepSets(**kw, device="cpu"), loc, vel, charges,
                            adjacency=adj)
    ref = jnet.apply(variables, loc, vel, charges, adjacency=adj)
    got = net(_t(loc), _t(vel), _t(charges), adjacency=_t(adj))
    if out_dim == 1:
        assert got.shape == (B, N, 3)
        _close(got, ref)
    else:
        _close(got[0], ref[0])
        _close(got[1], ref[1])
    # the transposed graph gives another answer: orientation is tested
    other = net(_t(loc), _t(vel), _t(charges), adjacency=_t(adj.T))
    first = got if out_dim == 1 else got[0]
    other = other if out_dim == 1 else other[0]
    assert (other - first).abs().max().item() > 1e-3


def test_vndeepset_layer_dropout_scale_rate_and_eval():
    """Training dropout keeps each value with probability 1 - rate, scaled
    by 1 / (1 - rate), from the generator; eval is the layer without it."""
    torch.manual_seed(0)
    layer = tvn.VNDeepSetLayer(4, 64, dropout=0.5, device="cpu")
    plain = copy.deepcopy(layer)
    plain.dropout.rate = 0.0
    x = torch.randn(8, N, 3, 4)
    adj = tvn.complete_adjacency(N, device="cpu")
    ref = plain(x, adj, training=True)
    assert torch.equal(layer(x, adj, training=False), ref)
    with pytest.raises(ValueError, match="generator"):
        layer(x, adj, training=True)
    g = torch.Generator().manual_seed(1)
    got = layer(x, adj, training=True, generator=g)
    kept = got != 0
    assert abs(kept.float().mean().item() - 0.5) < 0.03
    torch.testing.assert_close(got[kept], 2.0 * ref[kept], rtol=1e-6, atol=0)
    again = layer(x, adj, training=True, generator=torch.Generator().manual_seed(1))
    assert torch.equal(got, again)


def test_complete_adjacency():
    a = tvn.complete_adjacency(4, device="cpu")
    np.testing.assert_array_equal(a.numpy(), np.asarray(jvn.complete_adjacency(4)))


# ---- SE(3) canonicalization ----------------------------------------------

def _canonicalizers(feature="pv", seed=0):
    kw = dict(hidden_dim=8, num_layers=2, canon_feature=feature)
    jc = jcan.EuclideanGroupNBody(canonicalization_network=jvn.VNDeepSets(**kw))
    tc = tcan.EuclideanGroupNBody(tvn.VNDeepSets(**kw, device="cpu"))
    loc, vel, charges = _data(seed=seed)
    nodes = np.linalg.norm(vel, axis=-1, keepdims=True)
    variables, tc = _carry(jc, tc, nodes, loc=loc, vel=vel, charges=charges)
    return jc, variables, tc, (loc, vel, charges, nodes)


def _frame_bar(tc, loc, vel, charges):
    """Per-sample bar (B, 1, 1) of the canonicalizer's outputs: Gram-Schmidt
    turns the 1e-7-level rounding differences of the network's three vectors
    into frame differences about their condition number kappa times
    larger, so 1e-7 kappa max(1, max|loc|) + 1e-6 (measured: 1.1e-6 to
    2.1e-5 at kappa 5.5-1,168, about 2e-8 kappa)."""
    with torch.no_grad():
        vec, _ = tc.canonicalization_network(_t(loc), _t(vel), _t(charges))
    kappa = np.linalg.cond(vec.numpy())
    scale = np.maximum(1.0, np.abs(loc).max(axis=(1, 2)))
    return (1e-7 * kappa * scale + 1e-6)[:, None, None]


@pytest.mark.parametrize("feature,seed", [("pv", 0), ("pv", 1), ("pvac", 2), ("pvac", 3)])
def test_canonicalize_and_invert_match_jax(feature, seed):
    jc, variables, tc, (loc, vel, charges, nodes) = _canonicalizers(feature, seed)
    (cl, cv), info = jc.apply(variables, nodes, loc=loc, vel=vel, charges=charges)
    (tl, tv), tinfo = tc.canonicalize(_t(nodes), loc=_t(loc), vel=_t(vel),
                                      charges=_t(charges))
    bar = _frame_bar(tc, loc, vel, charges)
    for got, ref in ((tl, cl), (tv, cv), (tinfo.element.rotation, info.element.rotation),
                     (tinfo.matrix_rep, info.matrix_rep)):
        assert (np.abs(got.detach().numpy() - np.asarray(ref)) <= bar).all()
    _close(tinfo.element.translation, info.element.translation)
    y = np.random.default_rng(4).normal(size=(B, N, 3)).astype(np.float32)
    diff = np.abs(tc.invert_canonicalization(tinfo, _t(y)).detach().numpy()
                  - np.asarray(jc.invert_canonicalization(info, jnp.asarray(y))))
    assert (diff <= bar * max(1.0, np.abs(y).max())).all()


def test_port_se3_invariance_and_invert():
    """The port alone, with tests/test_nbody.py's bars: canonical states
    invariant under loc -> loc Q + s, vel -> vel Q (1e-3); the invert gives
    loc back (1e-4) and is equivariant (1e-3); the frame vectors rotate and
    the translation roto-translates (1e-4)."""
    _, _, tc, (loc, vel, charges, nodes) = _canonicalizers()
    Q, s = _t(_rot(7)), _t(np.random.default_rng(2).normal(size=(B, 1, 3)).astype(np.float32))
    loc, vel, charges = _t(loc), _t(vel), _t(charges)
    with torch.no_grad():
        (cl, cv), info = tc.canonicalize(None, loc=loc, vel=vel, charges=charges)
        loc2, vel2 = loc @ Q + s, vel @ Q
        (cl2, cv2), info2 = tc.canonicalize(None, loc=loc2, vel=vel2, charges=charges)
        torch.testing.assert_close(cl2, cl, rtol=0, atol=1e-3)
        torch.testing.assert_close(cv2, cv, rtol=0, atol=1e-3)
        torch.testing.assert_close(tc.invert_canonicalization(info, cl), loc,
                                   rtol=0, atol=1e-4)
        y = torch.randn(B, N, 3, generator=torch.Generator().manual_seed(3))
        torch.testing.assert_close(tc.invert_canonicalization(info2, y),
                                   tc.invert_canonicalization(info, y) @ Q + s,
                                   rtol=0, atol=1e-3)
        net = tc.canonicalization_network
        vec, t = net(loc, vel, charges)
        vec2, t2 = net(loc2, vel2, charges)
        torch.testing.assert_close(vec2, vec @ Q, rtol=0, atol=1e-4)
        torch.testing.assert_close(t2, (t[:, None] @ Q)[:, 0] + s[:, 0], rtol=0, atol=1e-4)


# ---- EGNN-style networks and the Transformer -----------------------------

@pytest.mark.parametrize("attention", [False, True])
@pytest.mark.parametrize("recurrent", [False, True])
def test_gcl_matches_jax_on_an_asymmetric_graph(attention, recurrent):
    """Node u sums m_uv over v with a[u, v] = 1; GCL with in_dim != hidden
    when not recurrent."""
    d = 8 if recurrent else 5
    rng = np.random.default_rng(5)
    h = rng.normal(size=(B, N, d)).astype(np.float32)
    e = rng.normal(size=(B, N, N, 2)).astype(np.float32)
    adj = _asymmetric_adjacency()
    jgcl = jegnn.GCL(8, attention=attention, recurrent=recurrent)
    variables, gcl = _carry(jgcl, tegnn.GCL(8, attention=attention, recurrent=recurrent,
                                            in_dim=d, device="cpu"), h, adj, e)
    _close(gcl(_t(h), _t(adj), _t(e)), jgcl.apply(variables, h, adj, e))
    other = gcl(_t(h), _t(adj.T), _t(e))
    assert (other - gcl(_t(h), _t(adj), _t(e))).abs().max().item() > 1e-3


def test_gclrf_matches_jax_on_an_asymmetric_graph():
    loc, _, _ = _data(seed=6)
    adj = _asymmetric_adjacency()
    jl = jegnn.GCLRF(hidden_dim=8)
    variables, layer = _carry(jl, tegnn.GCLRF(hidden_dim=8, device="cpu"), loc, adj)
    _close(layer(_t(loc), _t(adj)), jl.apply(variables, loc, adj))


def test_edge_attributes_and_positional_encoding_match_jax():
    loc, _, charges = _data(seed=7)
    _close(tegnn.edge_attributes(_t(loc), _t(charges)),
           jegnn.edge_attributes(loc, charges))
    x = 3.0 * np.random.default_rng(8).normal(size=(B, N, 6)).astype(np.float32)
    for h in (2, 8, 16):
        _close(tegnn.positional_encoding(_t(x), h), jegnn.positional_encoding(x, h),
               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="even"):
        tegnn.positional_encoding(_t(x), 7)


NETWORKS = {
    "GNN": (lambda: jegnn.GNN(hidden_dim=8, num_layers=2),
            lambda: tegnn.GNN(hidden_dim=8, num_layers=2, device="cpu"), TOL),
    "GNN_attention": (lambda: jegnn.GNN(hidden_dim=8, num_layers=2, attention=True),
                      lambda: tegnn.GNN(hidden_dim=8, num_layers=2, attention=True,
                                        device="cpu"), TOL),
    "NBodyMLP": (lambda: jegnn.NBodyMLP(hidden_dim=8, num_layers=3),
                 lambda: tegnn.NBodyMLP(hidden_dim=8, num_layers=3, device="cpu"), TOL),
    "NBodyMLP_1": (lambda: jegnn.NBodyMLP(hidden_dim=8, num_layers=1),
                   lambda: tegnn.NBodyMLP(hidden_dim=8, num_layers=1, device="cpu"), TOL),
    "Transformer": (lambda: jegnn.NBodyTransformer(hidden_dim=4, num_layers=2, ff_hidden=16),
                    lambda: tegnn.NBodyTransformer(hidden_dim=4, num_layers=2, ff_hidden=16,
                                                   device="cpu"),
                    dict(rtol=1e-4, atol=1e-4)),
}


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_prediction_network_matches_jax(name):
    jf, tf, tol = NETWORKS[name]
    loc, vel, charges = _data(seed=9)
    jnet = jf()
    variables, net = _carry(jnet, tf(), loc, vel, charges)
    out = net(_t(loc), _t(vel), _t(charges))
    assert out.shape == (B, N, 3)
    _close(out, jnet.apply(variables, loc, vel, charges), **tol)


def test_gnn_reads_an_asymmetric_adjacency_as_jax():
    loc, vel, charges = _data(seed=10)
    adj = _asymmetric_adjacency()
    jnet = jegnn.GNN(hidden_dim=8, num_layers=2)
    variables, net = _carry(jnet, tegnn.GNN(hidden_dim=8, num_layers=2, device="cpu"),
                            loc, vel, charges, adjacency=adj)
    _close(net(_t(loc), _t(vel), _t(charges), adjacency=_t(adj)),
           jnet.apply(variables, loc, vel, charges, adjacency=adj))


def test_loader_attention_layernorm_embed_leaves_both_directions():
    """Flax's query / key / value (d, heads, head_dim) and out (heads,
    head_dim, d) kernels, their biases, LayerNorm's scale / bias and Embed's
    embedding load into the Transformer, and `flax_variables` gives the
    same tree back, leaf for leaf."""
    loc, vel, charges = _data()
    variables, net = _carry(jegnn.NBodyTransformer(hidden_dim=4, num_layers=2),
                            tegnn.NBodyTransformer(hidden_dim=4, num_layers=2,
                                                   device="cpu"), loc, vel, charges)
    mha = net.MultiHeadDotProductAttention_1
    assert mha.query.weight.shape == (28, 28) and mha.out.kernel_shape == (2, 14, 28)
    assert net.LayerNorm_3.eps == 1e-6
    back = tp.flax_variables(net)
    flat = dict(jax.tree_util.tree_leaves_with_path(variables["params"]))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    assert flat.keys() == flat_back.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(flat_back[k], v, err_msg=str(k))
    assert set(back) == {"params"}


# ---- pipeline, train step ------------------------------------------------

def _pipelines(prediction="GNN", dropout=0.0, feature="pv"):
    kw = dict(hidden_dim=8, num_layers=2, canon_feature=feature, dropout=dropout)
    preds = {"GNN": (lambda: jegnn.GNN(hidden_dim=8, num_layers=2),
                     lambda: tegnn.GNN(hidden_dim=8, num_layers=2, device="cpu")),
             "Transformer": (lambda: jegnn.NBodyTransformer(hidden_dim=4, num_layers=1),
                             lambda: tegnn.NBodyTransformer(hidden_dim=4, num_layers=1,
                                                            device="cpu")),
             "vndeepsets": (lambda: jvn.VNDeepSets(hidden_dim=8, num_layers=2, out_dim=1),
                            lambda: tvn.VNDeepSets(hidden_dim=8, num_layers=2, out_dim=1,
                                                   device="cpu"))}
    jp, tpred = preds[prediction]
    jpipeline = jpipe.NBodyPipeline(
        canonicalizer=jcan.EuclideanGroupNBody(canonicalization_network=jvn.VNDeepSets(**kw)),
        prediction_network=jp())
    tpipeline = tpipe.NBodyPipeline(
        tcan.EuclideanGroupNBody(tvn.VNDeepSets(**kw, device="cpu")), tpred())
    loc, vel, charges = _data(b=4, seed=11)
    variables, tpipeline = _carry(jpipeline, tpipeline, loc, vel, charges)
    return jpipeline, variables, tpipeline


def _batch(seed=12, b=4):
    loc, vel, charges = _data(b=b, seed=seed)
    loc_end = loc + 0.1 * np.random.default_rng(seed + 1).normal(size=loc.shape).astype(
        np.float32)
    return {"loc": loc, "vel": vel, "charges": charges, "loc_end": loc_end}


@pytest.mark.parametrize("prediction", ["GNN", "Transformer", "vndeepsets"])
def test_pipeline_forward_matches_jax(prediction):
    jp, variables, tpl = _pipelines(prediction)
    b = _batch()
    tol = dict(rtol=1e-4, atol=1e-4) if prediction == "Transformer" else TOL
    _close(tpl(_t(b["loc"]), _t(b["vel"]), _t(b["charges"])),
           jp.apply(variables, b["loc"], b["vel"], b["charges"]), **tol)
    got = tpipe.nbody_eval_mse(tpl, {k: _t(v) for k, v in b.items()})
    ref = jnp.mean((jp.apply(variables, b["loc"], b["vel"], b["charges"])
                    - b["loc_end"]) ** 2)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)


def _grads_as_flax(module):
    """The module's `.grad`s as a Flax-path tree (through a copy whose
    parameters are the gradients)."""
    ghost = copy.deepcopy(module)
    with torch.no_grad():
        for p, q in zip(ghost.parameters(), module.parameters()):
            p.copy_(q.grad)
    return tp.flax_variables(ghost)["params"]


def test_train_step_matches_jax():
    lr, wd = 1e-3, 1e-4
    jp, variables, tpl = _pipelines()
    b = _batch()

    def jloss(params):
        pred = jp.apply({"params": params}, b["loc"], b["vel"], b["charges"], training=True)
        return jnp.mean((pred - b["loc_end"]) ** 2)

    # the JAX step's arithmetic: value_and_grad, then optax's AdamW update
    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    tx = optax.adamw(lr, weight_decay=wd)
    updates, _ = tx.update(jgrads, tx.init(variables["params"]), variables["params"])
    new_params = optax.apply_updates(variables["params"], updates)
    state = tpipe.create_nbody_state(tpl, lr, wd)
    assert len(state.optimizers) == 1
    before = tp.flax_variables(tpl)["params"]
    state, m = tpipe.make_nbody_train_step()(state, {k: _t(v) for k, v in b.items()})
    assert state.step == 1 and m["loss/finite"].item() == 1.0
    np.testing.assert_allclose(m["loss/task"].item(), float(jl), rtol=1e-5)
    tgrads = _grads_as_flax(tpl)
    after = tp.flax_variables(tpl)["params"]
    gmax = max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(jgrads))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tgrads))
    assert flat_j.keys() == flat_t.keys()
    upd_j = jax.tree_util.tree_map(lambda a, c: np.asarray(a) - c,
                                   new_params, variables["params"])
    upd_t = jax.tree_util.tree_map(lambda a, c: a - c, after, before)
    flat_uj = dict(jax.tree_util.tree_leaves_with_path(upd_j))
    flat_ut = dict(jax.tree_util.tree_leaves_with_path(upd_t))
    moved = 0
    for k, gj in flat_j.items():
        gj = np.asarray(gj)
        np.testing.assert_allclose(flat_t[k], gj, rtol=0, atol=1e-4 * gmax, err_msg=str(k))
        big = np.abs(gj) > 1e-3 * gmax
        np.testing.assert_allclose(flat_ut[k][big], flat_uj[k][big], rtol=0, atol=1e-6,
                                   err_msg=str(k))
        moved += int(big.sum())
    assert moved > 100


def test_loss_decreases_over_ten_steps():
    """As tests/test_pipelines.py's n-body test: the same batch, 10 steps of
    Adam(1e-3) (here AdamW with weight decay 0), the last loss below the
    first, on simulated data. That test reads frames 30 and 40 of a
    20-frame run, which JAX clamps to the last frame; the port's indexing
    raises, so frames 10 and 15 here."""
    data = tsim.generate_nbody_dataset(torch.Generator().manual_seed(5), 16,
                                       frame_0=10, frame_t=15, steps=1000,
                                       sample_freq=50, device="cpu")
    torch.manual_seed(6)
    canon = treg.get_nbody_canonicalizer(tcfg.CanonicalizationConfig(
        canonicalization_type="continuous_group",
        network_hyperparams=tcfg.NetworkHyperparams(hidden_dim=8, num_layers=2,
                                                    canon_feature="pv")), device="cpu")
    pipe = tpipe.NBodyPipeline(canon, tegnn.GNN(hidden_dim=16, num_layers=2, device="cpu"))
    state = tpipe.create_nbody_state(pipe, 1e-3, 0.0)
    step = tpipe.make_nbody_train_step()
    losses = []
    for _ in range(10):
        state, m = step(state, data)
        losses.append(m["loss/task"].item())
    assert losses[-1] < losses[0], losses


def test_train_step_dropout_draws_from_the_generator():
    """default.yaml's canonicalizer dropout (0.5): a training step needs a
    generator and the same generator state gives the same step."""
    _, _, tpl = _pipelines(dropout=0.5)
    b = {k: _t(v) for k, v in _batch().items()}
    twin = copy.deepcopy(tpl)
    step = tpipe.make_nbody_train_step()
    with pytest.raises(ValueError, match="generator"):
        step(tpipe.create_nbody_state(copy.deepcopy(tpl)), b)
    s1, m1 = step(tpipe.create_nbody_state(tpl), b, torch.Generator().manual_seed(0))
    s2, m2 = step(tpipe.create_nbody_state(twin), b, torch.Generator().manual_seed(0))
    assert m1["loss/task"].item() == m2["loss/task"].item()
    for p, q in zip(tpl.parameters(), twin.parameters()):
        assert torch.equal(p, q)


# ---- simulator -----------------------------------------------------------

@pytest.mark.parametrize("kind", ["charged", "springs"])
def test_integrator_matches_jax_simulate(kind):
    """From the same initial state, 200 leaps with a frame every 50, against
    JAX `_simulate`. Measured drift (max |diff| over the 4 frames of 64
    systems, fp32): charged 4.2e-7 in positions and 5.5e-6 in velocities,
    springs 1.2e-7 / 6.0e-8. Over the CLI's 5000 leaps the charged systems
    part (close approaches and the force clip amplify rounding): the
    median system by 1.1e-5 in positions, the worst by 1.33; springs stay
    within 7.2e-7. Bars: 1e-5 in positions, 1e-4 in velocities."""
    rng = np.random.default_rng(13)
    b, n = 64, 5
    loc0 = rng.normal(size=(b, n, 3)).astype(np.float32)
    vel0 = rng.normal(size=(b, n, 3)).astype(np.float32)
    vel0 *= 0.5 / np.linalg.norm(vel0, axis=-1, keepdims=True)
    if kind == "charged":
        q = rng.choice([-1.0, 1.0], size=(b, n)).astype(np.float32)
        edges, strength = q[:, :, None] * q[:, None, :], 1.0
    else:
        s = rng.choice([0.0, 1.0], size=(b, n, n)).astype(np.float32)
        edges = (np.triu(s) + np.swapaxes(np.triu(s, 1), -1, -2)) * (1 - np.eye(n))
        edges, strength = edges.astype(np.float32), 0.1
    jl, jv = jsim._simulate(loc0, vel0, edges, 200, 50, kind, strength)
    tl, tv = tsim._simulate(_t(loc0), _t(vel0), _t(edges), 200, 50, kind, strength)
    assert tl.shape == tv.shape == (b, 4, n, 3)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-4)


def test_generate_dataset_shapes_and_frames():
    seed = 21

    def gen():
        return torch.Generator().manual_seed(seed)

    kw = dict(steps=500, sample_freq=10, device="cpu")
    d = tsim.generate_nbody_dataset(gen(), 6, n_balls=4, frame_0=30, frame_t=40, **kw)
    traj = tsim.simulate_charged(gen(), 6, n_balls=4, **kw)
    assert traj["loc"].shape == traj["vel"].shape == (6, 50, 4, 3)
    assert {k: tuple(v.shape) for k, v in d.items()} == {
        "loc": (6, 4, 3), "vel": (6, 4, 3), "charges": (6, 4, 1), "loc_end": (6, 4, 3)}
    assert torch.equal(d["loc"], traj["loc"][:, 30])
    assert torch.equal(d["vel"], traj["vel"][:, 30])
    assert torch.equal(d["loc_end"], traj["loc"][:, 40])
    assert set(d["charges"].unique().tolist()) <= {-1.0, 1.0}
    assert torch.equal(traj["edges"], traj["charges"] * traj["charges"].transpose(1, 2))
    # a fresh draw from the same seed is the same data; initial speeds 0.5
    again = tsim.generate_nbody_dataset(gen(), 6, n_balls=4, **kw)
    assert all(torch.equal(d[k], again[k]) for k in d)
    short = tsim.simulate_charged(gen(), 6, n_balls=4, steps=0, sample_freq=10, device="cpu")
    assert short["loc"].shape == (6, 0, 4, 3)
    springs = tsim.simulate_springs(gen(), 32, steps=100, sample_freq=10, device="cpu")
    e = springs["edges"]
    assert torch.equal(e, e.transpose(1, 2))
    assert torch.equal(torch.diagonal(e, dim1=1, dim2=2), torch.zeros(32, 5))
    assert set(e.unique().tolist()) == {0.0, 1.0}  # probability 0 for 0.5
    assert torch.equal(springs["charges"], torch.zeros(32, 5, 1))
    assert springs["loc"].shape == (32, 10, 5, 3)


# ---- registry ------------------------------------------------------------

@pytest.mark.parametrize("architecture", ["GNN", "Transformer", "vndeepsets"])
def test_registry_builds_the_jax_module_trees(architecture):
    """The registries build the JAX package's module trees: the JAX
    registry's variables load into the port's module (every leaf placed,
    every tensor filled), and the outputs agree."""
    hp = dict(hidden_dim=8, num_layers=3, canon_feature="pvc", canon_translation=True,
              nonlinearity="softplus", layer_pooling="sum", dropout=0.0)
    jc = jreg.get_nbody_canonicalizer(jcfg.CanonicalizationConfig(
        canonicalization_type="continuous_group",
        network_hyperparams=jcfg.NetworkHyperparams(**hp)))
    tc = treg.get_nbody_canonicalizer(tcfg.CanonicalizationConfig(
        canonicalization_type="continuous_group",
        network_hyperparams=tcfg.NetworkHyperparams(**hp)), device="cpu")
    assert isinstance(tc, tcan.EuclideanGroupNBody)
    pred = dict(architecture=architecture, hidden_dim=4, num_layers=2)
    jpred = jreg.get_nbody_prediction_network(jcfg.PredictionConfig(**pred))
    tpred = treg.get_nbody_prediction_network(tcfg.PredictionConfig(**pred), device="cpu")
    jp = jpipe.NBodyPipeline(canonicalizer=jc, prediction_network=jpred)
    b = _batch(seed=14)
    variables, tpl = _carry(jp, tpipe.NBodyPipeline(tc, tpred), b["loc"], b["vel"],
                            b["charges"])
    got = tpl(_t(b["loc"]), _t(b["vel"]), _t(b["charges"])).detach().numpy()
    ref = np.asarray(jp.apply(variables, b["loc"], b["vel"], b["charges"]))
    # the output passes through the frame: its bar scales with the frame's
    # conditioning and the output's size (Transformer: 1e-4 besides)
    scale = np.maximum(1.0, np.abs(ref).max(axis=(1, 2)))[:, None, None]
    bar = _frame_bar(tc, b["loc"], b["vel"], b["charges"]) * scale
    if architecture == "Transformer":
        bar = bar + 1e-4 * scale
    assert (np.abs(got - ref) <= bar).all()


def test_registry_identity_and_unknown_keys():
    assert isinstance(treg.get_nbody_canonicalizer(
        tcfg.CanonicalizationConfig(canonicalization_type="identity"), device="cpu"),
        tp.IdentityCanonicalization)
    with pytest.raises(ValueError, match="not implemented"):
        treg.get_nbody_prediction_network(tcfg.PredictionConfig(architecture="MLP"),
                                          device="cpu")
    assert tp.get_nbody_prediction_network is treg.get_nbody_prediction_network
    assert tp.NBodyPipeline is tpipe.NBodyPipeline
    assert tp.EuclideanGroupNBody is tcan.EuclideanGroupNBody


def test_identity_canonicalizer_pipeline_refuses_as_in_jax():
    """A fault shared with the JAX package (ROADMAP.md section 3): the
    registry's "identity" n-body canonicalizer returns (nodes, info), which
    `NBodyPipeline` unpacks as ((loc, vel), info); both packages raise."""
    loc, vel, charges = _data(b=4)
    jp = jpipe.NBodyPipeline(canonicalizer=jreg.get_nbody_canonicalizer(
        jcfg.CanonicalizationConfig(canonicalization_type="identity")),
        prediction_network=jegnn.GNN(hidden_dim=8, num_layers=1))
    with pytest.raises(ValueError, match="too many values to unpack"):
        jp.init(KEY, loc, vel, charges)
    tpl = tpipe.NBodyPipeline(
        treg.get_nbody_canonicalizer(
            tcfg.CanonicalizationConfig(canonicalization_type="identity"), device="cpu"),
        tegnn.GNN(hidden_dim=8, num_layers=1, device="cpu"))
    with pytest.raises(ValueError, match="too many values to unpack"):
        tpl(_t(loc), _t(vel), _t(charges))
