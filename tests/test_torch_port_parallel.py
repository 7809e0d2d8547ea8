"""`equiadapt_tpu_torch.parallel` against the JAX package's `parallel/`, on
the CPU: the JAX side on the 8-device virtual mesh of this process, the
port's ranks in worlds of 2, 3 and 4 processes over gloo
(`parallel.launch.spawn`, one intra-op thread each, a file rendezvous,
results through files, a deadline on every world). The same Flax variables
(drawn from a numpy seed) go to both packages.

This module imports no JAX at its top: the ranks import it to find their
functions, and import torch and the port only. Each world runs several
regimes, so a process start is paid once.

Bars: the data-parallel and FSDP steps against `data_parallel_jit` /
`shard_state_fsdp` as `test_torch_port_train.py`'s one-step parity (loss
and metrics 1e-5 relative, BatchNorm statistics 1e-5, SGD updates by their
norms, AdamW within 1e-6 for 97% of the elements); against the port's own
world-1 step with dropout 1e-5 relative; tensor-parallel logits 1e-5 of
the largest; the pipelined ViT 1e-5 of the largest logit; the sweeps'
metrics equal; the sharded checkpoint and export exact.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import equiadapt_tpu_torch as tp
from equiadapt_tpu_torch import parallel as par
from equiadapt_tpu_torch.common.layers import BatchNorm, sharded_draw
from equiadapt_tpu_torch.pipelines import classification as tcls
from equiadapt_tpu_torch.utils import config as cfgmod
from equiadapt_tpu_torch.utils.checkpoint import _snapshot
from torch_port_cpu import one_intra_op_thread  # noqa: F401

DEADLINE = 240  # seconds a world may take
LOSS_KW = {"prior_weight": 100.0}
OPT_KW = dict(architecture="resnet50", dataset_name="cifar10", learning_rate=0.05)
ORBIT_KW = {"prior_weight": 1.0, "group_contrast_weight": 0.5,
            "canonicalization_type": "opt_group_equivariant", "out_vector_size": 32}
VIT_KW = dict(num_classes=4, patch_size=4, hidden_dim=16, num_layers=2, num_heads=4,
              mlp_dim=32)
PP_VIT_KW = dict(num_classes=5, patch_size=4, hidden_dim=16, num_layers=4, num_heads=2,
                 mlp_dim=32)
SAM_KW = dict(img_size=32, patch_size=8, embed_dim=16, depth=2, num_heads=4, out_chans=8,
              window_size=2, global_attn_indexes=(1,))


def _spawn(fn, world, *args):
    return par.spawn(fn, world, "gloo", args=args, timeout=DEADLINE, threads=1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch_np(seed, b, size, classes=10):
    rng = np.random.default_rng(seed)
    return {"image": (2.0 * rng.normal(size=(b, size, size, 3))).astype(np.float32),
            "label": rng.integers(0, classes, size=b).astype(np.int32)}


def _tbatch(batch):
    return {"image": _t(batch["image"]), "label": _t(batch["label"]).long()}


# ------------------------------------------------------------ port modules

NET_KW = dict(in_channels=3, out_channels=4, kernel_size=3, group_type="rotation",
              num_rotations=4, num_layers=2)
CANON_KW = dict(in_shape=(32, 32, 3), input_crop_ratio=0.9, resize_shape=16,
                num_rotations=4, group_type="rotation")


def _dp_pipe(variables, dropout=0.0, double=False):
    """C4 GCNN before ResNet-18 (CIFAR stem) at 32 px, as
    `test_torch_port_train.py`'s `_pipelines`."""
    pipe = tcls.ImageClassifierPipeline(
        tp.GroupEquivariantImageCanonicalization(
            tp.EquivariantNetwork(**NET_KW, dropout_rate=dropout, device="cpu"), **CANON_KW),
        tp.ResNet18(num_classes=10, small_images=True, device="cpu"))
    tp.load_flax_variables(pipe, variables)
    if double:
        pipe.double()
        pipe.prediction_network.dtype = torch.float64  # its computation dtype
    return pipe


def _sgd_state(pipe):
    return tcls.create_train_state(pipe, ([torch.optim.SGD(pipe.parameters(), lr=0.05)], []))


def _dp_step(variables, batch, *, dropout=0.0, mesh=None, fsdp=False, sgd=False,
             double=False):
    """One train step of `_dp_pipe`, data-parallel over `mesh` (FSDP-sharded
    with `fsdp`; in float64 with `double`): (metrics, Flax variables after
    it, the state)."""
    pipe = _dp_pipe(variables, dropout, double)
    state = (_sgd_state(pipe) if sgd else
             tcls.create_train_state(pipe, tcls.make_optimizer(pipe, **OPT_KW)))
    if fsdp:
        par.shard_state_fsdp(state, mesh)
    step = tcls.make_train_step(LOSS_KW, watch_gradients=True)
    if mesh is not None:
        step = par.data_parallel_jit(step, mesh, num_extra_args=1)
    tb = _tbatch(batch)
    if double:
        tb["image"] = tb["image"].double()
    state, m = step(state, tb, torch.Generator().manual_seed(7))
    whole = _dp_pipe(variables, dropout, double)
    whole.load_state_dict(_snapshot(state)["model"])  # sharded tensors gathered
    return {k: v.item() for k, v in m.items()}, tp.flax_variables(whole), state


def _vit_pipe(variables, **kw):
    vit = tp.ViT(**{**VIT_KW, **kw}, image_size=16, device="cpu")
    tp.load_flax_variables(vit, {"params": variables["params"]["net"]})
    return tcls.ImageClassifierPipeline(tp.IdentityCanonicalization(), vit)


def _opt_pipe(variables, orbit_sharding=None, masks=None, group_type="rotation"):
    """The optimized C4 canonicalizer (ConvNetwork 3x3, 8 channels, 2
    layers, 32-vector) before ResNet-18 at 16 px, as JAX's
    test_group_parallel_orbit_training_matches_unsharded builds it; with
    `masks`, its dropout replays the JAX masks (this rank's rows)."""
    cfg = _opt_config(group_type)
    net = tp.get_image_canonicalization_network(cfg, (16, 16, 3), device="cpu")
    canon = tp.get_image_canonicalizer(cfg, net, (16, 16, 3), device="cpu")
    canon.orbit_sharding = orbit_sharding
    pipe = tcls.ImageClassifierPipeline(
        canon, tp.ResNet18(num_classes=4, small_images=True, device="cpu"))
    tp.load_flax_variables(pipe, variables)
    if masks is not None:
        drawn = iter([_t(m) for m in masks])

        def dropout(y, training=False, generator=None):
            if not training:
                return y
            full = next(drawn)
            keep = sharded_draw(lambda shape: full, y.shape)
            return torch.where(keep, y / 0.5, torch.zeros_like(y))

        net.Dropout_0.forward = dropout
    return pipe


def _opt_config(group_type="rotation"):
    return cfgmod.CanonicalizationConfig(
        canonicalization_type="opt_group_equivariant", network_type="cnn",
        network_hyperparams=cfgmod.NetworkHyperparams(
            kernel_size=3, out_channels=8, num_layers=2, num_rotations=4,
            out_vector_size=32, group_type=group_type))


def _gi_pipe(variables, group_type="rotation"):
    cfg = _gi_config(group_type)
    net = tp.get_image_canonicalization_network(cfg, (16, 16, 3), device="cpu")
    canon = tp.get_image_canonicalizer(cfg, net, (16, 16, 3), device="cpu")
    pipe = tcls.ImageClassifierPipeline(
        canon, tp.ResNet18(num_classes=4, small_images=True, device="cpu"))
    return tp.load_flax_variables(pipe, variables)


def _gi_config(group_type):
    return cfgmod.CanonicalizationConfig(
        canonicalization_type="group_equivariant", network_type="e2cnn",
        network_hyperparams=cfgmod.NetworkHyperparams(
            kernel_size=3, out_channels=4, num_layers=1, num_rotations=4,
            group_type=group_type))


def _sqnorm_rel(ours, ref, before):
    """|update_ours - update_ref| / |update_ref| over two Flax trees."""
    import jax

    o = jax.tree_util.tree_leaves(ours)
    r = jax.tree_util.tree_leaves(ref)
    b = jax.tree_util.tree_leaves(before)
    d2 = sum(float(np.sum(((x - z) - (y - z)) ** 2)) for x, y, z in zip(o, r, b))
    r2 = sum(float(np.sum((y - z) ** 2)) for y, z in zip(r, b))
    return np.sqrt(d2 / r2)


def _close_tree(ours, ref, rel):
    import jax

    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ref),
                            jax.tree_util.tree_leaves(ours)):
        a = np.asarray(a)
        np.testing.assert_allclose(b, a, rtol=0, atol=rel * max(np.abs(a).max(), 1e-30),
                                   err_msg=jax.tree_util.keystr(path))


# ------------------------------------------------------------------ ranks

def _world2(rank, world, args):
    """World 2 (1-D meshes): DP against JAX and against world 1 with
    dropout, FSDP, the pipeline, the sharded export, the refusals."""
    out = {"init": par.init_distributed()}
    try:
        par.init_distributed(expected_processes=3)
    except RuntimeError as e:
        out["init_mismatch"] = str(e)
    mesh = par.make_mesh()
    dp = args["dp"]
    out["dp"] = _dp_step(dp["variables"], dp["batch"], mesh=mesh)[:2]
    out["dp_dropout"] = _dp_step(dp["variables"], dp["batch"], dropout=0.5, mesh=mesh,
                                 sgd=True, double=True)[:2]
    m, v, state = _dp_step(dp["variables"], dp["batch"], mesh=mesh, fsdp=True)
    out["fsdp"] = (m, v)
    from torch.distributed.tensor import DTensor
    out["fsdp_local_bytes"] = sum(
        (p.to_local() if isinstance(p, DTensor) else p).numel() * p.element_size()
        for p in state.model.parameters())
    out["fsdp_sharded"] = sorted(n for n, p in state.model.named_parameters()
                                 if isinstance(p, DTensor))
    # BatchNorm in training outside a batch shard, in a world of 2
    try:
        BatchNorm(4, device="cpu")(torch.randn(4, 4, 2, 2), training=True)
    except RuntimeError as e:
        out["bn_refusal"] = str(e)
    # replicate: rank 1's differing tensor takes rank 0's values, and raises
    lin = torch.nn.Linear(2, 2)
    torch.nn.init.constant_(lin.weight, float(rank))
    try:
        par.replicate(lin, mesh)
    except ValueError as e:
        out["replicate"] = (str(e), lin.weight.detach().clone())
    # the pipeline
    pp = args["pp"]
    vit = tp.ViT(**PP_VIT_KW, image_size=16, device="cpu")
    tp.load_flax_variables(vit, pp["variables"])
    smesh = par.make_mesh_stage(world)
    x = _t(pp["x"])
    with torch.no_grad():
        out["pp"] = {q: par.vit_pipeline_apply(vit, None, x, smesh, num_microbatches=2,
                                               shard_queue=q).numpy() for q in (False, True)}
    vit_d = tp.ViT(**PP_VIT_KW, dropout=0.2, image_size=16, device="cpu")
    tp.load_flax_variables(vit_d, pp["variables"])
    with torch.no_grad():
        out["pp_train"] = par.vit_pipeline_apply(vit_d, None, x, smesh, num_microbatches=2,
                                                 training=True, rng=11).numpy()
    out["pp_grads"] = _pp_grads(smesh, pp["blocks"], pp["h"])
    from equiadapt_tpu_torch.common.layers import batch_shard
    from equiadapt_tpu_torch.parallel.mesh import data_shard

    with batch_shard(data_shard(mesh, "data", 3)):
        out["norms"] = _norm_layers(slice(3 * rank, 3 * rank + 3))
    # the sharded export against the whole-batch export
    from equiadapt_tpu_torch.utils.export import (
        export_apply, export_sharded_apply, load_exported)
    pipe = _dp_pipe(dp["variables"])
    xb = _t(dp["batch"]["image"])
    fn = lambda m, b: m(b, training=False)[0]
    blob = export_sharded_apply(fn, pipe, xb, mesh)
    out["export"] = (load_exported(blob)(xb).numpy(),
                     load_exported(export_apply(fn, pipe, xb))(xb).numpy())
    out["export_blob"] = blob if rank == 0 else None
    return out


def _norm_layers(rows=None):
    """NormBatchNorm (steerable), VNBatchNorm and FiberBatchNorm in
    training on a global batch of 6 (or its `rows`, inside the active batch
    shard), a weighted sum of the outputs backpropagated: (the outputs,
    the input gradients, the parameter gradients summed over the ranks, the
    running statistics after the step)."""
    from equiadapt_tpu_torch.images.networks.equivariant import FiberBatchNorm
    from equiadapt_tpu_torch.images.networks.steerable import NormBatchNorm
    from equiadapt_tpu_torch.pointcloud.vector_neurons import VNBatchNorm

    g = torch.Generator().manual_seed(17)
    cases = [(NormBatchNorm((0, 1, 2), device="cpu"), (6, 5, 4, 4)),
             (VNBatchNorm(4, device="cpu"), (6, 7, 3, 4)),
             (FiberBatchNorm(2, 4, device="cpu"), (6, 8, 3, 3))]
    out = []
    for layer, shape in cases:
        x = 1.0 + 2.0 * torch.randn(shape, generator=g)
        w = torch.randn(shape, generator=g)
        if rows is not None:
            x, w = x[rows], w[rows]
        x.requires_grad_()
        y = layer(x, training=True)
        (y * w).sum().backward()
        grads = [p.grad.clone() for p in layer.parameters()]
        if rows is not None:
            for t in grads:
                dist.all_reduce(t)
        out.append((y.detach().numpy(), x.grad.numpy(), [t.numpy() for t in grads],
                    [b.clone().numpy() for b in layer.buffers()]))
    return out


def _pp_grads(smesh, blocks, h):
    """Gradients of sum(y^2) through the schedule (shard_queue on), every
    stage's summed, and of x."""
    stacked = {k: _t(v).requires_grad_() for k, v in blocks.items()}
    x = _t(h).requires_grad_()

    def block_fn(p, a):
        return a + torch.tanh(a @ p["w"] + p["b"])

    y = par.pipeline_apply(block_fn, stacked, x, smesh, num_microbatches=4,
                           shard_queue=True)
    grads = torch.autograd.grad((y ** 2).sum(), [x] + list(stacked.values()))
    for g in grads[1:]:
        dist.all_reduce(g)
    return [g.numpy() for g in grads]


def _world4(rank, world, args, tmp):
    """World 4 (2 x 2 grids): tensor parallelism against JAX, the sharded
    checkpoints, the group sweep and the orbit-sharded step."""
    out = {}
    mesh = par.make_mesh_2d(2, 2)
    tpa = args["tp"]
    pipe = _vit_pipe(tpa["variables"])
    x = _t(tpa["batch"]["image"])
    par.shard_params_tp(pipe.prediction_network, mesh)
    with torch.no_grad():
        out["tp_logits"] = pipe.prediction_network(x).numpy()
    # one AdamW step, the state sharded
    pipe = _vit_pipe(tpa["variables"])
    state = tcls.create_train_state(pipe, ([torch.optim.AdamW(
        pipe.parameters(), lr=1e-3, weight_decay=1e-4)], []))
    par.shard_state_tp(state, mesh)
    heads = pipe.prediction_network.EncoderBlock_0.MultiHeadDotProductAttention_0.num_heads
    step = par.data_parallel_jit(tcls.make_train_step({"prior_weight": 0.0}), mesh)
    state, m = step(state, _tbatch(tpa["batch"]), torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits = pipe.prediction_network(x).numpy()
    out["tp_step"] = (m["loss/total"].item(), logits, heads)
    # SAM's encoder
    enc = tp.SamVitEncoder(**SAM_KW, device="cpu")
    tp.load_flax_variables(enc, tpa["sam_variables"])
    par.shard_params_tp(enc, mesh, spec_fn=par.sam_tp_spec)
    with torch.no_grad():
        out["sam"] = enc(_t(tpa["sam_x"])).numpy()
    out["ckpt_tp"] = _roundtrip(state, tmp + "/tp", lambda: _vit_step_state(
        tpa, mesh, seed=9))
    fmesh = par.make_mesh()
    out["ckpt_fsdp"] = _roundtrip(_vit_step_state(tpa, fmesh, seed=3, fsdp=True),
                                  tmp + "/fsdp",
                                  lambda: _vit_step_state(tpa, fmesh, seed=9, fsdp=True))
    # the group sweep and the orbit-sharded step on the (data, group) grid
    gmesh = par.make_mesh_group(2, 2)
    gi = args["gi"]
    out["gi"] = {k: v.item() for k, v in par.group_sharded_inference(
        _gi_pipe(gi["variables"]), _tbatch(gi["batch"]), gmesh, num_rotations=4).items()}
    out["orbit"] = _orbit_step(args["orbit"], gmesh)
    return out


def _vit_step_state(tpa, mesh, seed, fsdp=False):
    """A tensor-parallel (or FSDP-sharded: every leaf of 1 KiB or more)
    ViT state after one AdamW step, from the weights of `seed`."""
    torch.manual_seed(seed)
    vit = tp.ViT(**VIT_KW, image_size=16, device="cpu")
    pipe = tcls.ImageClassifierPipeline(tp.IdentityCanonicalization(), vit)
    state = tcls.create_train_state(pipe, ([torch.optim.AdamW(pipe.parameters(), lr=1e-3)], []))
    if fsdp:
        par.shard_state_fsdp(state, mesh, min_shard_bytes=1024)
    else:
        par.shard_state_tp(state, mesh)
    step = par.data_parallel_jit(tcls.make_train_step({"prior_weight": 0.0}), mesh)
    step(state, _tbatch(tpa["batch"]), torch.Generator().manual_seed(2))
    return state


def _local_tensors(state):
    """Each rank's own tensors of a state (model and moments) with their
    placements."""
    from torch.distributed.tensor import DTensor

    def own(t, p=None):
        if isinstance(t, DTensor):
            return t.to_local().clone(), ("dtensor", tuple(map(str, t.placements)))
        shard = getattr(p, "tp_shard", None)
        return t.detach().clone(), (None if shard is None else
                                    ("tp", shard.dim, tuple(shard.index.tolist())))

    params = dict(state.model.named_parameters())
    out = {f"model/{k}": own(v, params.get(k)) for k, v in state.model.state_dict().items()}
    for i, opt in enumerate(state.optimizers):
        for p, st in opt.state.items():
            name = next(n for n, q in params.items() if q is p)
            for k, v in st.items():
                out[f"opt{i}/{name}/{k}"] = own(v, p)
    return out


def _roundtrip(state, path, template):
    """Save `state`, restore it into `template()` (other values, the same
    shardings): (every tensor equal, every placement equal, the number of
    tensors), on this rank."""
    from equiadapt_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    saved = _local_tensors(state)
    save_checkpoint(path, state)
    other = template()
    before = _local_tensors(other)
    restored = _local_tensors(restore_checkpoint(path, other))
    assert restored.keys() == saved.keys()
    return (all(torch.equal(restored[k][0], saved[k][0]) for k in saved),
            all(restored[k][1] == before[k][1] == saved[k][1] for k in saved),
            any(not torch.equal(before[k][0], saved[k][0]) for k in saved), len(saved))


def _orbit_step(orb, mesh):
    """One orbit-sharded SGD step (JAX's dropout masks replayed)."""
    pipe = _opt_pipe(orb["variables"], ("group", "data"), orb["masks"], orb["group_type"])
    state = _sgd_state_01(pipe)
    step = par.data_parallel_jit(tcls.make_train_step(ORBIT_KW), mesh)
    state, m = step(state, _tbatch(orb["batch"]), torch.Generator().manual_seed(1))
    return m["loss/total"].item(), tp.flax_variables(pipe)


def _sgd_state_01(pipe):
    return tcls.create_train_state(pipe, ([torch.optim.SGD(pipe.parameters(), lr=0.1)], []))


def _world3(rank, world, args):
    """World 3 (a 1 x 3 grid): D4's 8 elements over 3 group ranks, the
    sweep and the orbit-sharded step with uneven shares."""
    mesh = par.make_mesh_group(1, 3)
    gi = args["gi"]
    sweep = par.group_sharded_inference(
        _gi_pipe(gi["variables"], "roto-reflection"), _tbatch(gi["batch"]), mesh,
        num_rotations=4, group_type="roto-reflection")
    orb = args["orbit"]
    return {"gi": {k: v.item() for k, v in sweep.items()},
            "orbit": _orbit_step(orb, mesh)}


# ---------------------------------------------------------- the JAX sides

@pytest.fixture(scope="module")
def jax_dp():
    """The DP case's variables, batch and JAX `data_parallel_jit` step."""
    import jax
    import jax.numpy as jnp

    from equiadapt_tpu.images import EquivariantNetwork as JNet
    from equiadapt_tpu.images import GroupEquivariantImageCanonicalization as JCanon
    from equiadapt_tpu.models import ResNet18 as JResNet18
    from equiadapt_tpu.parallel import data_parallel_jit, make_mesh, replicate, shard_batch
    from equiadapt_tpu.pipelines import classification as jcls
    from test_torch_port_optimized import random_variables

    jpipe = jcls.ImageClassifierPipeline(
        canonicalizer=JCanon(canonicalization_network=JNet(**NET_KW, dropout_rate=0.0),
                             **CANON_KW),
        prediction_network=JResNet18(num_classes=10, small_images=True))
    variables = random_variables(jpipe, jnp.zeros((2, 32, 32, 3)), seed=40)
    batch = _batch_np(41, 8, 32)
    tx = jcls.make_optimizer(**OPT_KW)
    jstate = jcls.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]),
        tx=tx, apply_fn=jpipe.apply)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    plain, _ = jax.jit(jcls.make_train_step(LOSS_KW, jit=False))(jstate, jb, jax.random.key(0))
    mesh = make_mesh(2)
    step = data_parallel_jit(jcls.make_train_step(LOSS_KW, jit=False, watch_gradients=True),
                             mesh, num_extra_args=1)
    jstate, jm = step(replicate(jstate, mesh), shard_batch(jb, mesh), jax.random.key(0))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, dict(t))
    params = to_np(jstate.params)
    name = "prediction_network"
    # JAX's own step, unsharded against data-parallel: the summation order
    # alone moves ResNet-18's SGD update by 0.45% on this batch of 8
    spread = _sqnorm_rel(to_np(plain.params)[name], params[name], variables["params"][name])
    return {"variables": variables, "batch": batch,
            "metrics": {k: float(v) for k, v in jm.items()}, "spread": spread,
            "params": params, "batch_stats": to_np(jstate.batch_stats)}


@pytest.fixture(scope="module")
def jax_pp():
    import jax
    import jax.numpy as jnp

    from equiadapt_tpu.models import ViT as JViT
    from equiadapt_tpu.parallel.pp import make_mesh_stage, vit_pipeline_apply
    from test_torch_port_optimized import random_variables

    vit = JViT(**PP_VIT_KW)
    x = np.random.default_rng(1).normal(size=(4, 16, 16, 3)).astype(np.float32)
    variables = random_variables(vit, jnp.asarray(x), seed=13)
    mesh = make_mesh_stage(2)
    logits = {q: np.asarray(vit_pipeline_apply(vit, variables, jnp.asarray(x), mesh,
                                               num_microbatches=2, shard_queue=q))
              for q in (False, True)}
    rng = np.random.default_rng(5)
    blocks = {"w": (0.1 * rng.normal(size=(4, 8, 8))).astype(np.float32),
              "b": (0.1 * rng.normal(size=(4, 8))).astype(np.float32)}
    h = rng.normal(size=(8, 8)).astype(np.float32)
    return {"variables": variables, "x": x, "logits": logits, "blocks": blocks, "h": h}


@pytest.fixture(scope="module")
def jax_tp():
    """ViT under `shard_state_tp` on a (2, 2) mesh: logits, one AdamW step;
    SAM's encoder under `sam_tp_spec`."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from equiadapt_tpu.models import ViT as JViT
    from equiadapt_tpu.models.sam_encoder import SamVitEncoder as JSam
    from equiadapt_tpu.parallel import (make_mesh_2d, replicate, sam_tp_spec, shard_batch,
                                        shard_params_tp, shard_state_tp)
    from equiadapt_tpu.pipelines import make_train_step
    from test_torch_port_optimized import random_variables

    class Plain(nn.Module):
        net: nn.Module

        @nn.compact
        def __call__(self, x, training=False):
            return self.net(x, training=training), None

    vit = JViT(**VIT_KW)
    batch = _batch_np(0, 8, 16, classes=4)
    model = Plain(net=vit)
    state = _jax_state(model, random_variables(model, jnp.zeros((2, 16, 16, 3)), seed=11),
                       optax.adamw(1e-3))
    mesh = make_mesh_2d(2, 2)
    s_tp = shard_state_tp(replicate(state, mesh), mesh)
    b = shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
    apply = jax.jit(lambda params, x: vit.apply({"params": params}, x))
    logits = np.asarray(apply(state.params["net"], b["image"]))
    s_tp, m = jax.jit(make_train_step({"prior_weight": 0.0}, jit=False))(
        s_tp, b, jax.random.key(1))
    after = np.asarray(apply(s_tp.params["net"], b["image"]))
    enc = JSam(**SAM_KW)
    sam_x = np.random.default_rng(1).normal(size=(4, 32, 32, 3)).astype(np.float32)
    sam_vars = random_variables(enc, jnp.asarray(sam_x), seed=12)
    sam_out = jax.jit(lambda p, a: enc.apply(p, a))(
        shard_params_tp(sam_vars, mesh, spec_fn=sam_tp_spec),
        jax.device_put(jnp.asarray(sam_x), NamedSharding(mesh, P("data"))))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, dict(t))
    return {"variables": {"params": to_np(state.params)}, "batch": batch, "logits": logits,
            "loss": float(m["loss/total"]), "after": after,
            "sam_variables": to_np(sam_vars), "sam_x": sam_x, "sam": np.asarray(sam_out)}


def _jax_state(pipeline, variables, tx):
    """The JAX train state of `variables` (no eager Flax init)."""
    import jax.numpy as jnp
    from flax.core import FrozenDict

    from equiadapt_tpu.pipelines.classification import TrainState

    return TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                      batch_stats=variables.get("batch_stats", FrozenDict()),
                      opt_state=tx.init(variables["params"]), tx=tx, apply_fn=pipeline.apply)


def _jax_gi(group_type, n_data, n_group, seed):
    """The sweep's variables, batch and JAX `group_sharded_inference` on an
    (n_data, n_group) mesh."""
    import jax
    import jax.numpy as jnp
    import optax

    from equiadapt_tpu.models import ResNet18 as JResNet18
    from equiadapt_tpu.parallel import group_sharded_inference, make_mesh_group
    from equiadapt_tpu.pipelines import ImageClassifierPipeline
    from equiadapt_tpu.utils import (get_image_canonicalization_network,
                                     get_image_canonicalizer)
    from equiadapt_tpu.utils import config as jcfg
    from test_torch_port_optimized import random_variables

    cfg = jcfg.CanonicalizationConfig(
        canonicalization_type="group_equivariant", network_type="e2cnn",
        network_hyperparams=jcfg.NetworkHyperparams(
            kernel_size=3, out_channels=4, num_layers=1, num_rotations=4,
            group_type=group_type))
    net = get_image_canonicalization_network(cfg, (16, 16, 3))
    pipeline = ImageClassifierPipeline(
        canonicalizer=get_image_canonicalizer(cfg, net, (16, 16, 3)),
        prediction_network=JResNet18(num_classes=4, small_images=True))
    variables = random_variables(pipeline, jnp.zeros((2, 16, 16, 3)), seed=seed)
    batch = _batch_np(seed + 1, 6 * n_data, 16, classes=4)
    state = _jax_state(pipeline, variables, optax.sgd(0.1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    sharded = group_sharded_inference(state, jb, make_mesh_group(n_data, n_group),
                                      num_rotations=4, group_type=group_type)
    return {"variables": variables, "batch": batch,
            "sharded": {k: float(v) for k, v in sharded.items()}}


def _jax_orbit(group_type="rotation", seed=3):
    """JAX's orbit-training setup (test_parallel.py) unsharded, its
    dropout masks drawn with numpy and kept for the port."""
    import jax
    import jax.numpy as jnp
    import optax

    from equiadapt_tpu.models import ResNet18 as JResNet18
    from equiadapt_tpu.pipelines import ImageClassifierPipeline, make_train_step
    from equiadapt_tpu.utils import (get_image_canonicalization_network,
                                     get_image_canonicalizer)
    from equiadapt_tpu.utils import config as jcfg
    from test_torch_port_optimized import random_variables

    cfg = jcfg.CanonicalizationConfig(
        canonicalization_type="opt_group_equivariant", network_type="cnn",
        network_hyperparams=jcfg.NetworkHyperparams(
            kernel_size=3, out_channels=8, num_layers=2, num_rotations=4,
            out_vector_size=32, group_type=group_type))
    net = get_image_canonicalization_network(cfg, (16, 16, 3))
    pipeline = ImageClassifierPipeline(
        canonicalizer=get_image_canonicalizer(cfg, net, (16, 16, 3)),
        prediction_network=JResNet18(num_classes=4, small_images=True))
    variables = random_variables(pipeline, jnp.zeros((2, 16, 16, 3)), seed=seed + 60)
    batch = _batch_np(seed, 4, 16, classes=4)
    state = _jax_state(pipeline, variables, optax.sgd(0.1))
    rng = np.random.default_rng(seed + 7)
    masks = []

    def bernoulli(key, p=0.5, shape=None):
        mask = rng.uniform(size=shape) < p
        masks.append(mask)
        return jnp.asarray(mask)

    real = jax.random.bernoulli
    jax.random.bernoulli = bernoulli
    try:
        state, m = jax.jit(make_train_step(ORBIT_KW, jit=False))(
            state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(1))
    finally:
        jax.random.bernoulli = real
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, dict(t))
    return {"variables": variables, "batch": batch, "masks": masks, "group_type": group_type,
            "loss": float(m["loss/total"]), "params": to_np(state.params),
            "batch_stats": to_np(state.batch_stats)}


@pytest.fixture(scope="module")
def world2(jax_dp, jax_pp):
    (r0, r1) = _spawn(_world2, 2, {
        "dp": {k: jax_dp[k] for k in ("variables", "batch")},
        "pp": {k: jax_pp[k] for k in ("variables", "x", "blocks", "h")}})
    return r0, r1


@pytest.fixture(scope="module")
def world4(jax_tp, tmp_path_factory):
    gi = _jax_gi("rotation", 2, 2, seed=20)
    orbit = _jax_orbit()
    results = _spawn(_world4, 4, {
        "tp": {k: jax_tp[k] for k in ("variables", "batch", "sam_variables", "sam_x")},
        "gi": {k: gi[k] for k in ("variables", "batch")},
        "orbit": {k: orbit[k] for k in ("variables", "batch", "masks", "group_type")}},
        str(tmp_path_factory.mktemp("ckpt")))
    return results, gi, orbit


@pytest.fixture(scope="module")
def world3(world4):
    gi = _jax_gi("roto-reflection", 1, 3, seed=30)
    orbit = {**world4[2], "group_type": "roto-reflection", "masks": None}
    results = _spawn(_world3, 3, {
        "gi": {k: gi[k] for k in ("variables", "batch")},
        "orbit": {k: orbit[k] for k in ("variables", "batch", "masks", "group_type")}})
    return results, gi, orbit


# --------------------------------------------------------- no ranks needed

def _jax_tree_leaves(tree):
    import jax

    def key(k):
        return str(getattr(k, "key", getattr(k, "idx", k)))

    return [("/".join(key(k) for k in path), v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)]


def _fsdp_trees():
    import jax
    import jax.numpy as jnp

    from equiadapt_tpu.models import ResNet18 as JResNet18, ViT as JViT
    from equiadapt_tpu.models.sam_encoder import SamVitEncoder as JSam

    return {
        "resnet18": (JResNet18(num_classes=10), (1, 32, 32, 3),
                     lambda: tp.ResNet18(num_classes=10, device="cpu")),
        "vit": (JViT(num_classes=10, patch_size=4, hidden_dim=64, num_layers=2,
                     num_heads=4, mlp_dim=512), (1, 32, 32, 3),
                lambda: tp.ViT(num_classes=10, patch_size=4, hidden_dim=64, num_layers=2,
                               num_heads=4, mlp_dim=512, image_size=32, device="cpu")),
        "sam": (JSam(img_size=64, patch_size=8, embed_dim=64, depth=2, num_heads=4,
                     out_chans=32, window_size=4, global_attn_indexes=(1,)), (1, 64, 64, 3),
                lambda: tp.SamVitEncoder(img_size=64, patch_size=8, embed_dim=64, depth=2,
                                         num_heads=4, out_chans=32, window_size=4,
                                         global_attn_indexes=(1,), device="cpu")),
    }


@pytest.mark.parametrize("name", ["resnet18", "vit", "sam"])
def test_fsdp_sharding_matches_jax_leaf_by_leaf(name):
    """The rule gives the JAX dimension for every leaf (Flax shapes), and
    `fsdp_placements` splits each port parameter along the torch dimension
    its Flax dimension runs along."""
    import jax
    import jax.numpy as jnp

    from equiadapt_tpu.parallel import fsdp_sharding as jax_rule, make_mesh
    from equiadapt_tpu_torch.parallel.fsdp import fsdp_placements
    from equiadapt_tpu_torch.utils.jax_weights import flax_leaf_layouts

    jmod, shape, port = _fsdp_trees()[name]
    variables = jax.eval_shape(jmod.init, jax.random.key(0), jnp.zeros(shape))
    module = port()
    leaves = {l.path: l for l in flax_leaf_layouts(module) if l.collection == "params"}
    for n in (2, 4, 8):
        mesh = make_mesh(n)
        placements = fsdp_placements(module, {"data": n})
        for path, leaf in _jax_tree_leaves(variables["params"]):
            spec = jax_rule(leaf, mesh).spec
            jdim = next((d for d, s in enumerate(spec) if s == "data"), None)
            assert par.fsdp_sharding(leaf, {"data": n}) == jdim, (path, n)
            ours = leaves[tuple(path.split("/"))]
            assert ours.shape == tuple(leaf.shape), path
            tdim = placements[ours.name]
            assert tdim == (None if jdim is None else ours.dims[jdim]), (path, n)
            if tdim is not None:
                assert module.get_parameter(ours.name).shape[tdim] % n == 0


@pytest.mark.parametrize("name", ["vit", "sam"])
def test_tp_specs_match_jax_leaf_by_leaf(name):
    """vit_tp_spec / sam_tp_spec give the JAX spec for every leaf, and the
    port module's Flax paths and shapes are the JAX tree's."""
    import jax
    import jax.numpy as jnp

    from equiadapt_tpu.parallel import sam_tp_spec as jsam, vit_tp_spec as jvit
    from equiadapt_tpu_torch.parallel.tp import _param_leaves

    jmod, shape, port = _fsdp_trees()[name]
    variables = jax.eval_shape(jmod.init, jax.random.key(0), jnp.zeros(shape))
    jax_leaves = {p: tuple(v.shape) for p, v in _jax_tree_leaves(variables["params"])}
    assert dict(_param_leaves(port())) == jax_leaves
    jfn, tfn = (jvit, par.vit_tp_spec) if name == "vit" else (jsam, par.sam_tp_spec)
    sharded = 0
    for path, s in jax_leaves.items():
        ref, ours = jfn(path, s), tfn(path, s)
        assert (None if ref is None else tuple(ref)) == (None if ours is None else tuple(ours)), path
        sharded += ours is not None
    assert sharded >= 8


def test_tp_coverage_check_catches_renamed_module():
    """check_tp_coverage matches the JAX function's paths on a ViT, and
    raises on a renamed sublayer and on a tree no rule matches."""
    import copy

    import jax
    import jax.numpy as jnp

    from equiadapt_tpu.models import ViT as JViT
    from equiadapt_tpu.parallel import check_tp_coverage as jcheck

    vit = tp.ViT(**VIT_KW, image_size=16, device="cpu")
    params = tp.flax_variables(vit)["params"]
    jparams = JViT(**VIT_KW).init(jax.random.key(0), jnp.zeros((1, 16, 16, 3)))["params"]
    assert sorted(par.check_tp_coverage(vit)) == sorted(jcheck(jparams))
    assert sorted(par.check_tp_coverage(params)) == sorted(jcheck(jparams))
    broken = copy.deepcopy(params)
    broken["EncoderBlock_0"]["DenseRenamed_0"] = broken["EncoderBlock_0"].pop("Dense_0")
    with pytest.raises(ValueError, match="renamed sublayer"):
        par.check_tp_coverage(broken)
    with pytest.raises(ValueError, match="no parameter leaf matched"):
        par.check_tp_coverage({"conv": {"kernel": np.zeros((3, 3))}})


def test_init_distributed_without_an_environment(monkeypatch):
    """A no-op returning 1; a requested count it cannot reach raises the
    JAX function's error."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert par.init_distributed() == 1
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="configured for 2"):
        par.init_distributed(expected_processes=2)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="coordinator address"):
        par.init_distributed()


def _sleep(rank, world, seconds):
    import time

    time.sleep(seconds)


def _fail(rank, world):
    if rank == 1:
        raise ValueError("rank 1 fails")
    dist.barrier()


def test_spawn_fails_at_its_deadline_and_on_a_failed_rank():
    import time

    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        par.spawn(_sleep, 2, "gloo", args=(120,), timeout=4, threads=1)
    assert time.monotonic() - t0 < 60
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        par.spawn(_fail, 2, "gloo", timeout=60, threads=1)


def test_orbit_sharding_needs_a_mesh():
    cfg = _opt_config()
    net = tp.get_image_canonicalization_network(cfg, (16, 16, 3), device="cpu")
    canon = tp.get_image_canonicalizer(cfg, net, (16, 16, 3), device="cpu")
    canon.orbit_sharding = ("group", "data")
    with pytest.raises(ValueError, match="active mesh"):
        canon(torch.zeros(2, 16, 16, 3), training=False)


# ---------------------------------------------------------------- world 2

def test_world2_process_group_and_refusals(world2):
    for r in world2:
        assert r["init"] == 2
        assert "configured for 3" in r["init_mismatch"]
        assert "normalizes the local rows only" in r["bn_refusal"]
    msg, weight = world2[1]["replicate"]
    assert "differed from rank 0" in msg and torch.all(weight == 0)
    assert world2[0]["replicate"][1].eq(0).all()


def _check_step_against_jax(metrics, ours, jax_dp):
    """test_torch_port_train.py's one-step bars, with two measured
    widenings: the gradient norms within 2e-4 (on this batch of 8 the
    port's one-process step is 4e-5 (canonicalizer) and 5e-5 (ResNet-18)
    from JAX's there, the world-2 step another 5e-5 from it: ReLU inputs
    within rounding of 0 take the other branch), and ResNet-18's update
    within the larger of 1e-3 and three times JAX's own spread between its
    unsharded and data-parallel steps (`jax_dp`'s "spread")."""
    import jax

    for key, ref in jax_dp["metrics"].items():
        rel = 2e-4 if key.startswith("grad/") else 1e-5
        assert metrics[key] == pytest.approx(ref, rel=rel, abs=1e-7), key
    _close_tree(jax.tree_util.tree_leaves(ours["batch_stats"]), jax_dp["batch_stats"], 1e-5)
    before = jax_dp["variables"]["params"]
    name = "prediction_network"
    rel = _sqnorm_rel(ours["params"][name], jax_dp["params"][name], before[name])
    assert rel <= max(1e-3, 3 * jax_dp["spread"]), (rel, jax_dp["spread"])
    o = np.concatenate([(a - b).ravel() for a, b in zip(
        jax.tree_util.tree_leaves(ours["params"]["canonicalizer"]),
        jax.tree_util.tree_leaves(before["canonicalizer"]))])
    r = np.concatenate([(a - b).ravel() for a, b in zip(
        jax.tree_util.tree_leaves(jax_dp["params"]["canonicalizer"]),
        jax.tree_util.tree_leaves(before["canonicalizer"]))])
    assert np.mean(np.abs(o - r) <= 1e-6) >= 0.97


@pytest.mark.parametrize("rank", [0, 1])
def test_dp_step_matches_jax_data_parallel_jit(world2, jax_dp, rank):
    """Loss, metrics (means over the global batch), BatchNorm statistics
    of the global batch, and the updates, on each rank."""
    metrics, ours = world2[rank]["dp"]
    _check_step_against_jax(metrics, ours, jax_dp)


def test_dp_step_with_dropout_matches_one_process(world2, jax_dp):
    """World 2 against the port's own step in one process on the same
    global batch and generator seed, in float64 (so no ReLU input lies
    within rounding of 0): the GCNN's dropout masks are the global draw's
    rows and BatchNorm takes the global batch's statistics, so the metrics,
    the statistics and the SGD updates agree to 1e-5."""
    import jax

    ref_m, ref, _ = _dp_step(jax_dp["variables"], jax_dp["batch"], dropout=0.5, sgd=True,
                             double=True)
    before = jax_dp["variables"]["params"]
    for r in world2:
        metrics, ours = r["dp_dropout"]
        for key, v in ref_m.items():
            assert metrics[key] == pytest.approx(v, rel=1e-5, abs=1e-7), key
        _close_tree(jax.tree_util.tree_leaves(ours["batch_stats"]), ref["batch_stats"], 1e-5)
        for name in ("canonicalizer", "prediction_network"):
            rel = _sqnorm_rel(ours["params"][name], ref["params"][name], before[name])
            assert rel <= 1e-5, (name, rel)


def test_batchnorm_layers_take_the_global_statistics(world2):
    """NormBatchNorm, VNBatchNorm and FiberBatchNorm in training inside a
    batch shard of 3 of 6 rows: each rank's outputs and input gradients
    are its rows of the one-process layer's, the parameter gradients (summed
    over the ranks) and the running statistics the one-process ones."""
    ref = _norm_layers()
    for rank, r in enumerate(world2):
        rows = slice(3 * rank, 3 * rank + 3)
        for (y, gx, gp, stats), (ry, rgx, rgp, rstats) in zip(r["norms"], ref):
            np.testing.assert_allclose(y, ry[rows], rtol=0, atol=1e-5 * np.abs(ry).max())
            np.testing.assert_allclose(gx, rgx[rows], rtol=0, atol=1e-5 * np.abs(rgx).max())
            for a, b in zip(gp + stats, rgp + rstats):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * max(np.abs(b).max(), 1e-30))


def test_fsdp_step_matches_jax_and_holds_shards(world2, jax_dp):
    """The FSDP step against JAX's (numerically the unsharded program,
    `shard_state_fsdp` only places it) with the same bars; each rank holds
    its shards' bytes of the sharded parameters and all of the others."""
    from equiadapt_tpu_torch.parallel.fsdp import fsdp_placements

    pipe = _dp_pipe(jax_dp["variables"])
    placements = fsdp_placements(pipe, {"data": 2})
    sizes = {n: p.numel() * p.element_size() for n, p in pipe.named_parameters()}
    want = sum(s // 2 if placements[n] is not None else s for n, s in sizes.items())
    for r in world2:
        _check_step_against_jax(*r["fsdp"], jax_dp)
        assert r["fsdp_sharded"] == sorted(n for n, d in placements.items() if d is not None)
        assert len(r["fsdp_sharded"]) >= 10
        assert r["fsdp_local_bytes"] == want < sum(sizes.values())


@pytest.mark.parametrize("shard_queue", [False, True])
def test_vit_pipeline_matches_jax(world2, jax_pp, shard_queue):
    ref = jax_pp["logits"][shard_queue]
    for r in world2:
        np.testing.assert_allclose(r["pp"][shard_queue], ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_vit_pipeline_training_matches_the_sequential_seeds(world2, jax_pp):
    """Dropout 0.2: each block's generator seeded from (11, layer,
    microbatch); the sequential stack with the same seeds."""
    from equiadapt_tpu_torch.parallel.pp import fold_in

    vit = tp.ViT(**PP_VIT_KW, dropout=0.2, image_size=16, device="cpu")
    tp.load_flax_variables(vit, jax_pp["variables"])
    x = _t(jax_pp["x"])
    with torch.no_grad():
        t = vit.Conv_0(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        t = torch.cat([vit.cls_token.expand(4, -1, -1), t], dim=1) + vit.pos_embedding
        outs = []
        for m, h in enumerate(t.reshape(2, 2, *t.shape[1:])):
            for layer in range(4):
                gen = torch.Generator().manual_seed(fold_in(11, layer, m))
                h = getattr(vit, f"EncoderBlock_{layer}")(h, True, gen)
            outs.append(h)
        ref = vit.Dense_0(vit.LayerNorm_0(torch.cat(outs))[:, 0]).numpy()
    for r in world2:
        np.testing.assert_allclose(r["pp_train"], ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def test_pipeline_gradients_match_sequential(world2, jax_pp):
    stacked = {k: _t(v).requires_grad_() for k, v in jax_pp["blocks"].items()}
    x = _t(jax_pp["h"]).requires_grad_()
    h = x
    for layer in range(4):
        h = h + torch.tanh(h @ stacked["w"][layer] + stacked["b"][layer])
    ref = torch.autograd.grad((h ** 2).sum(), [x] + list(stacked.values()))
    for r in world2:
        for got, want in zip(r["pp_grads"], ref):
            np.testing.assert_allclose(got, want.numpy(), rtol=2e-5, atol=1e-6)


def test_sharded_export_matches_the_whole_batch_and_checks_the_world(world2):
    from equiadapt_tpu_torch.utils.export import load_exported

    for r in world2:
        got, ref = r["export"]
        assert got.shape == ref.shape == (8, 10)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    with pytest.raises(ValueError, match="exported for 2 ranks"):
        load_exported(world2[0]["export_blob"])


# ---------------------------------------------------------------- world 4

def test_tp_vit_logits_match_jax(world4, jax_tp):
    ref = jax_tp["logits"]
    for r in world4[0]:
        np.testing.assert_allclose(r["tp_logits"], ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_tp_vit_adamw_step_matches_jax(world4, jax_tp):
    """One AdamW step of the tensor-parallel state: the loss within 1e-5
    and the updated model's logits within 1e-5 of the largest (the key
    biases, whose gradient is rounding noise, move either way in both
    packages but leave the softmax as it is)."""
    ref = jax_tp["after"]
    for r in world4[0]:
        loss, logits, heads = r["tp_step"]
        assert heads == 2
        assert loss == pytest.approx(jax_tp["loss"], rel=1e-5)
        np.testing.assert_allclose(logits, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_tp_sam_encoder_matches_jax(world4, jax_tp):
    ref = jax_tp["sam"]
    for r in world4[0]:
        np.testing.assert_allclose(r["sam"], ref, rtol=0, atol=2e-5 * np.abs(ref).max())


@pytest.mark.parametrize("kind", ["tp", "fsdp"])
def test_sharded_checkpoint_roundtrip(world4, kind):
    """Saved whole by rank 0, restored into a template of other values:
    every rank's tensors and moments equal, with the template's
    placements."""
    for r in world4[0]:
        equal, placed, differed, n = r[f"ckpt_{kind}"]
        assert equal and placed and differed and n > 20


def test_group_sharded_inference_matches_jax(world4):
    """Equal to JAX's `group_sharded_inference` on a (2, 2) mesh (which
    tests/test_parallel.py holds to the unsharded sweep), and to the
    port's own unsharded sweep."""
    results, gi, _ = world4
    ref = tcls.group_inference(_gi_pipe(gi["variables"]), _tbatch(gi["batch"]),
                               num_rotations=4)
    for r in results:
        assert r["gi"] == pytest.approx(gi["sharded"], abs=1e-7)
        assert r["gi"] == {k: v.item() for k, v in ref.items()}


def _check_orbit_step(got, orbit):
    import jax

    loss, ours = got
    assert loss == pytest.approx(orbit["loss"], rel=1e-5)
    _close_tree(jax.tree_util.tree_leaves(ours["batch_stats"]), orbit["batch_stats"], 1e-5)
    for name in ("canonicalizer", "prediction_network"):
        rel = _sqnorm_rel(ours["params"][name], orbit["params"][name],
                          orbit["variables"]["params"][name])
        assert rel <= 1e-3, (name, rel)
    for a, b in zip(jax.tree_util.tree_leaves(ours["params"]),
                    jax.tree_util.tree_leaves(orbit["params"])):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=2e-4)


def test_orbit_sharded_step_matches_jax(world4):
    """JAX's test_group_parallel_orbit_training_matches_unsharded setup on
    a (2, 2) grid, the JAX dropout masks replayed (each rank its rows):
    the loss within 1e-5, the BatchNorm statistics (over the whole orbit
    batch) within 1e-5, the parameters within the JAX test's bars."""
    results, _, orbit = world4
    for r in results:
        _check_orbit_step(r["orbit"], orbit)


# ---------------------------------------------------------------- world 3

def test_group_sweep_with_uneven_shares_matches_jax(world3):
    """D4's 8 elements over 3 group ranks (shares 3, 3, 2): equal to
    JAX's sweep on a (1, 3) mesh (XLA pads the group axis) and to the
    port's unsharded sweep."""
    results, gi, _ = world3
    ref = tcls.group_inference(_gi_pipe(gi["variables"], "roto-reflection"),
                               _tbatch(gi["batch"]), num_rotations=4,
                               group_type="roto-reflection")
    for r in results:
        assert r["gi"] == pytest.approx(gi["sharded"], abs=1e-7)
        assert r["gi"] == {k: v.item() for k, v in ref.items()}


def test_orbit_step_with_uneven_shares_matches_one_process(world3):
    """D4 (8 elements) over 3 group ranks, dropout drawn from the step's
    generator (each rank its rows of the global draw): the port's
    one-process step (held against JAX by test_torch_port_opt_train.py)."""
    import jax

    results, _, orbit = world3
    pipe = _opt_pipe(orbit["variables"], group_type="roto-reflection")
    state = _sgd_state_01(pipe)
    _, m = tcls.make_train_step(ORBIT_KW)(state, _tbatch(orbit["batch"]),
                                          torch.Generator().manual_seed(1))
    ours = tp.flax_variables(pipe)
    for r in results:
        loss, got = r["orbit"]
        assert loss == pytest.approx(m["loss/total"].item(), rel=1e-5)
        _close_tree(jax.tree_util.tree_leaves(got["batch_stats"]), ours["batch_stats"], 1e-5)
        for name in ("canonicalizer", "prediction_network"):
            rel = _sqnorm_rel(got["params"][name], ours["params"][name],
                              orbit["variables"]["params"][name])
            assert rel <= 1e-4, (name, rel)
