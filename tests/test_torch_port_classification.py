"""The classification pipeline's eval half, the config taxonomy and the
registries against the JAX package.

Configs: `compose_config` of the repo's yaml files gives equal `Config`s in
both packages. Registries: the same config builds the same module tree
(the loader places every Flax leaf and fills every torch tensor) and the
same outputs. Pipeline: `ImageClassifierPipeline` (C4 GCNN canonicalizer
from `configs/default.yaml`, ResNet-18 with the CIFAR stem at 32 px),
`classification_loss`, `make_eval_step`, `vanilla_inference` and
`group_inference` (C4 orbit by K4's plain version, C8 and D8 by the static
warps), Flax variables drawn from a numpy seed. Bars (fp32): activations
within 1e-5, logits within 1e-4 of the largest, losses within 1e-5
relative, accuracies equal.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from equiadapt_tpu.pipelines import classification as jcls
from equiadapt_tpu.utils import config as jconfig
from equiadapt_tpu.utils import registry as jreg
import equiadapt_tpu_torch as tp
from equiadapt_tpu_torch.pipelines import classification as tcls
from equiadapt_tpu_torch.utils import config as tconfig
from equiadapt_tpu_torch.utils import registry as treg
from equiadapt_tpu_torch.utils.jax_weights import flax_placements
from test_torch_port_optimized import random_variables

CLS_CFG = Path(__file__).resolve().parents[1] / "examples/images/classification/configs"
DEFAULT = f"config={CLS_CFG}/default.yaml"

ARGVS = [
    [DEFAULT],
    [DEFAULT, "canonicalization=opt_group_equivariant"],
    ["canonicalization=opt_group_equivariant",
     "canonicalization.network_hyperparams.num_rotations=4"],
    ["canonicalization=steerable", "experiment.inference_method=group",
     "prediction.dtype=bfloat16"],
    ["canonicalization=identity", "dataset.image_size=96"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_compose_config_matches_jax(argv):
    ours = tconfig.compose_config(argv, config_dir=str(CLS_CFG))
    ref = jconfig.compose_config(argv, config_dir=str(CLS_CFG))
    assert ours.to_dict() == ref.to_dict()
    assert ours.override("experiment.seed=3").to_dict() == \
        ref.override("experiment.seed=3").to_dict()


def test_config_taxonomy_is_the_same():
    names = ["NetworkHyperparams", "CanonicalizationConfig", "TrainingLossConfig",
             "ExperimentConfig", "DatasetConfig", "PredictionConfig",
             "CheckpointConfig", "Config"]
    for name in names:
        ours, ref = getattr(tconfig, name)(), getattr(jconfig, name)()
        assert type(ours).__dataclass_fields__.keys() == \
            type(ref).__dataclass_fields__.keys(), name
    path = CLS_CFG / "default.yaml"
    assert tconfig.load_yaml(str(path)).to_dict() == \
        jconfig.load_yaml(str(path)).to_dict()


def _cfg(*argv):
    return tconfig.compose_config([DEFAULT, *argv], config_dir=str(CLS_CFG))


def _both_canonicalizers(cfg, in_shape, seed):
    """(JAX canonicalizer, its variables, the port's), built by the two
    registries from one config."""
    c = cfg.canonicalization
    jc = jconfig.Config.from_dict(cfg.to_dict()).canonicalization
    jcanon = jreg.get_image_canonicalizer(
        jc, jreg.get_image_canonicalization_network(jc, in_shape), in_shape)
    variables = random_variables(jcanon, jnp.zeros((2,) + in_shape), seed=seed)
    tcanon = treg.get_image_canonicalizer(
        c, treg.get_image_canonicalization_network(c, in_shape, device="cpu"),
        in_shape, device="cpu")
    tp.load_flax_variables(tcanon, variables).eval()
    return jcanon, variables, tcanon


@pytest.mark.parametrize("argv", [
    (),
    ("canonicalization=opt_group_equivariant",),
    ("canonicalization=opt_group_equivariant",
     "canonicalization.network_hyperparams.num_rotations=4"),
    # the yaml's widths cut: tracing the JAX module's block-by-block
    # assembly of its 2,304 hidden blocks takes about 20 s on the CPU
    ("canonicalization=steerable",
     "canonicalization.network_hyperparams.out_channels=2",
     "canonicalization.network_hyperparams.kernel_size=5"),
], ids=["default_c4", "opt_d8", "opt_d4", "steerable"])
def test_registry_builds_the_jax_canonicalizer(argv):
    cfg = _cfg(*argv)
    in_shape = (32, 32, 3)
    jcanon, variables, tcanon = _both_canonicalizers(cfg, in_shape, seed=1)
    x = np.random.default_rng(2).normal(size=(3,) + in_shape).astype(np.float32)
    jx, jinf = jcanon.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        tx, tinf = tcanon.canonicalize(torch.from_numpy(x))
    if cfg.canonicalization.canonicalization_type == "steerable":
        np.testing.assert_allclose(tinf.matrix_rep.numpy(),
                                   np.asarray(jinf.matrix_rep), rtol=0, atol=1e-5)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-4)
        return
    acts = np.asarray(jinf.group_activations)
    top2 = np.sort(acts, axis=-1)[:, -2:]
    assert np.all(top2[:, 1] - top2[:, 0] > 1e-4), "seed without clear margins"
    np.testing.assert_allclose(tinf.group_activations.numpy(), acts, rtol=0, atol=1e-5)
    assert np.array_equal(tinf.onehot.numpy().argmax(-1), acts.argmax(-1))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-5)


@pytest.mark.parametrize("network_type", ["non_equivariant_resnet18",
                                          "non_equivariant_wrn50"])
def test_registry_resnet_heads_take_every_leaf(network_type):
    cfg = _cfg("canonicalization=opt_group_equivariant",
               f"canonicalization.network_type={network_type}")
    jc = jconfig.Config.from_dict(cfg.to_dict()).canonicalization
    shapes = jax.eval_shape(
        jreg.get_image_canonicalization_network(jc, (32, 32, 3)).init,
        jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    variables = jax.tree_util.tree_map(
        lambda s: np.lib.stride_tricks.as_strided(
            np.zeros(1, s.dtype), s.shape, (0,) * len(s.shape)), dict(shapes))
    tnet = treg.get_image_canonicalization_network(
        cfg.canonicalization, (32, 32, 3), device="meta")
    placed = flax_placements(tnet, variables)
    assert len(placed) == len(jax.tree_util.tree_leaves(variables))


def test_registry_prediction_and_pointcloud_factories():
    cfg = _cfg()
    net = treg.get_image_prediction_network(cfg.prediction, 10, small_images=True,
                                            device="cpu")
    assert [len(s) for s in net._stages] == [3, 4, 6, 3] and net.small_images
    assert net.Bottleneck_0 is not None and net.Dense_0.out_features == 10
    bf16 = cfg.override("prediction.architecture=resnet18",
                        "prediction.dtype=bfloat16")
    net = treg.get_image_prediction_network(bf16.prediction, 10, False, device="cpu")
    assert [len(s) for s in net._stages] == [2, 2, 2, 2]
    # bf16 computation over fp32 parameters, Flax's dtype / param_dtype split
    assert net.dtype == torch.bfloat16
    assert net.BasicBlock_0.Conv_0.weight.dtype == torch.float32
    pc = cfg.override("canonicalization.canonicalization_type=continuous_group",
                      "canonicalization.network_hyperparams.knn_mode=fused")
    canon = treg.get_pointcloud_canonicalizer(pc.canonicalization, device="cpu")
    assert isinstance(canon, tp.EquivariantPointcloudCanonicalization)
    assert canon.canonicalization_network.knn_mode == "fused"
    assert isinstance(treg.get_pointcloud_prediction_network(
        "DGCNN", 40, k=20, device="cpu"), tp.DGCNN)
    assert isinstance(treg.get_pointcloud_prediction_network(
        "pointnet", 40, device="cpu"), tp.PointNet)
    ident = cfg.override("canonicalization.canonicalization_type=identity")
    assert treg.get_image_canonicalization_network(ident.canonicalization,
                                                   (32, 32, 3)) is None
    assert isinstance(treg.get_image_canonicalizer(ident.canonicalization, None,
                                                   (32, 32, 3)),
                      tp.IdentityCanonicalization)


@pytest.mark.parametrize("architecture,item", [
    ("maskrcnn", "item 15"),
])
def test_registry_names_the_roadmap_item_of_what_is_not_ported(architecture, item):
    """ViT is ported (item 14) and the detection model (item 15): the
    registry builds both, and an unknown key still raises."""
    cfg = _cfg("prediction.architecture=vit")
    vit = treg.get_image_prediction_network(cfg.prediction, 10, True, device="cpu",
                                            image_size=32)
    assert type(vit).__name__ == "ViT" and vit(torch.zeros(1, 32, 32, 3)).shape == (1, 10)
    det = treg.get_segmentation_prediction_network(architecture, 64, num_classes=3,
                                                   device="cpu", channels=16)
    assert type(det).__name__ == "MaskRCNNLite" and det.num_classes == 3
    with torch.no_grad():
        assert det(torch.zeros(1, 64, 64, 3))["pred_masks"].shape == (1, 8, 64, 64)
    with pytest.raises(ValueError, match="not implemented"):
        treg.get_segmentation_prediction_network("unet", 64, device="cpu")


@pytest.mark.parametrize("network_type,cls", [
    ("equivariant_wrn", "EquivariantWideResNet"),
    ("custom", "CustomEquivariantNetwork"),
])
def test_registry_builds_the_energy_networks_of_item_10(network_type, cls):
    """The two GCNN energy networks that raised until item 10 build, and map
    NHWC images to (B, |G|) activations."""
    cfg = _cfg(f"canonicalization.network_type={network_type}")
    net = treg.get_image_canonicalization_network(cfg.canonicalization,
                                                  (32, 32, 3), device="cpu")
    assert type(net).__name__ == cls
    G = cfg.canonicalization.network_hyperparams.num_rotations
    assert net(torch.zeros(2, 16, 16, 3)).shape == (2, G)


def _pipelines(cfg, seed):
    """(JAX pipeline, its variables, the port's) from one config: the
    config's canonicalizer and ResNet-18 (10 classes, CIFAR stem)."""
    in_shape = (32, 32, 3)
    c = cfg.canonicalization
    jc = jconfig.Config.from_dict(cfg.to_dict()).canonicalization
    jpipe = jcls.ImageClassifierPipeline(
        canonicalizer=jreg.get_image_canonicalizer(
            jc, jreg.get_image_canonicalization_network(jc, in_shape), in_shape),
        prediction_network=jreg.get_image_prediction_network(
            jconfig.PredictionConfig(architecture="resnet18"), 10, True))
    variables = random_variables(jpipe, jnp.zeros((2,) + in_shape), seed=seed)
    tpipe = tcls.ImageClassifierPipeline(
        treg.get_image_canonicalizer(
            c, treg.get_image_canonicalization_network(c, in_shape, device="cpu"),
            in_shape, device="cpu"),
        treg.get_image_prediction_network(
            tconfig.PredictionConfig(architecture="resnet18"), 10, True,
            device="cpu"))
    tp.load_flax_variables(tpipe, variables).eval()
    return jpipe, variables, tpipe


def _state(jpipe, variables):
    return jcls.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"], opt_state=None,
                           tx=optax.identity(), apply_fn=jpipe.apply)


def _batch(seed, b=4):
    rng = np.random.default_rng(seed)
    return {"image": (2.0 * rng.normal(size=(b, 32, 32, 3))).astype(np.float32),
            "label": rng.integers(0, 10, size=b).astype(np.int32)}


@pytest.mark.parametrize("argv,loss_kw", [
    ((), dict(prior_weight=100.0)),
    (("canonicalization=opt_group_equivariant",
      "canonicalization.network_hyperparams.num_rotations=4"),
     dict(prior_weight=100.0, group_contrast_weight=0.3,
          canonicalization_type="opt_group_equivariant")),
], ids=["default_c4", "opt_d4"])
def test_pipeline_loss_and_eval_step_match_jax(argv, loss_kw):
    jpipe, variables, tpipe = _pipelines(_cfg(*argv), seed=3)
    batch = _batch(4)
    jlogits, jinf = jpipe.apply(variables, jnp.asarray(batch["image"]))
    _, ref = jcls.classification_loss(jlogits, jnp.asarray(batch["label"]), jinf,
                                      **loss_kw)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        tlogits, _ = tpipe(tbatch["image"])
    jl = np.asarray(jlogits)
    np.testing.assert_allclose(tlogits.numpy(), jl, rtol=0, atol=1e-4 * np.abs(jl).max())
    ours = tcls.make_eval_step(loss_kw)(tpipe, tbatch)
    assert ours.keys() == ref.keys()
    if "opt_group_equivariant" in loss_kw.values():
        assert "loss/group_contrast" in ours
    for key in ref:
        assert ours[key].item() == pytest.approx(float(ref[key]), rel=1e-5, abs=1e-7), key


@pytest.mark.parametrize("num_rotations,group_type", [
    (4, "rotation"), (8, "rotation"), (4, "roto-reflection")])
def test_group_and_vanilla_inference_match_jax(num_rotations, group_type):
    jpipe, variables, tpipe = _pipelines(_cfg(), seed=5)
    batch = _batch(6)
    state = _state(jpipe, variables)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    ref = jcls.group_inference(state, batch, num_rotations=num_rotations,
                               group_type=group_type)
    ours = tcls.group_inference(tpipe, tbatch, num_rotations=num_rotations,
                                group_type=group_type)
    G = num_rotations * (2 if group_type == "roto-reflection" else 1)
    assert ours.keys() == ref.keys() and f"test/acc_element_{G - 1}" in ours
    for key in ref:
        assert ours[key].item() == pytest.approx(float(ref[key]), abs=1e-6), key
    ref = jcls.vanilla_inference(state, batch, 10)
    ours = tcls.vanilla_inference(tpipe, tbatch, 10)
    assert ours["test/acc"].item() == pytest.approx(float(ref["test/acc"]), abs=1e-6)
    np.testing.assert_allclose(ours["test/per_class_acc"].numpy(),
                               np.asarray(ref["test/per_class_acc"]), atol=1e-6)
    # the sweep's element 0 is the batch itself
    assert ours["test/acc"].item() == pytest.approx(
        tcls.group_inference(tpipe, tbatch, num_rotations=num_rotations,
                             group_type=group_type)["test/acc"].item())


def test_pipeline_guards():
    canon = tp.IdentityCanonicalization()
    net = torch.nn.Identity()
    # remat is ported: it recomputes the prediction network in training
    pipe = tcls.ImageClassifierPipeline(canon, net, remat=True)
    assert pipe.remat and torch.equal(pipe(torch.ones(2, 4, 4, 3))[0],
                                      torch.ones(2, 4, 4, 3))
    logits = torch.randn(4, 10)
    labels = torch.zeros(4, dtype=torch.int64)
    # the opt_steerable branch adds steerable_optimization_loss (ported with
    # the continuous family's training)
    rep = torch.eye(2).repeat(4, 1, 1)
    info = tp.ContinuousCanonicalizationInfo(
        matrix_rep=rep, element=None,
        extras={"matrix_rep_augmented": rep + 0.5, "matrix_rep_augmented_gt": rep})
    _, metrics = tcls.classification_loss(
        logits, labels, info, prior_weight=0.0, group_contrast_weight=2.0,
        canonicalization_type="opt_steerable")
    assert metrics["loss/group_contrast"].item() == pytest.approx(0.25)
    assert metrics["loss/total"].item() == pytest.approx(
        metrics["loss/task"].item() + 0.5)
    loss, metrics = tcls.classification_loss(logits, labels,
                                             tp.IdentityCanonicalizationInfo())
    assert "loss/prior" not in metrics and metrics["loss/finite"].item() == 1.0
    assert loss.item() == pytest.approx(
        torch.nn.functional.cross_entropy(logits, labels).item())
