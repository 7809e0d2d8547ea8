"""The port's segmentation CLI on the CPU (`main(argv, device="cpu")`).

`equiadapt_tpu_torch.cli.segmentation_train` at the JAX CLI's cut
(BASELINE config 5's yaml with `dataset.image_size=128`, the canonicalizer's
out_channels 8, `SAMLite(embed_dim=128, encoder_depth=2, decoder_depth=2,
num_heads=4)`, batches of 4 synthetic images with 4 box prompts): one
epoch of 10 steps with a checkpoint, then test mode from it, whose printed
sweep equals the trained state's on the same batch; the identity
canonicalizer; the config, the module tree and the ignored
`prediction.*` keys as the JAX CLI has them. Every checkpoint is written
under the test's temporary directory; the file runs on one intra-op
thread.
"""

import ast
import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from equiadapt_tpu.models.segmentation import SAMLite as JSAMLite
from equiadapt_tpu.pipelines.segmentation import ImageSegmentationPipeline as JPipe
from equiadapt_tpu.utils import compose_config as jcompose
from equiadapt_tpu.utils import (
    get_image_canonicalization_network as jnet_of,
    get_image_canonicalizer as jcanon_of,
)
from equiadapt_tpu_torch.cli import segmentation_train as seg
from equiadapt_tpu_torch.pipelines.segmentation import segmentation_group_inference
from equiadapt_tpu_torch.utils.jax_weights import flax_placements
from torch_port_cpu import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CONFIGS = os.path.join(REPO, "examples", "images", "segmentation", "configs")
SMALL = ["experiment.num_epochs=1"]


def run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = seg.main(argv, device="cpu")
    return result, out.getvalue()


@pytest.fixture(scope="module")
def trained(tmp_path_factory, one_intra_op_thread):  # noqa: F811
    ck = tmp_path_factory.mktemp("seg") / "ck"
    state, printed = run(SMALL + [f"checkpoint.checkpoint_path={ck}"])
    return ck, state, printed


@pytest.mark.parametrize("config", [[], [f"config={JAX_CONFIGS}/default.yaml"]])
def test_config_matches_the_jax_cli(config):
    """The composed config equals the JAX CLI's (same base, same overrides;
    with and without BASELINE config 5's yaml)."""
    argv = config + ["experiment.num_epochs=2", "experiment.loss.prior_weight=10"]
    ours = seg.compose(argv)
    ref = jcompose(argv, config_dir=JAX_CONFIGS, base=[
        "dataset.image_size=128", "canonicalization.network_hyperparams.out_channels=8"])
    assert ours.to_dict() == ref.to_dict()
    assert ours.experiment.loss.prior_weight == 10.0


def test_pipeline_tree_matches_the_jax_cli():
    """The CLI's default canonicalizer (C4 GCNN, 8 channels after the base)
    and SAMLite(128, 2, 2, 4): every
    Flax leaf of the JAX CLI's pipeline has a torch tensor of its shape
    (torch modules on the meta device, Flax shapes by `jax.eval_shape`);
    `prediction.architecture` and `prediction.freeze_encoder` change
    nothing, as in the JAX CLI."""
    cfg = seg.compose([])
    in_shape = (128, 128, 3)
    jpipe = JPipe(canonicalizer=jcanon_of(cfg.canonicalization,
                                          jnet_of(cfg.canonicalization, in_shape),
                                          in_shape),
                  prediction_network=JSAMLite(embed_dim=128, encoder_depth=2,
                                              decoder_depth=2, num_heads=4))
    targets = {"boxes": jnp.zeros((1, 4, 4)), "masks": jnp.zeros((1, 4, 128, 128)),
               "labels": jnp.ones((1, 4), jnp.int32), "valid": jnp.ones((1, 4))}
    shapes = jax.eval_shape(jpipe.init, jax.random.key(0), jnp.zeros((1, 128, 128, 3)),
                            targets)
    variables = jax.tree_util.tree_map(lambda s: np.lib.stride_tricks.as_strided(
        np.zeros(1, s.dtype), s.shape, (0,) * len(s.shape)), dict(shapes))
    n = len(jax.tree_util.tree_leaves(variables))
    for extra in ([], ["prediction.architecture=sam", "prediction.freeze_encoder=false"]):
        pipe = seg.build_pipeline(seg.compose(extra), "meta")
        assert len(flax_placements(pipe, variables)) == n
        assert pipe.prediction_network.encoder == "lite"
    assert type(pipe.canonicalizer).__name__ == "GroupEquivariantImageCanonicalization"


def test_train_then_test_from_the_checkpoint(trained):
    """One epoch (10 steps), the checkpoint of the best validation
    group mAP, then test mode: the printed sweep equals the trained state's
    on the test batch."""
    ck, state, printed = trained
    assert state.step == 10
    assert sorted(os.listdir(ck)) == ["config.json", "state.pt"]
    lines = printed.strip().splitlines()
    assert lines[0].startswith("epoch 0: ")
    logged = ast.literal_eval(lines[0].removeprefix("epoch 0: "))
    for key in ("loss/focal", "loss/dice", "loss/iou_mse", "loss/prior", "loss/total",
                "metric/mean_iou"):
        assert np.isfinite(logged[key]), key
    assert logged["loss/finite"] == 1.0
    final = ast.literal_eval(lines[-1])
    metrics, test_printed = run(["experiment.run_mode=test",
                                 f"checkpoint.checkpoint_path={ck}"])
    assert ast.literal_eval(test_printed.strip().splitlines()[-1]) == metrics
    keys = {f"test/map_element_{g}" for g in range(4)} | {"test/group_map", "test/map"}
    assert set(metrics) == keys
    cfg = seg.compose(["experiment.run_mode=test", f"checkpoint.checkpoint_path={ck}"])
    assert cfg.canonicalization.network_hyperparams.out_channels == 8  # from the checkpoint
    val = seg.synthetic_coco_batch(seg.generator(cfg.experiment.seed, seg.TEST_STREAM,
                                                 "cpu"), seg.BATCH, image_size=128)
    in_process = segmentation_group_inference(state.model, val, num_rotations=4)
    for k, v in in_process.items():
        assert metrics[k] == float(v) == final[k], k
        assert 0.0 <= metrics[k] <= 1.0


def test_identity_canonicalizer(tmp_path):
    state, printed = run(SMALL + ["canonicalization=identity",
                                  f"checkpoint.checkpoint_path={tmp_path}/ck"])
    logged = ast.literal_eval(printed.splitlines()[0].removeprefix("epoch 0: "))
    assert "loss/prior" not in logged and np.isfinite(logged["loss/total"])
    assert type(state.model.canonicalizer).__name__ == "IdentityCanonicalization"
    metrics, _ = run(["experiment.run_mode=test", f"checkpoint.checkpoint_path={tmp_path}/ck"])
    assert np.isfinite(metrics["test/group_map"])
