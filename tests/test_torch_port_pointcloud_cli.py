"""The point-cloud CLIs of the port on the CPU (`main(argv, device="cpu")`).

`equiadapt_tpu_torch.cli.pointcloud_train`: BASELINE config 4a's yaml
(DGCNN, 40 classes) with the fused-kNN canonicalizer, cut to 32 points and
batch 4, trained for one epoch (20 synthetic steps) with a checkpoint,
then test mode from it: the printed robustness accuracies equal those of
the trained state on the same batch; `canonicalization=identity`; the
CLI's defaults (PointNet, 8 classes); ModelNet40 HDF5 files the test
writes. `equiadapt_tpu_torch.cli.partseg_train`: one epoch (10 steps of 8
synthetic clouds of 32 points) with a checkpoint, then test mode: the
printed test/miou equals the trained state's on the same batch; the
identity canonicalizer; ShapeNet-Part HDF5 files the test writes. The JAX
CLIs' choices are held: DGCNNPartSeg(k=8, emb_dims=128), batch 8, 10
steps, 4 categories and 8 octant parts, prior weight 1. Every checkpoint
is written under the test's temporary directory.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from equiadapt_tpu_torch.cli import partseg_train as ps
from equiadapt_tpu_torch.cli import pointcloud_train as pc
from torch_port_cpu import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLS_YAML = os.path.join(REPO, "examples", "pointcloud", "classification", "configs",
                        "default.yaml")
SMALL = ["experiment.num_epochs=1", "experiment.batch_size=4",
         "dataset.num_points=32", "canonicalization.network_hyperparams.n_knn=4"]


def run(main, argv):
    """main(argv, device="cpu") and its printout."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv, device="cpu")
    return result, out.getvalue()


@pytest.fixture(scope="module")
def config_4a(tmp_path_factory, one_intra_op_thread):  # noqa: F811
    """One epoch of config 4a's yaml, cut to size, with a checkpoint."""
    ck = tmp_path_factory.mktemp("pc") / "ck"
    state, printed = run(pc.main, [f"config={CLS_YAML}",
                                   "canonicalization=group_equivariant_fused", *SMALL,
                                   f"checkpoint.checkpoint_path={ck}"])
    return ck, state, printed


def test_pointcloud_train_builds_config_4a(config_4a):
    ck, state, printed = config_4a
    assert state.step == pc.SYNTHETIC_STEPS
    model = state.model
    assert type(model.prediction_network).__name__ == "DGCNN"
    assert model.prediction_network.Dense_7.out_features == 40
    assert model.canonicalizer.canonicalization_network.knn_mode == "fused"
    line = printed.strip().splitlines()[-1]
    assert line.startswith("epoch 0: {") and "val z-rot acc=" in line
    assert "'loss/prior'" in line and "'metric/balanced_acc'" in line
    assert sorted(os.listdir(ck)) == ["config.json", "state.pt"]


def test_pointcloud_test_mode_restores_the_trained_state(config_4a):
    ck, state, _ = config_4a
    metrics, printed = run(pc.main, ["experiment.run_mode=test",
                                     f"checkpoint.checkpoint_path={ck}"])
    assert sorted(metrics) == ["test/acc_none", "test/acc_so3", "test/acc_z"]
    assert printed.strip() == str(metrics)
    cfg = pc.compose(["experiment.run_mode=test", f"checkpoint.checkpoint_path={ck}"])
    assert cfg.prediction.architecture == "DGCNN" and cfg.dataset.num_points == 32
    batch = pc.val_batch(cfg, None, 40, "cpu")
    assert metrics == pc.robustness_eval(state.model, batch, 40, cfg.experiment.seed,
                                         "cpu")


def test_pointcloud_identity_and_defaults(tmp_path):
    """canonicalization=identity trains and tests with no prior term; with
    no yaml the JAX CLI's defaults (PointNet, 8 classes)."""
    ck = tmp_path / "identity"
    state, printed = run(pc.main, [f"config={CLS_YAML}", "canonicalization=identity",
                                   *SMALL, f"checkpoint.checkpoint_path={ck}"])
    assert "'loss/prior'" not in printed
    metrics, _ = run(pc.main, ["experiment.run_mode=test",
                               f"checkpoint.checkpoint_path={ck}"])
    assert all(0.0 <= v <= 1.0 for v in metrics.values())
    state, _ = run(pc.main, SMALL)
    assert type(state.model.prediction_network).__name__ == "PointNet"
    assert state.model.prediction_network.Dense_6.out_features == 8


def _write_h5(path, **arrays):
    import h5py

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with h5py.File(path, "w") as f:
        for k, v in arrays.items():
            f.create_dataset(k, data=v)


def test_pointcloud_train_on_modelnet_files(tmp_path):
    """ModelNet40 HDF5 files: the classes are the data's, an epoch is the
    split's whole batches, the test batch the test split's first."""
    rng = np.random.default_rng(0)
    root = tmp_path / "modelnet40_ply_hdf5_2048"
    labels = {}
    for name, n in (("ply_data_train0.h5", 10), ("ply_data_test0.h5", 6)):
        labels[name] = rng.integers(0, 6, (n, 1)).astype(np.uint8)
        _write_h5(str(root / name), data=rng.normal(size=(n, 40, 3)).astype(np.float32),
                  label=labels[name])
    ck = tmp_path / "ck"
    args = [f"dataset.data_path={tmp_path}", "dataset.dataset_name=modelnet40",
            "dataset.num_points=32",
            "experiment.batch_size=4", "experiment.num_epochs=1",
            f"checkpoint.checkpoint_path={ck}"]
    state, _ = run(pc.main, args)
    assert state.step == 2  # 10 clouds, batches of 4
    classes = int(labels["ply_data_train0.h5"].max()) + 1
    assert state.model.prediction_network.Dense_6.out_features == classes
    metrics, _ = run(pc.main, ["experiment.run_mode=test",
                               f"checkpoint.checkpoint_path={ck}"])
    assert sorted(metrics) == ["test/acc_none", "test/acc_so3", "test/acc_z"]


@pytest.fixture(scope="module")
def partseg(tmp_path_factory, one_intra_op_thread):  # noqa: F811
    ck = tmp_path_factory.mktemp("ps") / "ck"
    state, printed = run(ps.main, ["experiment.num_epochs=1", "dataset.num_points=32",
                                   "canonicalization.network_hyperparams.n_knn=4",
                                   f"checkpoint.checkpoint_path={ck}"])
    return ck, state, printed


def test_partseg_train_keeps_the_jax_cli_choices(partseg):
    ck, state, printed = partseg
    assert state.step == ps.STEPS_PER_EPOCH == 10
    net = state.model.prediction_network
    assert (net.k, net.Dense_5.out_features, net.Dense_10.out_features,
            net.Dense_6.in_features) == (8, 128, 8, 4)
    line = printed.strip().splitlines()[-1]
    assert line.startswith("epoch 0: {'loss/total'") and "val miou=" in line
    cfg = ps.compose([])
    batch = ps.get_batch(cfg, 0, None, 4, "cpu")
    assert batch["points"].shape == (8, 256, 3)  # min(2048, 256) points
    octant = ((batch["points"][..., 0] > 0).long() * 4
              + (batch["points"][..., 1] > 0).long() * 2 + (batch["points"][..., 2] > 0).long())
    assert torch.equal(batch["part_label"], octant)
    assert int(batch["category"].max()) < 4


def test_partseg_test_mode_restores_the_trained_state(partseg):
    ck, state, _ = partseg
    args = ["experiment.run_mode=test", f"checkpoint.checkpoint_path={ck}"]
    metrics, printed = run(ps.main, args)
    assert printed.strip() == str(metrics)
    cfg = ps.compose(args)
    ref = ps.eval_step(state.model, ps.get_batch(cfg, ps.TEST_FOLD, None, 4, "cpu"), 4, 8)
    assert metrics == ref and 0.0 <= metrics["test/miou"] <= 1.0


def test_partseg_identity_and_shapenet_files(tmp_path):
    """The identity canonicalizer; ShapeNet-Part HDF5 files give the part
    and category counts."""
    ck = tmp_path / "identity"
    run(ps.main, ["experiment.num_epochs=1", "dataset.num_points=32",
                  "canonicalization=identity", f"checkpoint.checkpoint_path={ck}"])
    metrics, _ = run(ps.main, ["experiment.run_mode=test",
                               f"checkpoint.checkpoint_path={ck}"])
    assert sorted(metrics) == ["test/acc", "test/miou"]
    rng = np.random.default_rng(1)
    root = tmp_path / "data" / "shapenet_part_seg_hdf5_data"
    for split, n in (("train", 6), ("test", 3)):
        _write_h5(str(root / f"ply_data_{split}0.h5"),
                  data=rng.normal(size=(n, 40, 3)).astype(np.float32),
                  label=np.arange(n).reshape(n, 1).astype(np.uint8) % 5,
                  pid=rng.integers(0, 7, (n, 40)).astype(np.uint8))
    ck = tmp_path / "shapenet"
    state, _ = run(ps.main, ["experiment.num_epochs=1", "dataset.num_points=32",
                             f"dataset.data_path={tmp_path / 'data'}",
                             "canonicalization.network_hyperparams.n_knn=4",
                             f"checkpoint.checkpoint_path={ck}"])
    net = state.model.prediction_network
    assert net.Dense_10.out_features == 7 and net.Dense_6.in_features == 5
    metrics, _ = run(ps.main, ["experiment.run_mode=test",
                               f"checkpoint.checkpoint_path={ck}"])
    assert 0.0 <= metrics["test/miou"] <= 1.0
