"""The classification CLIs of the port on the CPU (`main(argv, device="cpu")`).

`equiadapt_tpu_torch.cli.classification_train` at the JAX CLI test's
widths (synthetic 16 px, ResNet-18, 1-layer 4-channel GCNN): train, then
test with the config restored from the checkpoint (vanilla and group
inference); dryrun; crash-resume; the canonized-image grid; auto_tune;
the profile trace; the optimized D8 canonicalizer (BASELINE config 2's
yaml, cut to size) on STL-10 binaries the test writes; pretrained
torchvision weights from a `.pth` the test writes (and the error without
a path); the refusals of what is not ported. `classification_serve`:
fresh weights, a checkpoint of the training CLI (every served tensor
restored), and `--export`, whose artifact loads and answers as the served
pipeline. The CLIs do not fall back to the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

from equiadapt_tpu_torch.cli import classification_serve as serve
from equiadapt_tpu_torch.cli import classification_train as train
from torch_port_cpu import one_intra_op_thread  # noqa: F401

TINY = [
    "dataset.dataset_name=synthetic",
    "dataset.image_size=16",
    "dataset.num_classes=4",
    "experiment.num_epochs=1",
    "experiment.batch_size=8",
    "canonicalization.resize_shape=8",
    "canonicalization.network_hyperparams.out_channels=4",
    "canonicalization.network_hyperparams.num_layers=1",
    "prediction.architecture=resnet18",
]


@pytest.fixture(scope="module")
def trained(tmp_path_factory, one_intra_op_thread):  # noqa: F811
    """One epoch of TINY with a checkpoint: (checkpoint dir, state, printout)."""
    import contextlib
    import io

    ck = tmp_path_factory.mktemp("trained") / "ck"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = train.main(TINY + [f"checkpoint.checkpoint_path={ck}",
                                   "checkpoint.save_canonized_images=true"], device="cpu")
    return ck, state, out.getvalue()


def test_train_then_test_restores_the_config(trained, tmp_path, capsys):
    import shutil

    ck, state, out = trained
    assert "epoch 0:" in out and "val/acc=" in out and state.step == 20
    assert (ck / "config.json").exists() and (ck / "canonized_epoch0.png").exists()
    assert len((ck / "train_log.jsonl").read_text().splitlines()) == 1
    # test mode takes the widths from the checkpoint, not from the defaults
    metrics = train.main(["experiment.run_mode=test", f"checkpoint.checkpoint_path={ck}"],
                         device="cpu")
    assert set(metrics) == {"test/acc", "test/per_class_acc"}
    assert "test/acc" in capsys.readouterr().out
    # the trained state evaluated in process gives the same accuracy
    cfg = train.compose(["experiment.run_mode=test", f"checkpoint.checkpoint_path={ck}"])
    assert metrics == train.run_test(cfg, state, "cpu")
    group_ck = tmp_path / "group"
    shutil.copytree(ck, group_ck)
    saved = json.loads((group_ck / "config.json").read_text())
    saved["experiment"]["inference_method"] = "group"
    (group_ck / "config.json").write_text(json.dumps(saved))
    group = train.main(["experiment.run_mode=test",
                        f"checkpoint.checkpoint_path={group_ck}"], device="cpu")
    assert {"test/group_acc", "test/acc_element_3"} <= set(group)
    assert group["test/acc"] == metrics["test/acc"]  # element 0 is the identity


def test_dryrun(capsys):
    train.main(TINY + ["experiment.run_mode=dryrun"], device="cpu")
    assert "dryrun ok: train loss=" in capsys.readouterr().out


def test_crash_resume(tmp_path, capsys):
    args = TINY + [f"checkpoint.checkpoint_path={tmp_path}/ck", "checkpoint.resume=true"]
    train.main(args, device="cpu")
    capsys.readouterr()
    state = train.main(args + ["experiment.num_epochs=2"], device="cpu")
    out = capsys.readouterr().out
    assert "resumed from epoch 0" in out
    assert "epoch 1:" in out and "epoch 0:" not in out
    assert state.step == 40


def test_auto_tune(capsys):
    """The range test's 60 steps, then a state at the suggested rate (no
    epoch: num_epochs=0)."""
    state = train.main(TINY + ["experiment.run_mode=auto_tune",
                               "experiment.num_epochs=0"], device="cpu")
    out = capsys.readouterr().out
    assert "auto_tune: suggested learning rate" in out and "epoch 0:" not in out
    lr = float(out.split("suggested learning rate ")[1].split()[0])
    assert state.step == 0
    assert state.optimizers[0].param_groups[0]["lr"] == pytest.approx(lr, rel=1e-3)


def test_profile(tmp_path, capsys):
    from equiadapt_tpu_torch.utils.profiling import device_op_attribution

    state = train.main(TINY + ["experiment.profile=true", "experiment.num_epochs=0",
                               f"experiment.profile_dir={tmp_path}/prof"], device="cpu")
    assert state.step == 3  # the profiled steps
    assert "profile trace written to" in capsys.readouterr().out
    names = [name for name, _ in device_op_attribution(str(tmp_path / "prof"))]
    assert "aten::convolution" in names


def _write_stl10(root, n_train=8, n_test=4, seed=0):
    rng = np.random.default_rng(seed)
    d = root / "stl10_binary"
    d.mkdir(parents=True)
    for split, n in (("train", n_train), ("test", n_test)):
        rng.integers(0, 256, n * 3 * 96 * 96, dtype=np.uint8).tofile(d / f"{split}_X.bin")
        rng.integers(1, 11, n, dtype=np.uint8).tofile(d / f"{split}_y.bin")


def test_optimized_d8_on_stl10_binaries(tmp_path, capsys):
    """opt_group_equivariant.yaml (D8, ConvNetwork) with the group-contrast
    loss on STL-10-format binaries: two steps (8 images, batch 4), then test
    mode from the checkpoint."""
    _write_stl10(tmp_path)
    ck = tmp_path / "ck"
    state = train.main([
        "canonicalization=opt_group_equivariant", "dataset.dataset_name=stl10",
        f"dataset.data_path={tmp_path}", "dataset.image_size=96",
        "canonicalization.resize_shape=24",
        "canonicalization.network_hyperparams.out_channels=4",
        "canonicalization.network_hyperparams.out_vector_size=8",
        "experiment.loss.group_contrast_weight=1.0", "experiment.batch_size=4",
        "prediction.architecture=resnet18", f"checkpoint.checkpoint_path={ck}",
    ], device="cpu")
    out = capsys.readouterr().out
    assert "train/loss/group_contrast" in out and state.step == 2
    canon = state.model.canonicalizer
    assert type(canon).__name__ == "OptimizedGroupEquivariantImageCanonicalization"
    assert canon.num_group == 16
    metrics = train.main(["experiment.run_mode=test", f"checkpoint.checkpoint_path={ck}"],
                         device="cpu")
    assert 0.0 <= metrics["test/acc"] <= 1.0


@pytest.mark.parametrize("override,item", [
    ("experiment.num_devices=2", "item 16"),
    ("experiment.num_nodes=2", "item 16"),
])
def test_what_is_not_ported_is_refused(override, item, capfd):
    """Item 16 (`parallel/`) is ported: `num_devices=2` runs a dry run on
    two CPU ranks the CLI starts itself; `num_nodes=2` with no
    coordinator refuses to go on as a partial job, as the JAX CLI does."""
    if override.startswith("experiment.num_devices"):
        assert train.main(TINY + [override, "experiment.run_mode=dryrun"], device="cpu",
                          timeout=240) is None
        out = capfd.readouterr().out  # rank 0 writes to this process's output
        assert "world: 2 ranks" in out and "dryrun ok" in out
    else:
        with pytest.raises(RuntimeError, match="configured for 2"):
            train.main(TINY + [override], device="cpu")


@pytest.fixture(scope="module")
def resnet50_pth(tmp_path_factory):
    """A random torchvision-layout ResNet-50 state dict in a `.pth` file."""
    from equiadapt_tpu_torch.cli.maskrcnn_lite_experiment import random_resnet50_state_dict

    sd = random_resnet50_state_dict(seed=11)
    path = tmp_path_factory.mktemp("pretrained") / "resnet50.pth"
    torch.save(sd, path)
    return path, sd


PRETRAINED = ["prediction.architecture=resnet50", "prediction.pretrained=true",
              "experiment.run_mode=dryrun"]


def test_train_loads_pretrained_weights(resnet50_pth, monkeypatch, capsys):
    """`prediction.pretrained=true` fills the prediction network from the
    file before the first step (the 1000-class head and the CIFAR stem kept
    fresh, as the reference's surgeries); with `freeze_encoder` the step
    leaves its weights as loaded."""
    path, sd = resnet50_pth
    loaded = []
    build = train.build_state

    def spy(*args, **kw):
        state = build(*args, **kw)
        loaded.append({k: v.clone() for k, v in
                       state.model.prediction_network.state_dict().items()})
        return state

    monkeypatch.setattr(train, "build_state", spy)
    args = TINY + PRETRAINED + [f"prediction.pretrained_path={path}"]
    state = train.main(args, device="cpu")
    assert f"loaded pretrained resnet50 weights from {path}" in capsys.readouterr().out
    before = loaded[0]
    assert torch.equal(before["Bottleneck_0.Conv_0.weight"], sd["layer1.0.conv1.weight"])
    assert torch.equal(before["Bottleneck_15.BatchNorm_2.running_var"],
                       sd["layer4.2.bn3.running_var"])
    assert before["Dense_0.weight"].shape == (4, 2048)  # the fresh 4-class head
    frozen = train.main(args + ["prediction.freeze_encoder=true"], device="cpu")
    after = frozen.model.prediction_network.state_dict()
    for key, src in (("Bottleneck_3.Conv_1.weight", "layer2.0.conv2.weight"),
                     ("Bottleneck_7.Conv_3.weight", "layer3.0.downsample.0.weight")):
        assert torch.equal(after[key], sd[src]), key
    moved = state.model.prediction_network.state_dict()["Bottleneck_3.Conv_1.weight"]
    assert not torch.equal(moved, sd["layer2.0.conv2.weight"])  # trained unfrozen


def test_pretrained_without_a_path_is_an_error():
    with pytest.raises(ValueError, match="pretrained_path"):
        train.main(TINY + PRETRAINED, device="cpu")


def test_serve_fresh_weights_and_a_checkpoint(trained, tmp_path, capsys):
    out = serve.main(TINY, device="cpu")
    text = capsys.readouterr().out
    assert "warm-up:" in text and "images/s" in text and out["images_per_s"] > 0
    served = serve.main(TINY + [f"checkpoint.checkpoint_path={trained[0]}"],
                        device="cpu")["pipeline"].state_dict()
    assert "serving checkpoint weights" in capsys.readouterr().out
    # the non-strict restore loaded every tensor of the served pipeline
    ref = trained[1].model.state_dict()
    assert served.keys() == ref.keys()
    assert all(torch.equal(served[k], ref[k]) for k in ref)
    serve.main(TINY + [f"checkpoint.checkpoint_path={tmp_path}/none"], device="cpu")
    assert "no checkpoint found; serving fresh weights" in capsys.readouterr().out
    # --export writes the served forward as a torch.export artifact
    from equiadapt_tpu_torch.utils.export import load_exported

    out = serve.main(TINY + [f"--export={tmp_path}/model.pt2"], device="cpu")
    blob = (tmp_path / "model.pt2").read_bytes()
    assert out["export_bytes"] == len(blob)
    assert f"exported torch.export artifact: {tmp_path}/model.pt2" in capsys.readouterr().out
    x = torch.randn(8, 16, 16, 3)
    with torch.no_grad():
        ref = out["pipeline"](x, training=False)[0]
    assert torch.equal(load_exported(blob)(x), ref)


def test_serving_pipeline_is_fast_and_bf16():
    cfg = train.compose(TINY)
    pipe = serve.build_serving_pipeline(cfg, "cpu")
    assert pipe.canonicalizer.warp_mode == "fast"
    assert pipe.canonicalizer.compute_dtype == torch.bfloat16
    assert pipe.prediction_network.dtype == torch.bfloat16


def test_the_clis_run_on_the_card_by_default():
    """Without device="cpu" the CLIs build on CUDA: with no card they raise
    rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for main in (train.main, serve.main):
        with pytest.raises((RuntimeError, AssertionError)):
            main(TINY)
    assert os.path.isdir(train.CONFIG_DIR)
