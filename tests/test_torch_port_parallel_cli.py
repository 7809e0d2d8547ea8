"""The classification CLI on more than one device, on the CPU: in a world
of two gloo ranks (`parallel.launch.spawn`, one intra-op thread each) it
trains one epoch of synthetic data with the global batch split over them
and rank 0 writing the checkpoint, then tests from it; the metrics equal
the one-process run's on the same seed within 1e-5 (each rank draws the
same global batch and keeps its slice, BatchNorm takes the global batch's
statistics). `experiment.num_devices=2` in a single process starts the
two ranks itself (the dry run's step equals one process's).
`experiment.num_nodes=2` without a coordinator raises the
`expected_processes` error, as the JAX CLI does.
"""

import json
import os

import pytest

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
DEADLINE = 300


def _train_then_test(ck, devices):
    """One epoch with a checkpoint in `ck`, then test mode from it: (the
    last training log row, the test metrics). In a process group (a rank
    of `_ranks`) the CLI runs data-parallel over it."""
    args = TINY + [f"experiment.num_devices={devices}", "experiment.inference_method=group"]
    train.main(args + [f"checkpoint.checkpoint_path={ck}"], device="cpu")
    with open(os.path.join(ck, "train_log.jsonl")) as f:
        logged = json.loads(f.read().splitlines()[-1])
    metrics = train.main(["experiment.run_mode=test", f"checkpoint.checkpoint_path={ck}"],
                         device="cpu")
    return logged, metrics


def _ranks(rank, world, ck):
    return _train_then_test(ck, world)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-process run, and both CLI runs of a world of 2 in one
    spawn (the CLI's own spawning is timed by the tests below)."""
    import equiadapt_tpu_torch.parallel as par

    root = tmp_path_factory.mktemp("cli")
    one = _train_then_test(str(root / "ck1"), 1)
    two = par.spawn(_ranks, 2, "gloo", args=(str(root / "ck2"),), timeout=DEADLINE,
                    threads=1)
    return {1: one, 2: two[0]}


def test_two_devices_train_then_test_as_one(runs):
    """The test metrics of the two checkpoints agree within 1e-5. (The
    epoch's mean training loss is finite in both but not compared: twenty
    AdamW steps carry the rounding of the two-rank BatchNorm sums into
    updates of lr * sign(g) where g is rounding noise, and the two
    trajectories drift apart; one step is compared below.)"""
    (log1, m1), (log2, m2) = runs[1], runs[2]
    assert m2 is not None and set(m2) == set(m1)
    for key, value in m1.items():
        assert m2[key] == pytest.approx(value, abs=1e-5), key
    assert set(log1) == set(log2)
    assert all(v == v and abs(v) < 1e6 for k, v in log2.items() if k.startswith("train/"))


def test_two_devices_take_the_one_process_step(capfd):
    """A dry run (one train step, one eval batch) on two ranks prints the
    one-process run's losses: the global batch's loss and metrics."""
    lines = {}
    for n in (1, 2):
        train.main(TINY + [f"experiment.num_devices={n}", "experiment.run_mode=dryrun"],
                   device="cpu", timeout=DEADLINE)
        out = capfd.readouterr().out
        (line,) = [ln for ln in out.splitlines() if ln.startswith("dryrun ok")]
        lines[n] = [float(w.split("=")[1]) for w in line.split() if "=" in w]
    assert lines[2] == pytest.approx(lines[1], rel=1e-5)


def test_two_devices_write_one_checkpoint(runs, tmp_path_factory):
    """Rank 0 wrote the checkpoint, with the world in its config, and test
    mode restored it (into two ranks again)."""
    root = tmp_path_factory.getbasetemp()
    cks = [p for p in root.rglob("ck2") if p.is_dir()]
    assert cks, list(root.iterdir())
    with open(cks[0] / "config.json") as f:
        assert json.load(f)["experiment"]["num_devices"] == 2
    assert (cks[0] / "state.pt").is_file()
    assert not list(cks[0].glob("*.tmp"))


def test_num_nodes_without_a_coordinator_raises(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="configured for 2"):
        train.main(TINY + ["experiment.num_nodes=2"], device="cpu")


def test_world_is_capped_by_the_visible_devices(capfd, monkeypatch):
    """num_devices above the visible devices takes what there is, printed
    (here: one CPU core visible, so one process and no ranks)."""
    monkeypatch.setattr(train.os, "cpu_count", lambda: 1)
    state = train.main(TINY + ["experiment.num_devices=4", "experiment.run_mode=dryrun"],
                       device="cpu")
    out = capfd.readouterr().out
    assert "world: 1 ranks (experiment.num_devices=4, 1 visible)" in out
    assert "dryrun ok" in out and state.step == 1
