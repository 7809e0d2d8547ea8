"""The port's checkpoint and metric harness and its n-body CLI.

* `utils.checkpoint`: a save / restore round trip (module, optimizer,
  step), strict and non-strict restores, `restore_config` of a
  `config.json` written by the JAX package's `save_checkpoint`,
  `AsyncTrainCheckpointer` (resume from the newest step, `max_to_keep`),
  `best_metric_saver` in both modes and `load_prediction_params_from`;
* `utils.metrics`: `MetricLogger`, `EarlyStopping`, `assert_finite_loss`,
  `gradient_watch` and `save_canonized_images` against their JAX
  counterparts on the same inputs (equal results: both compute on the
  host in numpy);
* `cli.nbody_train` on the CPU, as tests/test_example_clis.py drives the
  JAX CLI: one epoch prints a loss, and train-then-test prints `test/mse`,
  equal (1e-6) to the MSE of the trained state on the same test split.
"""

import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equiadapt_tpu.utils import checkpoint as jck
from equiadapt_tpu.utils import config as jcfg
from equiadapt_tpu.utils import metrics as jmet
from equiadapt_tpu_torch.cli import nbody_train as cli
from equiadapt_tpu_torch.models import egnn as tegnn
from equiadapt_tpu_torch.nbody import EuclideanGroupNBody, VNDeepSets
from equiadapt_tpu_torch.pipelines import nbody as tpipe
from equiadapt_tpu_torch.utils import checkpoint as tck
from equiadapt_tpu_torch.utils import config as tcfg
from equiadapt_tpu_torch.utils import metrics as tmet
from torch_port_cpu import one_intra_op_thread  # noqa: F401


def _state(seed=0, hidden=8, canon_hidden=4):
    torch.manual_seed(seed)
    pipe = tpipe.NBodyPipeline(
        EuclideanGroupNBody(VNDeepSets(hidden_dim=canon_hidden, num_layers=2,
                                       canon_feature="pv", device="cpu")),
        tegnn.GNN(hidden_dim=hidden, num_layers=2, device="cpu"))
    return tpipe.create_nbody_state(pipe, 1e-3, 1e-4)


def _batch(seed=1, b=4):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(b, 5, 3, generator=g) for k in ("loc", "vel", "loc_end")} | {
        "charges": torch.randint(0, 2, (b, 5, 1), generator=g).float() * 2 - 1}


def _trained(seed=0, steps=2, **kw):
    state = _state(seed, **kw)
    step = tpipe.make_nbody_train_step()
    for i in range(steps):
        state, _ = step(state, _batch(seed + i))
    return state


def _same(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def _opt_equal(a, b):
    oa, ob = a.optimizers[0].state_dict(), b.optimizers[0].state_dict()
    return all(torch.equal(oa["state"][i][k], ob["state"][i][k])
               for i in oa["state"] for k in oa["state"][i])


# ---- checkpoint ----------------------------------------------------------

def test_save_restore_round_trip(tmp_path):
    trained = _trained()
    cfg = tcfg.Config().override("experiment.seed=3", "prediction.architecture=GNN")
    tck.save_checkpoint(str(tmp_path / "ck"), trained, cfg)
    fresh = _state(seed=5)
    assert not _same(fresh, trained)
    restored = tck.restore_checkpoint(str(tmp_path / "ck"), fresh)
    assert restored is fresh and restored.step == 2
    assert _same(restored, trained) and _opt_equal(restored, trained)
    assert tck.restore_config(str(tmp_path / "ck")) == cfg
    # the restored state trains on exactly as the saved one
    step = tpipe.make_nbody_train_step()
    _, m1 = step(restored, _batch(9))
    _, m2 = step(trained, _batch(9))
    assert m1["loss/task"].item() == m2["loss/task"].item() and _same(restored, trained)


def test_restore_strict_and_non_strict(tmp_path):
    """strict raises on another module tree; strict=False takes the tensors
    of matching name and shape, keeps the rest, and leaves the optimizer and
    step as they were."""
    path = str(tmp_path / "ck")
    tck.save_checkpoint(path, _trained(hidden=8))
    other = _state(seed=7, hidden=6)  # another GNN width, the same canonicalizer
    with pytest.raises(RuntimeError):
        tck.restore_checkpoint(path, other, strict=True)
    other = _state(seed=7, hidden=6)
    before = {k: v.clone() for k, v in other.model.state_dict().items()}
    donor = torch.load(os.path.join(path, "state.pt"), weights_only=True)["model"]
    got = tck.restore_checkpoint(path, other, strict=False)
    assert got.step == 0 and not got.optimizers[0].state_dict()["state"]
    taken = 0
    for k, v in got.model.state_dict().items():
        if k in donor and donor[k].shape == v.shape:
            assert torch.equal(v, donor[k]), k
            taken += 1
        else:
            assert torch.equal(v, before[k]), k
    canon = [k for k in donor if k.startswith("canonicalizer.")]
    assert len(canon) < taken < len(before)  # the canonicalizer and a bias


def test_restore_config_of_a_jax_checkpoint(tmp_path):
    """A config.json the JAX package's `save_checkpoint` wrote reads back
    field for field."""
    jc = jcfg.Config().override(
        "experiment.run_mode=test", "canonicalization.network_hyperparams.canon_feature=pvc",
        "prediction.architecture=Transformer", "experiment.learning_rate=0.002")
    jstate = types.SimpleNamespace(params={"w": jnp.ones(3)}, batch_stats={},
                                   opt_state={"m": jnp.zeros(3)},
                                   step=jnp.zeros((), jnp.int32))
    jck.save_checkpoint(str(tmp_path / "jax"), jstate, jc)
    cfg = tck.restore_config(str(tmp_path / "jax"))
    assert cfg.to_dict() == jc.to_dict()
    assert cfg == tcfg.Config.from_dict(jc.to_dict())
    # and the port's config.json is in the JAX package's format
    tck.save_checkpoint(str(tmp_path / "port"), _state(), cfg)
    with open(tmp_path / "port" / "config.json") as f, \
            open(tmp_path / "jax" / "config.json") as g:
        assert json.load(f) == json.load(g)
    assert jck.restore_config(str(tmp_path / "port")) == jc


def test_async_checkpointer_resume_and_max_to_keep(tmp_path):
    path = str(tmp_path / "run")
    ck = tck.AsyncTrainCheckpointer(path, max_to_keep=2, config=tcfg.Config())
    state = _state()
    step = tpipe.make_nbody_train_step()
    snapshots = {}
    for i in range(1, 6):
        state, _ = step(state, _batch(i))
        ck.save(state.step, state)
        snapshots[state.step] = {k: v.clone() for k, v in state.model.state_dict().items()}
    ck.wait()
    assert sorted(os.listdir(os.path.join(path, "steps"))) == ["4", "5"]
    assert os.path.isfile(os.path.join(path, "config.json"))
    resumed, latest = tck.AsyncTrainCheckpointer(path, max_to_keep=2).restore_latest(
        _state(seed=3))
    assert latest == 5 and resumed.step == 5
    assert all(torch.equal(v, snapshots[5][k]) for k, v in resumed.model.state_dict().items())
    assert _opt_equal(resumed, state)
    ck.close()
    empty = tck.AsyncTrainCheckpointer(str(tmp_path / "none"))
    fresh = _state()
    assert empty.restore_latest(fresh) == (fresh, None)
    empty.close()


@pytest.mark.parametrize("mode,values,saved", [
    ("min", [3.0, 2.0, 2.5, 1.0, 1.0], [True, True, False, True, False]),
    ("max", [0.1, 0.5, 0.4, 0.5, 0.9], [True, True, False, False, True]),
])
def test_best_metric_saver(tmp_path, monkeypatch, mode, values, saved):
    """The same decisions as the JAX saver (its writes stubbed); the
    checkpoint holds the best state's weights."""
    monkeypatch.setattr(jck, "save_checkpoint", lambda *a, **k: None)
    path = str(tmp_path / "best")
    saver, jsaver = tck.best_metric_saver(path, mode=mode), jck.best_metric_saver(path, mode)
    state = _state()
    step = tpipe.make_nbody_train_step()
    best = None
    for v, want in zip(values, saved):
        state, _ = step(state, _batch(int(v * 10)))
        assert saver.maybe_save(v, state) == want == jsaver.maybe_save(v, None)
        if want:
            best = {k: t.clone() for k, t in state.model.state_dict().items()}
    assert saver.best == jsaver.best
    restored = tck.restore_checkpoint(path, _state(seed=4))
    assert all(torch.equal(t, best[k]) for k, t in restored.model.state_dict().items())


def test_load_prediction_params_from(tmp_path):
    """Only the prediction network's tensors come from the donor, whose
    canonicalizer may differ; a prediction network of another shape raises."""
    donor = _trained(seed=1, canon_hidden=6)
    tck.save_checkpoint(str(tmp_path / "donor"), donor)
    state = _state(seed=2, canon_hidden=4)
    canon_before = {k: v.clone() for k, v in state.model.canonicalizer.state_dict().items()}
    tck.load_prediction_params_from(str(tmp_path / "donor"), state)
    dp = donor.model.prediction_network.state_dict()
    assert all(torch.equal(v, dp[k]) for k, v in
               state.model.prediction_network.state_dict().items())
    assert all(torch.equal(v, canon_before[k]) for k, v in
               state.model.canonicalizer.state_dict().items())
    with pytest.raises(ValueError, match="shape mismatch"):
        tck.load_prediction_params_from(str(tmp_path / "donor"), _state(hidden=6))


# ---- metrics -------------------------------------------------------------

def test_metric_logger_matches_jax(tmp_path):
    rows = [{"loss/task": torch.tensor(0.5), "loss/finite": torch.tensor(1.0),
             "vec": torch.ones(3)},
            {"loss/task": np.float32(0.25), "loss/finite": 1.0, "acc": torch.tensor(0.75)},
            {"loss/task": torch.tensor(0.125, dtype=torch.bfloat16)}]
    ours = tmet.MetricLogger(str(tmp_path / "ours" / "log.jsonl"), use_wandb=True)
    ref = jmet.MetricLogger(str(tmp_path / "ref" / "log.jsonl"), use_wandb=True)
    for r in rows:
        ours.update(r)
        ref.update({k: jnp.asarray(v.float().numpy() if isinstance(v, torch.Tensor) else v)
                    for k, v in r.items()})
    assert ours.flush(3, prefix="train/") == ref.flush(3, prefix="train/")
    assert ours.flush(4) == ref.flush(4) == {}

    def read(p):
        with open(p) as f:
            return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]

    assert read(tmp_path / "ours" / "log.jsonl") == read(tmp_path / "ref" / "log.jsonl")


@pytest.mark.parametrize("mode,min_delta", [("max", 0.0), ("min", 0.05)])
def test_early_stopping_matches_jax(mode, min_delta):
    values = [0.5, 0.52, 0.51, 0.49, 0.6, 0.58, 0.58, 0.3, 0.61, 0.2, 0.2, 0.2]
    ours = tmet.EarlyStopping(patience=3, mode=mode, min_delta=min_delta)
    ref = jmet.EarlyStopping(patience=3, mode=mode, min_delta=min_delta)
    assert [ours.update(v) for v in values] == [ref.update(v) for v in values]
    assert (ours.best, ours.bad) == (ref.best, ref.bad)


@pytest.mark.parametrize("flag,raises", [(None, False), (1.0, False), (0.0, True),
                                         ([1.0, 0.0], True), ([1.0, 1.0], False)])
def test_assert_finite_loss_matches_jax(flag, raises):
    for mod, wrap in ((tmet, torch.tensor), (jmet, jnp.asarray)):
        metrics = {} if flag is None else {"loss/finite": wrap(flag)}
        if raises:
            with pytest.raises(FloatingPointError):
                mod.assert_finite_loss(metrics)
        else:
            mod.assert_finite_loss(metrics)


def test_gradient_watch_matches_jax():
    rng = np.random.default_rng(0)
    grads = {"canonicalizer": {"w": (rng.normal(size=(4, 3)) * 1e-3).astype(np.float32),
                               "zero": np.zeros(5, np.float32)},
             "prediction_network": {"Dense_0": {
                 "kernel": rng.normal(size=(6, 2)).astype(np.float32),
                 "bias": np.array([0.0, 1e-14, 3e5], np.float32)}},
             "empty": np.zeros((0,), np.float32)}
    torch_grads = {"canonicalizer": {k: torch.from_numpy(v)
                                     for k, v in grads["canonicalizer"].items()},
                   "prediction_network": {"Dense_0": {
                       k: torch.from_numpy(v)
                       for k, v in grads["prediction_network"]["Dense_0"].items()}},
                   "empty": torch.zeros(0)}
    ref = jmet.gradient_watch({k: _jax_tree(v) for k, v in grads.items()}, max_bins=8)
    assert tmet.gradient_watch(torch_grads, max_bins=8) == ref
    # a module's gradients by parameter name
    state = _state()
    tpipe.make_nbody_train_step()(state, _batch())
    out = tmet.gradient_watch({n: p.grad for n, p in state.model.named_parameters()})
    names = {n for n, p in state.model.named_parameters()}
    assert {k[len("grad/"):-len("/norm")] for k in out if k.endswith("/norm")} == names
    total = sum(float(p.grad.double().square().sum()) for p in state.model.parameters())
    assert out["grad/global_norm"] == pytest.approx(np.sqrt(total), rel=1e-6)


def _jax_tree(v):
    if isinstance(v, dict):
        return {k: _jax_tree(x) for k, x in v.items()}
    return jnp.asarray(v)


def test_save_canonized_images_matches_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(1)
    for c in (1, 3):
        a = rng.normal(size=(10, 6, 5, c)).astype(np.float32)
        b = rng.normal(size=(10, 6, 5, c)).astype(np.float32)
        ours = tmet.save_canonized_images(str(tmp_path / f"o{c}" / "g.png"),
                                          torch.from_numpy(a), torch.from_numpy(b))
        ref = jmet.save_canonized_images(str(tmp_path / f"r{c}.png"), a, b)
        assert np.array_equal(np.asarray(Image.open(ours)), np.asarray(Image.open(ref)))


# ---- the n-body CLI ------------------------------------------------------

def test_nbody_cli(capsys):
    cli.main(["experiment.num_epochs=1", "experiment.batch_size=8",
              "checkpoint.checkpoint_path="], device="cpu")
    out = capsys.readouterr().out
    assert "loss" in out.lower() and "epoch 0:" in out and "val/mse=" in out


def test_nbody_cli_train_then_test(tmp_path, capsys):
    """run_mode=test restores the config and the weights from the checkpoint
    and prints the test MSE, which equals the trained state's on the test
    split (one epoch: the checkpoint is the final state)."""
    ck = f"{tmp_path}/ck"
    state = cli.main(["experiment.num_epochs=1", "experiment.batch_size=8",
                      "canonicalization.network_hyperparams.hidden_dim=8",
                      f"checkpoint.checkpoint_path={ck}"], device="cpu")
    capsys.readouterr()
    out = cli.main(["experiment.run_mode=test", f"checkpoint.checkpoint_path={ck}"],
                   device="cpu")
    printed = capsys.readouterr().out
    assert "test/mse" in printed and str(out["test/mse"]) in printed
    cfg = cli.compose(["experiment.run_mode=test", f"checkpoint.checkpoint_path={ck}"])
    assert cfg.canonicalization.network_hyperparams.hidden_dim == 8
    mse = tpipe.nbody_eval_mse(state.model, cli.dataset_split(cfg, "test", "cpu"))
    assert abs(out["test/mse"] - mse.item()) <= 1e-6 * max(1.0, mse.item())
