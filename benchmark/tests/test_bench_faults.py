"""A run driven to its end on the CPU at a tiny size, past the look for a
card, with the timed path broken underneath: `correct` comes out false for
every fault a cell can have, and true for the sound program. The control
(the reference one precision below the configuration's, in the
program's place) fails too.

Serving runs as configured (bf16, fast warps). Training runs in fp32 here:
at a batch of 4 at 32 px the bf16 step's own gradient gaps are of the
order of the cell's limits, so only fp32 leaves the faults something to
stand out from."""

import copy
import time

import pytest
import torch

from benchmark.harness import cell as cells
from benchmark.harness import check, program

SEED = 3_000_000_019  # over 32 signed bits


def tiny_cell(name, fp32=False):
    c = cells.resolve(name)
    c.config = copy.deepcopy(c.config)
    s = c.config["settings"]
    s["dataset"]["image_size"] = 32
    s["canonicalization"]["resize_shape"] = 32 if "so2" in name else 16
    if "so2" in name:
        s["canonicalization"]["network_hyperparams"]["out_channels"] = 4
    if fp32:
        s["canonicalization"]["compute_dtype"] = None
        s["canonicalization"]["output_dtype"] = None
        s["prediction"]["dtype"] = None
    c.traffic = dict(c.traffic, batch_size=4, pool=4, sample_batches=3,
                     capture_batches=1, capture_within=2, trace_iterations=2)
    return c


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(c, control=False):
    res = c.driver().run(c, SEED, 0.5, False, "cpu", time.perf_counter(), control=control)
    res["correct"] = check.verdict(res["numbers"], c.limits) and res["failed"] == 0
    return res


def broken_build(monkeypatch, hook_on, fn):
    """program.build_pipeline with a forward hook `fn` on the submodule
    `hook_on` of the pipeline it returns."""
    build = program.build_pipeline

    def patched(*args, **kwargs):
        pipe = build(*args, **kwargs)
        pipe.get_submodule(hook_on).register_forward_hook(fn)
        return pipe

    monkeypatch.setattr(program, "build_pipeline", patched)


def alter_logit(_m, _inp, out):
    out = out.clone()
    out[0, 0] += out.abs().max()
    return out


def alter_element(_m, _inp, out):
    x, info = out
    el = info.element
    if hasattr(el, "rotation_deg"):
        el.rotation_deg = el.rotation_deg.clone()
        el.rotation_deg[0] = (el.rotation_deg[0] + 45.0) % 360.0
    else:
        el.rotation = el.rotation.clone()
        el.rotation[0] = el.rotation[0] @ torch.tensor([[0.0, -1.0], [1.0, 0.0]],
                                                       dtype=el.rotation.dtype)
    return x, info


def roll_fiber(_m, _inp, out):
    """The energy network's output shifted by one element of the fiber."""
    return torch.roll(out, 1, dims=-1)


def drop_half(_m, _inp, out):
    x, info = out
    x = x.clone()
    h = x.shape[0] // 2
    x[h:] = x[:h]
    return x, info


SERVE = ["c8-resnet50.serve", "so2-resnet50.serve"]


@pytest.mark.parametrize("name", SERVE)
def test_serve_sound(name):
    assert run(tiny_cell(name))["correct"]


@pytest.mark.parametrize("name", SERVE)
@pytest.mark.parametrize("hook_on,fault", [
    ("prediction_network", alter_logit),
    ("canonicalizer", alter_element),
    ("canonicalizer", drop_half),
], ids=["answer_altered", "element_altered", "half_batch"])
def test_serve_fault(monkeypatch, name, hook_on, fault):
    broken_build(monkeypatch, hook_on, fault)
    assert not run(tiny_cell(name))["correct"]


def test_serve_fiber_rolled(monkeypatch):
    """A wrong but self-consistent energy network: the element is the
    argmax of energies shifted by one element, so the canonical image and
    the logits agree with the reference warping by that element; only
    the reference's own energies judge it."""
    broken_build(monkeypatch, "canonicalizer.canonicalization_network", roll_fiber)
    res = run(tiny_cell("c8-resnet50.serve"))
    assert not res["correct"], res["numbers"]


@pytest.mark.parametrize("name", SERVE)
def test_serve_control_fails(name):
    c = tiny_cell(name)
    ctrl = run(c, control=True)["control"]
    assert not check.verdict(ctrl, c.limits), ctrl


def test_train_sound():
    assert run(tiny_cell("c8-resnet50.train", fp32=True))["correct"]


def test_train_state_unchanged(monkeypatch):
    make = program.train_state

    def frozen(*args, **kwargs):
        state = make(*args, **kwargs)
        for opt in state.optimizers:
            opt.step = lambda *a, **k: None
        return state

    monkeypatch.setattr(program, "train_state", frozen)
    assert not run(tiny_cell("c8-resnet50.train", fp32=True))["correct"]


def test_train_half_batch(monkeypatch):
    make = program.train_step

    def halved(settings):
        step = make(settings)

        def half_step(state, batch, generator=None):
            h = batch["image"].shape[0] // 2
            return step(state, {k: v[:h] for k, v in batch.items()}, generator)
        return half_step

    monkeypatch.setattr(program, "train_step", halved)
    assert not run(tiny_cell("c8-resnet50.train", fp32=True))["correct"]


def test_train_control_fails():
    c = tiny_cell("c8-resnet50.train", fp32=True)
    ctrl = run(c, control=True)["control"]["control"]
    assert not check.verdict(ctrl, c.limits), ctrl


@pytest.mark.card
@pytest.mark.parametrize("name", SERVE + ["c8-resnet50.train"])
def test_control_on_card(card, name):
    """The control at the cell's own size on the card, three seeds."""
    c = cells.resolve(name)
    if torch.cuda.device_count() < c.chips:
        pytest.skip(f"{name} needs {c.chips} cards")
    for seed in (11, 2 ** 31 + 7, 90_000_000_001):
        res = c.driver().run(c, seed, 2.0, False, card, time.perf_counter(), control=True)
        ctrl = res["control"]
        ctrl = ctrl.get("control", ctrl)
        assert check.verdict(res["numbers"], c.limits), res["numbers"]
        assert not check.verdict(ctrl, c.limits), ctrl
