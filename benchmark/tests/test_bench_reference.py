"""The plain references agree with the program's plain path (its CPU
versions of the kernels) at a tiny size, in fp32: the energies or frame
vectors, the selected element, the canonical image, the logits and one
training step."""

import copy

import pytest
import torch

from benchmark.harness import cell as cells
from benchmark.harness import data, program, train
from benchmark.reference.common import fp32_only

SEED = 2 ** 33 + 5


def tiny(name, batch=3):
    c = cells.resolve(name)
    s = copy.deepcopy(c.config["settings"])
    s["dataset"]["image_size"] = 32
    s["canonicalization"]["resize_shape"] = 32 if "so2" in name else 16
    s["canonicalization"]["compute_dtype"] = None
    s["canonicalization"]["output_dtype"] = None
    s["prediction"]["dtype"] = None
    if "so2" in name:
        s["canonicalization"]["network_hyperparams"]["out_channels"] = 4
    return c, s, batch


def rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    fp32_only()
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["c8-resnet50.serve", "so2-resnet50.serve"])
def test_serve_agrees(name):
    c, s, B = tiny(name)
    ref = c.reference()
    w = data.make_weights(ref.param_spec(s), SEED, "cpu")
    pipe = program.build_pipeline(s, "train", "cpu")
    data.load_weights(pipe, w)
    x, _ = data.pool_batch(SEED, 0, B, 32, s["dataset"]["num_classes"], "cpu")
    with torch.no_grad():
        logits, info = pipe(x, training=False)
        x_canon, _ = pipe.canonicalize(x)
        out = ref.serve(w, x, s)
    el = program.element(info)
    if "c8" in name:
        assert rel(info.group_activations, out["energies"]) < 1e-4
        assert torch.equal(el, out["element"])
    else:
        assert rel(el, out["element"]) < 1e-4
    gaps = ref.element_gaps(out, el, program.energies(info))
    assert max(gaps.values()) < 1e-4, gaps
    assert rel(x_canon, out["canonical"]) < 1e-5
    assert rel(logits, out["logits"]) < 1e-4


def test_train_step_agrees():
    c, s, B = tiny("c8-resnet50.train", batch=6)
    ref = c.reference()
    cfg = dict(c.config, settings=s)
    pipe = program.build_pipeline(s, "train", "cpu")
    data.load_weights(pipe, data.make_weights(ref.param_spec(s), SEED, "cpu"))
    state = program.train_state(pipe, cfg["optimizer"])
    step = program.train_step(s)
    x, y = data.pool_batch(SEED, 0, B, 32, s["dataset"]["num_classes"], "cpu")
    gen = data.generator(SEED, "steps", "cpu")
    _, m = step(state, {"image": x, "label": y}, gen)
    names = {id(p): n for n, p in pipe.named_parameters()}
    grads = {}
    for opt in state.optimizers:
        for p in opt.param_groups[0]["params"]:
            grads[names[id(p)]] = opt.state[p]["exp_avg"] / 0.1
    w0 = data.make_weights(ref.param_spec(s), SEED, "cpu")
    prog = {"losses": [float(m["loss/total"])], "grad": train._norms(grads),
            "update": train._norms({k: p.detach() - w0[k] for k, p in pipe.named_parameters()})}
    reference = train.follow(ref, cfg, SEED, "cpu", [(x, y)], 1)
    nums = train.numbers(prog, reference)
    assert nums["loss_gap"] < 1e-5, nums
    # the late BatchNorms of a 32 px batch of 6 normalize over 6 values each,
    # which amplifies fp32 rounding of the two orders of summation
    assert nums["grad_gap"] < 2e-2, nums
    assert nums["update_gap"] < 1e-3, nums
