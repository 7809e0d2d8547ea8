"""The port's tutorials (`equiadapt_tpu_torch.tutorials`) on the CPU at tiny
sizes (16 px, batch 8, 3 steps; `multichip_scaling` over 2 gloo ranks),
each under a deadline, each asserting the property it demonstrates.

`understanding_discrete_canonicalization` is also held against the JAX
tutorial's steps: the same numpy image's quarter turns and JAX-initialised
weights (`utils.jax_weights`) give identical selected elements and
canonical images within 1e-5 (each seed checked first for a top-2 margin
of the activations over 1e-5, a hundred times their fp32 difference).
"""

import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equiadapt_tpu.images import (
    EquivariantNetwork as JNet,
    GroupEquivariantImageCanonicalization as JCanon,
)
import equiadapt_tpu_torch as tp
from equiadapt_tpu_torch.tutorials import (
    classification_group_equivariant_canonicalization as t_cls,
    instance_segmentation_group_equivariant_canonicalization as t_seg,
    multichip_scaling as t_multi,
    nbody as t_nbody,
    understanding_discrete_canonicalization as t_discrete,
)
from torch_port_cpu import one_intra_op_thread  # noqa: F401

DEADLINE = 120  # seconds a tutorial may take here
TINY = dict(device="cpu", size=16)


@pytest.fixture(autouse=True)
def deadline():
    """Each test fails with TimeoutError past DEADLINE seconds."""
    def expire(signum, frame):
        raise TimeoutError(f"tutorial past its {DEADLINE} s deadline")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


@pytest.mark.parametrize("seed", [0, 3])
def test_discrete_tutorial_matches_the_jax_steps(seed):
    size = 16
    img = np.random.default_rng(seed).normal(size=(1, size, size, 3)).astype(np.float32)
    copies = jnp.concatenate([jnp.rot90(jnp.asarray(img), k, axes=(1, 2)) for k in range(4)])
    jcanon = JCanon(canonicalization_network=JNet(
        in_channels=3, out_channels=8, kernel_size=3, group_type="rotation",
        num_rotations=4, num_layers=2), in_shape=(size, size, 3), num_rotations=4)
    variables = jax.tree_util.tree_map(np.asarray,
                                       jcanon.init(jax.random.key(seed), copies))
    jx, jinfo = jcanon.apply(variables, copies)
    canon = tp.load_flax_variables(t_discrete.build_canonicalizer(size, "cpu"), variables)
    x_canon, out = t_discrete.run(canon, t_discrete.quarter_turns(torch.from_numpy(img)))
    jsel = np.argmax(np.asarray(jinfo.group_activations), -1)
    top2 = np.sort(np.asarray(jinfo.group_activations), -1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-5  # a margin the two can agree on
    assert out["selected"] == jsel.tolist()
    np.testing.assert_allclose(x_canon.numpy(), np.asarray(jx), rtol=0, atol=1e-5)
    assert out["spread"] < 1e-3 and out["grad_mass"] > 0


def test_discrete_tutorial():
    out = t_discrete.main(**TINY)
    assert sorted(out["shifts"]) == [0, 1, 2, 3]  # each copy a different element
    assert out["spread"] < 1e-3 and out["grad_mass"] > 0


def test_classification_tutorial():
    out = t_cls.main(**TINY, batch=8, steps=3)
    accs = out["element_accs"]
    assert len(accs) == 4 and max(accs) - min(accs) < 1e-6
    assert np.isfinite(out["train"]["loss/total"])


def test_segmentation_tutorial():
    out = t_seg.main(**TINY, batch=8, steps=3)
    assert out["inverted_masks"] == [8, 3, 16, 16] and out["ious"] == [8, 3]
    assert np.isfinite(out["train"]["loss/total"])


def test_nbody_tutorial():
    out = t_nbody.main(device="cpu", batch=8, steps=3)
    assert out["canon_rotation_rel"] < 1e-4
    assert all(np.isfinite(v) for row in ("canon", "identity") for v in out[row].values())


def test_multichip_scaling_tutorial():
    out = t_multi.main(**TINY, world=2, batch=8, timeout=DEADLINE - 10)
    assert out["world"] == 2 and out["backend"] == "gloo" and out["grid"] == [1, 2]
    assert out["gp_equal"] and out["pp_max_abs_err"] < t_multi.PP_BAR
