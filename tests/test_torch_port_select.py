"""Port kernels K1 / K2 (plain PyTorch versions) against the JAX Pallas
kernels in interpret mode, on the same numpy sources and indices.

Both kernels are pure data movement, so the bar is bit-identity
(`np.array_equal`). The entry points, which also build the residual
sources, are held to 1e-5 in fast mode (two matrix products whose
summation order may differ between XLA and PyTorch) and to bit-identity in
exact mode (the same static taps summed in the same order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equiadapt_tpu.ops.pallas import select_warp as jsw
from equiadapt_tpu_torch.ops.kernels import select_warp as tsw
from torch_port_cpu import one_intra_op_thread  # noqa: F401

GROUPS = {"C4": (4, False), "C8": (8, False), "D8": (8, True)}


def _tables(n, sign, B, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=B).astype(np.int32)
    residues, src_of, k_of = jsw._c_n_decomposition(n, sign)
    return (len(residues), np.asarray(src_of, np.int32)[idx],
            np.asarray(k_of, np.int32)[idx], idx, rng)


def _sources(rng, S, B, C, H):
    return [rng.normal(size=(B, C, H, H)).astype(np.float32) for _ in range(S)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("C", [3, 16])
def test_k1_plain_bitidentical_to_pallas(group, C):
    n, _ = GROUPS[group]
    S, src, k, _, rng = _tables(n, -1.0, 8, seed=C + n)
    srcs = _sources(rng, S, 8, C, 16)
    ours = tsw.select_planes([_t(s) for s in srcs], _t(src), _t(k)).numpy()
    if S == 1:
        ref = jsw._pallas_select(jnp.asarray(np.stack(srcs)), jnp.asarray(src),
                                 jnp.asarray(k), interpret=True)
        assert np.array_equal(ours, np.asarray(ref))
        return
    for bt in (1, 2):
        ref = jsw._pallas_selectn(
            tuple(jnp.asarray(s) for s in srcs), jnp.asarray(src),
            jnp.asarray(k), interpret=True, bt=bt,
        )
        assert np.array_equal(ours, np.asarray(ref)), bt


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_k2_plain_bitidentical_to_pallas(group):
    n, reflect = GROUPS[group]
    G = 2 * n if reflect else n
    S, src, k, idx, rng = _tables(n, 1.0, 8, seed=G)
    srcs = _sources(rng, max(S, 2), 8, 16, 16)[:S]
    shift = rng.integers(-2 * n, 2 * n, size=8).astype(np.int32)
    refl = rng.integers(0, 2, size=8).astype(np.int32) if reflect else None
    ours = tsw.select_planes_rolled(
        [_t(s) for s in srcs], _t(src), _t(k), _t(shift), G, n,
        refl=None if refl is None else _t(refl),
    ).numpy()
    ref = jsw._pallas_selectn_rolled(
        tuple(jnp.asarray(s) for s in srcs), jnp.asarray(src), jnp.asarray(k),
        jnp.asarray(shift), G, n,
        refl=None if refl is None else jnp.asarray(refl), interpret=True,
    )
    assert np.array_equal(ours, np.asarray(ref))


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("n", [4, 8])
def test_rotate_select_entry_matches_pallas(mode, n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
    idx = rng.integers(0, n, size=8).astype(np.int32)
    ref = np.asarray(jsw.pallas_rotate_select(
        jnp.asarray(x), jnp.asarray(idx), n, -1.0, "border", interpret=True,
        mode=mode,
    ))
    ours = tsw.rotate_select(_t(x), _t(idx), n, -1.0, "border", mode).numpy()
    if mode == "exact":
        assert np.array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("group", ["C8", "D8"])
def test_rotate_roll_select_entry_matches_pallas(mode, group):
    n, reflect = GROUPS[group]
    G = 2 * n if reflect else n
    rng = np.random.default_rng(G)
    x = rng.normal(size=(8, 16, 16, 2 * G)).astype(np.float32)
    idx = rng.integers(0, n, size=8).astype(np.int32)
    refl = rng.integers(0, 2, size=8).astype(np.int32) if reflect else None
    ref = np.asarray(jsw.rotate_roll_select(
        jnp.asarray(x), jnp.asarray(idx), jnp.asarray(idx), n, 1.0, "zeros",
        refl=None if refl is None else jnp.asarray(refl), interpret=True,
        mode=mode,
    ))
    ours = tsw.rotate_roll_select(
        _t(x), _t(idx), _t(idx), n, 1.0, "zeros",
        refl=None if refl is None else _t(refl), mode=mode,
    ).numpy()
    if mode == "exact":
        assert np.array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_c_n_decomposition_matches_jax():
    for n in (1, 2, 4, 6, 8, 12, 16):
        for sign in (-1.0, 1.0):
            assert tsw._c_n_decomposition(n, sign) == jsw._c_n_decomposition(n, sign)


def test_cpu_tensors_do_not_count_as_launches():
    tsw.reset_launches()
    x = torch.zeros(2, 8, 8, 3)
    tsw.rotate_select(x, torch.tensor([1, 3]), 8)
    assert tsw.launches == {}


def test_non_cpu_non_cuda_tensors_raise():
    """Only a CPU tensor takes the plain version: any other device must
    reach the kernel or raise, never fall back."""
    s = torch.zeros(2, 3, 8, 8, device="meta")
    i = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tsw.select_planes([s], i, i)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tsw.select_planes_rolled([s, s], i, i, i, 3, 3)


def test_mixed_devices_raise():
    s = torch.zeros(2, 3, 8, 8)
    i = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tsw.select_planes([s], i, i)


@pytest.mark.parametrize("bad", ["shape", "square", "fiber", "refl"])
def test_wrapper_rejects_bad_arguments(bad):
    s = torch.zeros(2, 16, 8, 8)
    i = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        if bad == "shape":
            tsw.select_planes([s, torch.zeros(2, 16, 8, 9)], i, i)
        elif bad == "square":
            tsw.select_planes([torch.zeros(2, 3, 8, 9)], i, i)
        elif bad == "fiber":
            tsw.select_planes_rolled([s], i, i, i, 6, 6)
        else:
            tsw.select_planes_rolled([s], i, i, i, 8, 8, refl=i)
