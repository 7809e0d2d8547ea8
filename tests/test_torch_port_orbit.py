"""The exact D4 orbit (K4) and `materialize_orbit` against the JAX package.

K4's plain version (the wrapper's CPU route) is held to JAX's
`rot90_flip_orbit(use_pallas=False)`, its `_orbit_xla`: the Pallas kernel
runs only on a TPU, and the JAX tests hold it bit-equal to `_orbit_xla`.
Bars: the quarter-turn orbits bit-equal (compared as integers, so -0.0
counts), fp32 and bf16, with the NaN at the same places; XLA's CPU reverse
of a bf16 array canonicalizes a NaN's payload, so the payload is checked on
the port's side alone (it keeps every bit); the static-warp orbits (C8, D8,
exact and fast) within 1e-5 of inputs of unit scale (fp32 sums of four taps
or two products in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equiadapt_tpu.ops.pallas import orbit as jorbit
from equiadapt_tpu_torch.ops.kernels import orbit as torbit
from torch_port_cpu import one_intra_op_thread  # noqa: F401


def _bits(seed, shape, dtype):
    """Random values with a NaN (with a payload) and a -0.0, as the integer
    bit patterns of `dtype` (float32 or bfloat16)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[3] = -0.0
    bits = x.view(np.uint32).copy()
    bits.reshape(-1)[5] = 0x7FC0_1234  # a quiet NaN with a payload
    if dtype == "float32":
        return bits
    u16 = (bits >> 16).astype(np.uint16)
    u16.reshape(-1)[5] = 0x7FC5  # a bf16 NaN with a payload
    return u16


def _both(bits, dtype):
    """(torch tensor, jax array) holding exactly these bits."""
    if dtype == "float32":
        t = torch.from_numpy(bits.view(np.int32)).view(torch.float32)
        j = jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.float32)
    else:
        t = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
        j = jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.bfloat16)
    return t, j


def _as_int(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16).numpy()


def _jax_int(a):
    itype = jnp.int32 if a.dtype == jnp.float32 else jnp.int16
    return np.asarray(jax.lax.bitcast_convert_type(a, itype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sign", [-1.0, 1.0])
@pytest.mark.parametrize("reflections", [False, True])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_orbit_plain_bit_equal_to_jax(n, reflections, sign, dtype):
    t, j = _both(_bits(n + 10 * reflections, (3, 7, 7, 2), dtype), dtype)
    ours = torbit.rot90_flip_orbit(t, n, reflections=reflections, sign=sign)
    ref = jorbit.rot90_flip_orbit(j, num_rotations=n, reflections=reflections,
                                  use_pallas=False, sign=sign)
    G = n * (2 if reflections else 1)
    assert ours.shape == (G, 3, 7, 7, 2) and ours.dtype == t.dtype
    nan = np.isnan(np.asarray(ref, np.float32))
    assert np.array_equal(torch.isnan(ours.float()).numpy(), nan)
    assert nan.sum() == G
    assert np.array_equal(_as_int(ours)[~nan], _jax_int(ref)[~nan])
    # every output word is an input word: the NaN keeps its payload
    payload = _as_int(t).reshape(-1)[5]
    assert np.all(_as_int(ours)[nan] == payload)


def test_orbit_element_table():
    assert torbit._elements(4, False, -1.0) == ((0, 3, 2, 1), (False,) * 4)
    assert torbit._elements(4, False, 1.0) == ((0, 1, 2, 3), (False,) * 4)
    assert torbit._elements(2, True, -1.0) == ((0, 2, 0, 2),
                                                (False, False, True, True))
    with pytest.raises(ValueError):
        torbit._elements(8, False, -1.0)


def test_orbit_routes_by_device_and_checks_shapes():
    torbit.reset_launches()
    x = torch.randn(2, 5, 5, 3)
    out = torbit.rot90_flip_orbit(x, 4, sign=1.0)
    assert torch.equal(out[1], torch.rot90(x, 1, dims=(1, 2)))
    assert torbit.launches == {}  # a CPU tensor takes the plain version
    with pytest.raises(ValueError):
        torbit.rot90_flip_orbit(torch.zeros(2, 5, 6, 3))  # not square
    with pytest.raises(RuntimeError):
        torbit.rot90_flip_orbit(torch.zeros(2, 5, 5, 3, device="meta"))


@pytest.mark.parametrize("n,group_type,mode", [
    (4, "rotation", "exact"), (4, "roto-reflection", "exact"),
    (2, "roto-reflection", "fast"),
    (8, "rotation", "exact"), (8, "rotation", "fast"),
    (8, "roto-reflection", "exact"), (8, "roto-reflection", "fast"),
])
@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_materialize_orbit_matches_jax(n, group_type, mode, sign):
    x = np.random.default_rng(n).normal(size=(3, 12, 12, 3)).astype(np.float32)
    ref = np.asarray(jorbit.materialize_orbit(
        jnp.asarray(x), n, group_type=group_type, padding_mode="border",
        sign=sign, mode=mode))
    ours = torbit.materialize_orbit(torch.from_numpy(x), n,
                                    group_type=group_type,
                                    padding_mode="border", sign=sign,
                                    mode=mode).numpy()
    G = n * (2 if group_type == "roto-reflection" else 1)
    assert ours.shape == ref.shape == (G * 3, 12, 12, 3)
    if n in (1, 2, 4):
        assert np.array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    # group-major: the first B images are the batch, and (n >= 4) element
    # n / 4 of the rotations is the quarter turn rotate(x, sign * 90)
    assert np.array_equal(ours[:3], x)
    if n >= 4:
        q = n // 4
        want = torch.rot90(torch.from_numpy(x), 1 if sign > 0 else -1, dims=(1, 2))
        np.testing.assert_allclose(ours[3 * q:3 * q + 3], want.numpy(), rtol=0,
                                   atol=1e-6)


def test_materialize_orbit_non_square_takes_the_warps():
    x = np.random.default_rng(1).normal(size=(2, 8, 10, 3)).astype(np.float32)
    ref = np.asarray(jorbit.materialize_orbit(jnp.asarray(x), 4))
    ours = torbit.materialize_orbit(torch.from_numpy(x), 4).numpy()
    assert ours.shape == ref.shape == (8, 8, 10, 3)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
