"""Port kernel K8 (the plain version of the fused kNN) against the JAX
package's `knn_indices` in its three modes, on the same numpy points.

The JAX side runs "exact" (`lax.top_k`), "fused" (the Pallas kernel in
interpret mode, as `tests/test_pointcloud.py` runs it) and "approx"
(`lax.approx_max_k`, exact off a TPU). Bar: identical int32 indices,
nearest first, self first. Each seed is checked first for a margin: the
float64 squared distances of the first k + 1 neighbours of every point lie
more than 1e-5 apart (relative), so an fp32 rounding difference between
the two packages cannot reorder them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equiadapt_tpu.pointcloud.networks import knn_indices as j_knn
from equiadapt_tpu_torch.ops.kernels import knn as tknn
from equiadapt_tpu_torch.pointcloud import networks as tnet
from torch_port_cpu import one_intra_op_thread  # noqa: F401


def knn_margin(points: np.ndarray, k: int, order: bool = True) -> float:
    """The smallest relative gap between the float64 squared distances of
    each point's first k + 1 neighbours. With `order=False`, only the gap
    between the k-th and the (k+1)-th: the neighbour set is then
    unambiguous, its order not."""
    p = np.asarray(points, np.float64)
    N = p.shape[1]
    if k >= N:
        return np.inf
    d = ((p[:, :, None, :] - p[:, None, :, :]) ** 2).sum(-1)
    d = np.sort(d, axis=-1)[..., : k + 1]
    gaps = np.diff(d, axis=-1) if order else d[..., k:] - d[..., k - 1:k]
    return float((gaps / np.maximum(d[..., 1:] if order else d[..., k:],
                                    1e-30)).min())


def _points(B, N, D, seed):
    return np.random.default_rng(seed).normal(size=(B, N, D)).astype(np.float32)


def points_with_margin(B, N, D, k, seed, margin=1e-5):
    """Gaussian points from the first seed at or after `seed` whose kNN
    order has a relative margin above `margin`."""
    for s in range(seed, seed + 20):
        x = _points(B, N, D, s)
        if knn_margin(x, k) > margin:
            return x
    raise AssertionError("no seed with a kNN margin")


SHAPES = [(D, N, k) for D in (3, 4, 32, 64) for N in (6, 100, 256)
          for k in (1, 4, 8) if k <= N]


@pytest.mark.parametrize("mode", ["exact", "fused", "approx"])
@pytest.mark.parametrize("D,N,k", SHAPES)
def test_plain_knn_matches_jax(D, N, k, mode):
    x = points_with_margin(2, N, D, k, seed=D * 1000 + N)
    ours = tknn.knn_indices(torch.from_numpy(x), k)
    assert ours.dtype == torch.int32 and ours.shape == (2, N, k)
    ref = np.asarray(j_knn(jnp.asarray(x), k, mode=mode))
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_array_equal(ours[..., 0].numpy(),
                                  np.broadcast_to(np.arange(N), (2, N)))


def test_modes_and_bf16_and_contiguity():
    """Every mode computes one function; bf16 points are widened to fp32
    first; a strided view gives the same indices as its copy."""
    x = torch.from_numpy(_points(2, 40, 3, seed=5))
    ref = tknn.knn_indices(x, 6)
    for mode in ("exact", "fused", "approx"):
        assert torch.equal(tnet.knn_indices(x, 6, mode=mode), ref)
    with pytest.raises(ValueError, match="knn mode"):
        tnet.knn_indices(x, 6, mode="sorted")
    xb = x.to(torch.bfloat16)
    assert torch.equal(tknn.knn_indices(xb, 6), tknn.knn_indices(xb.float(), 6))
    wide = torch.from_numpy(_points(2, 40, 8, seed=6))
    assert torch.equal(tnet.knn_indices(wide[..., ::2], 6),
                       tknn.knn_indices(wide[..., ::2].contiguous(), 6))


def test_ties_go_to_the_first_occurrence():
    """Duplicated points tie exactly (distance 0): the smaller index comes
    first, as `lax.top_k` orders them."""
    x = _points(1, 12, 3, seed=7)
    x[0, 9] = x[0, 2]
    x[0, 11] = x[0, 2]
    ours = tknn.knn_indices(torch.from_numpy(x), 4).numpy()
    assert list(ours[0, 2, :3]) == [2, 9, 11]
    assert list(ours[0, 11, :3]) == [2, 9, 11]
    np.testing.assert_array_equal(ours, np.asarray(j_knn(jnp.asarray(x), 4)))


def test_nan_point_keeps_indices_in_range():
    """A NaN point makes its row and its column NaN; NaN counts as the
    largest value (torch.argmax's rule), so every index stays in [0, N) and
    the other clouds do not change."""
    x = _points(3, 50, 3, seed=8)
    clean = tknn.knn_indices(torch.from_numpy(x), 8)
    x[1, 17] = np.nan
    got = tknn.knn_indices(torch.from_numpy(x), 8)
    assert int(got.min()) >= 0 and int(got.max()) < 50
    assert torch.equal(got[[0, 2]], clean[[0, 2]])
    assert list(got[1, 17].tolist()) == list(range(8))  # all NaN: in order
    others = [n for n in range(50) if n != 17]
    assert bool((got[1, others, 0] == 17).all())  # the NaN column first


def test_plain_knn_launches_nothing_on_cpu():
    tknn.reset_launches()
    tknn.knn_indices(torch.zeros(1, 8, 3), 2)
    tknn.knn_indices(torch.zeros(1, 8, 64), 2)
    assert tknn.launches == {}


def test_non_cpu_non_cuda_tensors_raise():
    """Only a CPU tensor takes the plain version: any other device reaches
    the kernel or raises."""
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        tknn.knn_indices(torch.zeros(2, 8, 3, device="meta"), 4)


@pytest.mark.parametrize("bad", ["rank", "k0", "k_over_n"])
def test_wrapper_rejects_bad_arguments(bad):
    with pytest.raises(ValueError):
        if bad == "rank":
            tknn.knn_indices(torch.zeros(8, 3), 2)
        elif bad == "k0":
            tknn.knn_indices(torch.zeros(1, 8, 3), 0)
        else:
            tknn.knn_indices(torch.zeros(1, 8, 3), 9)


@pytest.mark.parametrize("shape,k,error", [
    ((1, tknn.MAX_N + 1, 3), 4, ValueError),
    ((1, 64, tknn.MAX_D + 1), 4, ValueError),
    ((1, 256, 3), tknn.MAX_K + 1, ValueError),
    ((1, 64, 3), 4, TypeError),  # float64
])
def test_kernel_limits_are_checked_before_launch(shape, k, error):
    dtype = torch.float64 if error is TypeError else torch.float32
    with pytest.raises(error):
        tknn._launch(torch.zeros(shape, dtype=dtype), k)


def _signed_zero_cloud(N, D, seed):
    """Gaussian points whose first rows are zero-padding: +0.0 points and
    points of -0.0 coordinates, interleaved. A zero query then meets
    distances of +0.0 (a +0.0 point) and -0.0 (a -0.0 point), which must tie
    and go by index."""
    x = _points(2, N, D, seed)
    x[:, 0:12:2] = 0.0
    x[:, 1:12:2] = -0.0
    x[1, 20:24] = -0.0
    return x


@pytest.mark.parametrize("D", [1, 2, 3, 4])
def test_signed_zero_padding_matches_jax(D):
    """Against the JAX fused kernel (interpret mode), whose rounds of argmax
    tie -0.0 with +0.0 as the port does: equal indices. Off a TPU the JAX
    exact mode takes `lax.top_k`, which ranks +0.0 above -0.0, so against it
    each row holds the same indices and only the zero ties may be ordered
    otherwise."""
    x = _signed_zero_cloud(60, D, seed=20 + D)
    assert np.signbit(x[0, 1]).all() and not np.signbit(x[0, 0]).any()
    ours = tknn.knn_indices(torch.from_numpy(x), 16).numpy()
    fused = np.asarray(j_knn(jnp.asarray(x), 16, mode="fused"))
    np.testing.assert_array_equal(ours, fused)
    exact = np.asarray(j_knn(jnp.asarray(x), 16, mode="exact"))
    np.testing.assert_array_equal(np.sort(ours, -1), np.sort(exact, -1))
    zero = (x == 0).all(-1)  # (B, N) zero points
    rows = ~zero  # a nonzero query has no zero-distance tie but itself
    np.testing.assert_array_equal(ours[rows], exact[rows])
    # a zero query's first picks are the zero points in index order
    assert list(ours[0, 3, :6].tolist()) == [0, 1, 2, 3, 4, 5]


@pytest.mark.parametrize("D,N", [(3, 20), (4, 33), (2, 7)])
def test_k_equal_to_n_matches_jax(D, N):
    x = _points(2, N, D, seed=30 + N)
    ours = tknn.knn_indices(torch.from_numpy(x), N)
    ref = np.asarray(j_knn(jnp.asarray(x), N, mode="exact"))
    np.testing.assert_array_equal(ours.numpy(), ref)
    # every row is a permutation of the cloud
    assert bool((torch.sort(ours, dim=-1).values == torch.arange(N)).all())


@pytest.mark.parametrize("D", [3, 4])
def test_k_at_the_kernel_limit_matches_jax(D):
    x = _points(1, tknn.MAX_K + 40, D, seed=40 + D)
    ours = tknn.knn_indices(torch.from_numpy(x), tknn.MAX_K)
    ref = np.asarray(j_knn(jnp.asarray(x), tknn.MAX_K, mode="exact"))
    assert ours.shape == (1, tknn.MAX_K + 40, tknn.MAX_K)
    np.testing.assert_array_equal(ours.numpy(), ref)


def _hard_rows(seed, n=48):
    """fp32 rows (6, n) with ties, +-0.0, +-inf and NaNs of several
    payloads; rows 4 and 5 hold fewer finite entries than the k asked."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(6, n)).astype(np.float32)
    d[:, 5:9] = 0.0
    d[:, 9:13] = -0.0
    d[0, 13:20] = d[0, 2]  # a run of ties
    d[1, ::7] = np.inf
    d[1, 3::11] = -np.inf
    bits = d.view(np.uint32)
    bits[2, 4] = 0x7FC00123  # quiet NaN with a payload
    bits[2, 30] = 0xFFC00001  # negative NaN
    bits[2, 17] = 0x7F800001  # signalling-NaN pattern
    d[3] = np.round(d[3] * 2) / 2  # a coarse grid: many ties
    d[4] = -np.inf
    d[4, [3, 40, 41]] = [1.0, np.nan, -0.0]
    d[5] = -np.inf
    return torch.from_numpy(d)


@pytest.mark.parametrize("k", [1, 5, 20, 48])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_order_key_selection_matches_argmax_rounds(seed, k):
    """The kernel's selection rule, modelled in PyTorch: sorting by the
    packed order key gives the argmax rounds' picks, ties and signed zeros
    by index, every NaN payload above +inf, and index 0 once every entry
    above -inf is spent."""
    d = _hard_rows(seed)
    got = tknn.select_by_order_key(d, k)
    ref = tknn.argmax_rounds(d.clone(), k)
    assert torch.equal(got, ref)
    if k >= 4:
        assert got[4, :4].tolist() == [40, 3, 41, 0]
        assert got[5].tolist() == [0] * k


def test_order_key_is_monotone_and_folds_signed_zero_and_nan():
    v = torch.tensor([-np.inf, -1e30, -1.0, -1e-45, -0.0, 0.0, 1e-45, 1.0,
                      np.inf, np.nan], dtype=torch.float32)
    u = tknn.order_key(v)
    assert bool((u[1:4] > u[:3]).all()) and u[4] == u[5]
    assert bool((u[6:] > u[5:-1]).all())
    assert int(u[0]) == 0x007FFFFF and int(u[-1]) == 0xFFFFFFFF
    payloads = torch.tensor([0x7FC00123, -0x003FFFFF, 0x7F800001],
                            dtype=torch.int32).view(torch.float32)
    assert bool((tknn.order_key(payloads) == 0xFFFFFFFF).all())


@pytest.mark.parametrize("D", [3, 64])
def test_plain_version_equals_order_key_model(D):
    x = torch.from_numpy(_points(2, 90, D, seed=50 + D))
    d = tknn._neg_sq_dist(x)
    assert torch.equal(tknn.knn_indices_plain(x, 20),
                       tknn.select_by_order_key(d, 20))
