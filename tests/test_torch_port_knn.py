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
