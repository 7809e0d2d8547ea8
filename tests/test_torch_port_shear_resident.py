"""K6's resident path (`csrc/shear_rotate.cu::shear_resident_kernel`) on
the CPU.

The CUDA kernel runs only on the card; what the host can describe of it is
checked here:
* the launch path by shape (`_shear_path`: a plane that fits in shared
  memory is "resident", a larger one takes the three "passes"), the
  shared-memory byte count, the cluster size (`_shear_cluster`) and the
  word flag (`_shear_words`), and what `_launch_shear` hands the library
  (a stub): no scratch on the resident path;
* the kernel's partition, replayed in PyTorch: the pixel walk of a
  cluster's threads (each pixel once), the cluster's rank -> channel map,
  pass 1 while loading, passes 2 and 3 in place, a line at a time, in
  groups of four 32-element chunks (a group's loads before its stores),
  the chunks walked upwards for k >= 0 and downwards for k < 0; the replay
  must be `torch.equal` to the plain version (NaN where the plain version
  is NaN);
* K6's plain version against `shear_rotate_residual(interpret=True)` on
  non-square images, at the bars of `test_torch_port_continuous.py`.
"""

import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equiadapt_tpu.ops.pallas import shear_rotate as jsr
from equiadapt_tpu_torch.ops.kernels import shear_rotate as tsr
from torch_port_cpu import one_intra_op_thread  # noqa: F401

THREADS = 1024  # kResidentThreads


# ------------------------------------------------------- path and launch

@pytest.mark.parametrize("H,W,path", [
    (224, 224, "resident"), (24, 40, "resident"), (240, 240, "resident"),
    (241, 241, "resident"), (242, 242, "passes"), (256, 256, "passes"),
    (1, 58111, "resident"), (1, 58113, "passes"), (58112, 1, "resident"),
    (58113, 1, "passes")])
def test_shear_path_by_shape(H, W, path):
    z = torch.zeros(1, H, W, 1)
    assert tsr._resident_bytes(H, W) == H * (W | 1) * 4
    assert tsr._shear_path(z) == path
    assert (tsr._resident_bytes(H, W) <= tsr.RESIDENT_MAX_BYTES) == (path == "resident")


def test_resident_bytes_main_path():
    # 224 rows of 225 floats: an odd pitch
    assert tsr._resident_bytes(224, 224) == 201600
    assert tsr._resident_bytes(24, 40) == 24 * 41 * 4
    assert tsr._resident_bytes(17, 17) == 17 * 17 * 4


@pytest.mark.parametrize("C,fp32,bf16", [
    (1, 1, 1), (2, 2, 2), (3, 3, 3), (4, 4, 4), (5, 5, 5), (8, 4, 8),
    (9, 3, 3), (12, 4, 6), (16, 4, 8), (11, 1, 1), (13, 1, 1), (24, 4, 8)])
def test_shear_cluster_covers_a_word_or_the_pixel(C, fp32, bf16):
    assert tsr._shear_cluster(C, 4) == fp32
    assert tsr._shear_cluster(C, 2) == bf16


@pytest.mark.parametrize("C", [1, 3, 4, 5, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shear_words_by_cluster_dtype_and_alignment(dtype, C):
    z = torch.zeros(2, 6, 6, C, dtype=dtype)
    out = torch.empty_like(z)
    cs = tsr._shear_cluster(C, z.element_size())
    run = cs * z.element_size()
    whole = run % 16 == 0 and (C * z.element_size()) % 16 == 0
    assert tsr._shear_words(z, out, cs) == whole
    assert whole == ((dtype, C) in {(torch.float32, 4), (torch.float32, 8),
                                    (torch.float32, 16), (torch.bfloat16, 8),
                                    (torch.bfloat16, 16)})
    view = torch.zeros(z.numel() + 1, dtype=dtype)[1:].view(z.shape)
    assert not tsr._shear_words(view, out, cs)
    assert not tsr._shear_words(z, view, cs)


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def stub_lib(monkeypatch):
    lib = types.SimpleNamespace(eqt_shear_rotate_resident=_Recorder(),
                                eqt_shear_rotate_residual=_Recorder())
    monkeypatch.setattr(tsr, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    tsr.reset_launches()
    yield lib
    tsr.reset_launches()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_hands_over_resident_arguments(stub_lib, dtype):
    r = torch.tensor([0.3, -0.5])
    for H, W, C in ((24, 40, 16), (17, 17, 3)):
        z = torch.zeros(2, H, W, C, dtype=dtype)
        tsr._launch_shear(z, r, W // 2, H // 2, "zeros")
        args = stub_lib.eqt_shear_rotate_resident.calls[-1]
        # dtype, z, out, coef, B, H, W, C, cx, cy, zeros, cluster, words, smem, stream
        assert len(args) == 15 and args[0] == (dtype == torch.bfloat16)
        assert args[4:8] == (2, H, W, C) and args[8:11] == (W // 2, H // 2, 1)
        cs = tsr._shear_cluster(C, z.element_size())
        assert args[11] == cs
        assert args[12] == int((cs * z.element_size()) % 16 == 0
                               and (C * z.element_size()) % 16 == 0)
        assert args[13] == H * (W | 1) * 4
    assert stub_lib.eqt_shear_rotate_residual.calls == []
    big = torch.zeros(1, 256, 256, 2, dtype=dtype)
    tsr._launch_shear(big, r[:1], 128, 128, "border")
    assert len(stub_lib.eqt_shear_rotate_residual.calls) == 1
    tag = str(dtype).removeprefix("torch.")
    assert tsr.launches == {f"shear_rotate_residual/{tag}": 3}
    assert tsr.path_launches == {f"shear_rotate_residual/{tag}/resident": 2,
                                 f"shear_rotate_residual/{tag}/passes": 1}


# ------------------------------------------------------ partition replay

@pytest.mark.parametrize("H,W,cs", [(224, 224, 8), (224, 224, 1), (24, 40, 3),
                                    (17, 17, 5), (1, 3000, 1), (300, 7, 2),
                                    (97, 33, 4)])
def test_pixel_walk_visits_each_pixel_once(H, W, cs):
    """The cluster's threads g = rank * 1024 + t walk pixels g, g + nt, ...
    with (h, w) advanced by (nt // W, nt % W) and a carry."""
    nt = cs * THREADS
    g = np.arange(nt)
    h, w = g // W, g % W
    dh, dw = nt // W, nt % W
    seen = np.zeros(H * W, np.int64)
    while True:
        live = h < H
        if not live.any():
            break
        np.add.at(seen, h[live] * W + w[live], 1)
        w = w + dw
        h = h + dh
        carry = w >= W
        w = np.where(carry, w - W, w)
        h = np.where(carry, h + 1, h)
    assert (seen == 1).all()


def _chunk_order(len_, k):
    """`shear_line`'s schedule of a line: [(chunk, inner)] in the order the
    warp runs them, from the kernel's bounds of the inner chunks."""
    chunks = (len_ + 31) >> 5
    lo = 0 if k >= 0 else min((31 - k) >> 5, chunks)
    hi = max(lo, min(chunks, ((len_ - 33 - k) >> 5) + 1 if len_ - 33 - k >= 0 else 0))
    if k >= 0:
        return [(j, True) for j in range(hi)] + [(j, False) for j in range(hi, chunks)]
    return ([(j, False) for j in range(chunks - 1, hi - 1, -1)]
            + [(j, True) for j in range(hi - 1, lo - 1, -1)]
            + [(j, False) for j in range(lo - 1, -1, -1)])


@pytest.mark.parametrize("len_", [1, 17, 31, 32, 33, 97, 224, 241])
def test_inner_chunks_read_only_inside_the_line(len_):
    """Every chunk runs once, upwards for k >= 0 and downwards for k < 0;
    an inner chunk (no clamp) has every tap of its 32 lanes in the line,
    and no chunk reads an element an earlier chunk wrote."""
    chunks = (len_ + 31) >> 5
    for k in range(-(len_ + 1), len_ + 2):
        order = _chunk_order(len_, k)
        js = [j for j, _ in order]
        assert js == (list(range(chunks)) if k >= 0 else list(range(chunks))[::-1])
        written = set()
        for j, inner in order:
            p = np.arange(32) + 32 * j
            taps = np.concatenate([p + k, p + k + 1])
            if inner:
                assert taps.min() >= 0 and taps.max() < len_, (len_, k, j)
            read = set(np.clip(taps, 0, len_ - 1).tolist())
            assert not read & written, (len_, k, j)
            written |= set(p[p < len_].tolist())


def _shift(slope, var, centre, size):
    """f and k of each line, as `shift_of` forms them."""
    d = slope * (var - centre)
    fl = torch.floor(d)
    f = d - fl
    k = torch.where(torch.isfinite(fl), fl, torch.zeros_like(fl))
    return f, k.clamp(-(size + 1), size + 1).long()


def _taps(line_of, src, size, zeros):
    t = line_of(src.clamp(0, size - 1))
    if zeros:
        t = torch.where((src >= 0) & (src < size), t, torch.zeros_like(t))
    return t


def _shear_lines_in_place(lines, f, k, zeros, group):
    """`shear_line` for every line of `lines` (n, len) at once: 32
    elements a chunk, chunks upwards for k >= 0 and downwards for k < 0,
    the loads of a group of chunks before its stores."""
    n, size = lines.shape
    chunks = (size + 31) // 32
    lane = torch.arange(32)
    rows = torch.arange(n)[:, None].expand(n, 32)
    for q0 in range(0, chunks, group):
        stores = []
        for q in range(q0, min(q0 + group, chunks)):
            j = torch.where(k >= 0, q, chunks - 1 - q)
            p = j[:, None] * 32 + lane[None, :]
            t0 = _taps(lambda s: lines.gather(1, s), p + k[:, None], size, zeros)
            t1 = _taps(lambda s: lines.gather(1, s), p + k[:, None] + 1, size, zeros)
            v = (1.0 - f[:, None]) * t0 + f[:, None] * t1
            ok = p < size
            stores.append((rows[ok], p[ok], v[ok]))
        for r, p, v in stores:
            lines[r, p] = v


def _resident_replay(z, r, cx, cy, padding):
    """`shear_resident_kernel` on the CPU: per sample, each cluster of
    `_shear_cluster` channels; rank q's plane is channel c0 + q."""
    B, H, W, C = z.shape
    zeros = padding == "zeros"
    ab = tsr._shear_coefficients(r)
    cs = tsr._shear_cluster(C, z.element_size())
    x = z.float()
    out = torch.empty_like(z)
    rows_h = torch.arange(H, dtype=torch.float32)
    cols_w = torch.arange(W, dtype=torch.float32)
    for b in range(B):
        f1, k1 = _shift(ab[b, 0], rows_h, cy, W)  # x-shear, per row
        f2, k2 = _shift(ab[b, 1], cols_w, cx, H)  # y-shear, per column
        for c0 in range(0, C, cs):
            planes = torch.empty(cs, H, W | 1)  # H rows, an odd pitch
            src = torch.arange(W)[None, :] + k1[:, None]
            for q in range(cs):  # pass 1 while loading: the run to each rank
                img = x[b, :, :, c0 + q]
                t0 = _taps(lambda s: img.gather(1, s), src, W, zeros)
                t1 = _taps(lambda s: img.gather(1, s), src + 1, W, zeros)
                planes[q, :, :W] = (1.0 - f1[:, None]) * t0 + f1[:, None] * t1
            for q in range(cs):
                _shear_lines_in_place(planes[q, :, :W].t(), f2, k2, zeros, 4)
                _shear_lines_in_place(planes[q, :, :W], f1, k1, zeros, 4)
            for q in range(cs):  # the write gathers the run from each rank
                out[b, :, :, c0 + q] = planes[q, :, :W].to(z.dtype)
    return out


@pytest.mark.parametrize("padding", ["border", "zeros"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,C", [(12, 20, 3), (17, 17, 5), (40, 24, 16),
                                   (33, 9, 1), (70, 70, 4)])
def test_resident_replay_equals_plain(H, W, C, dtype, padding):
    gen = torch.Generator().manual_seed(H * W + C)
    B = 4
    z = torch.rand(B, H, W, C, generator=gen).to(dtype)
    r = torch.tensor([float("nan"), -math.pi / 4, 0.61, math.pi / 4])
    cx, cy = float(W // 2), float(H // 2)
    ref = tsr.shear_rotate_residual_plain(z, r, cx, cy, padding)
    got = _resident_replay(z, r, cx, cy, padding)
    assert torch.isnan(ref[0].float()).all() and torch.isnan(got[0].float()).all()
    assert torch.equal(got[1:], ref[1:])


# ------------------------------------------ plain version against Pallas

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padding", ["border", "zeros"])
@pytest.mark.parametrize("H,W", [(12, 20), (24, 40), (21, 9)])
def test_k6_plain_matches_pallas_non_square(H, W, padding, dtype):
    rng = np.random.default_rng(H * W)
    x = rng.uniform(size=(4, H, W, 3)).astype(np.float32)
    r = np.array([-np.pi / 4, -0.3, 0.0, 0.7], np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    tx = torch.from_numpy(x).to(tdt)
    cx, cy = float(W // 2), float(H // 2)
    ours = tsr.shear_rotate_residual(tx, torch.from_numpy(r), cx, cy, padding)
    ref = jsr.shear_rotate_residual(jnp.asarray(x).astype(jdt), jnp.asarray(r),
                                    cx, cy, padding, interpret=True)
    tol = 1e-5 if dtype == "float32" else 4e-3
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref).astype(np.float32), rtol=0, atol=tol)
    assert torch.equal(ours[2], tx[2])  # r = 0 is the identity
