"""K1 / K2 word path (`csrc/select_warp.cu::select_word_kernel`) on the CPU.

The CUDA kernel runs only on the card; what the host can describe of it is
checked here:
* `_rolled_path` (word or element) by N, dtype and alignment, and the path
  flag and path count `_launch` hands over (a stub library);
* the kernel's address math, replayed in Python on an index plane: the
  float-reciprocal division, the mirrored and reversed words of k = 0, 2,
  and the swizzled 8W x 8W shared-memory tile of k = 1, 3 (ragged tiles
  included); the replayed map applied to the sources must give the words
  of the plain version run on the sources' bit patterns (it is pure data
  movement, so it takes integer tensors), NaN payloads and -0.0 included.
  The plain version on bf16 floats is no reference for payloads on the
  CPU: PyTorch's CPU `torch.gather` (its fiber roll) turns a bf16 NaN
  payload into 0xFFFF;
* K2's plain version against `_pallas_selectn_rolled(interpret=True)` as
  integers: odd N, negative shifts, and NaN payloads and -0.0 in every
  plane. The Pallas kernel permutes by exchange-matrix matmuls, so for
  k != 0 a NaN spreads along its row or column and a -0.0 comes back +0.0:
  there the words must agree wherever the reference is finite and
  nonzero, and every NaN of ours must be NaN there; at k = 0 with no flip
  (no matmul) every word must agree;
* the wrappers' argument checks (integer indices, num_rotations >= 1).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equiadapt_tpu.ops.pallas import select_warp as jsw
from equiadapt_tpu_torch.ops.kernels import select_warp as tsw
from torch_port_cpu import one_intra_op_thread  # noqa: F401

GROUPS = {"C4": (4, False), "D4": (4, True), "C8": (8, False), "D8": (8, True)}
BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _bits(t):
    return t.view(BITS[t.dtype])


def _with_payloads(x):
    """A NaN carrying a payload first and a -0.0 last in every plane."""
    words = _bits(x).flatten(2)
    words[..., 0] = 0x7FC00123 if x.element_size() == 4 else 0x7FC3
    x.flatten(2)[..., -1] = -0.0
    return x


# ------------------------------------------------------------ launch path

@pytest.mark.parametrize("N", [1, 4, 8, 17, 24, 32, 224])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rolled_path_follows_row_bytes_and_alignment(dtype, N):
    s = torch.zeros(2, 3, N, N, dtype=dtype)
    out = torch.empty_like(s)
    whole = (N * s.element_size()) % 16 == 0
    assert tsw._rolled_path([s, s], out) == ("word" if whole else "element")
    view = torch.zeros(s.numel() + 1, dtype=dtype)[1:].view(s.shape)
    assert view.data_ptr() % 16 != 0
    assert tsw._rolled_path([s, view], out) == "element"
    assert tsw._rolled_path([s], view) == "element"


class _Recorder:
    """A stand-in for a ctypes function: records its arguments, returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def stub_lib(monkeypatch):
    lib = types.SimpleNamespace(eqt_select_warp=_Recorder(),
                                eqt_select_warp_nhwc=_Recorder())
    monkeypatch.setattr(tsw, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    tsw.reset_launches()
    yield lib
    tsw.reset_launches()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_hands_over_the_path(stub_lib, dtype):
    B, C, N = 2, 8, 24
    s = torch.zeros(B, C, N, N, dtype=dtype)
    view = torch.zeros(s.numel() + 1, dtype=dtype)[1:].view(s.shape)
    idx = torch.zeros(B, dtype=torch.int32)
    for srcs, path in (([s, s], "word"), ([s, view], "element")):
        tsw._launch("select_planes_rolled", srcs, idx, idx, idx, None, 4, 4)
        args = stub_lib.eqt_select_warp.calls[-1]
        assert args[-2] == int(path == "word")
        assert args[11:16] == (B, C, N, 4, 4)
    tag = str(dtype).removeprefix("torch.")
    assert tsw.launches == {f"select_planes_rolled/{tag}": 2}
    assert tsw.path_launches == {f"select_planes_rolled/{tag}/word": 1,
                                 f"select_planes_rolled/{tag}/element": 1}


# --------------------------------------------------- word-kernel replay

def _divmod_f32(p, d):
    """The kernel's divmod: truncated product with the float reciprocal,
    then one correction."""
    inv = np.float32(1.0) / np.float32(d)
    q = (np.asarray(p, np.float32) * inv).astype(np.int64)  # round toward 0
    r = p - q * d
    q = np.where(r < 0, q - 1, np.where(r >= d, q + 1, q))
    r = np.where(r < 0, r + d, np.where(r >= d, r - d, r))
    return q, r


@pytest.mark.parametrize("d", [1, 2, 3, 7, 28, 56, 1000, 1448])
def test_float_reciprocal_divmod_is_exact(d):
    p = np.arange(min(2**24, 8 * d * d), dtype=np.int64)
    q, r = _divmod_f32(p, d)
    assert np.array_equal(q, p // d) and np.array_equal(r, p % d)


def _word_map(N, W, k, flip):
    """The source element of every output element of one plane, replayed
    through `select_word_kernel`'s address math on an index plane: (N, N)
    flat source indices."""
    NW = N // W
    plane = np.arange(N * N).reshape(N, NW, W)  # words of W elements
    out = np.full((N, NW, W), -1)
    if k % 2 == 0:
        down, rev = k == 2, (k == 2) != flip
        i, wj = _divmod_f32(np.arange(N * NW), NW)
        word = plane[N - 1 - i if down else i, NW - 1 - wj if rev else wj]
        out[i, wj] = word[:, ::-1] if rev else word
        return out.reshape(N, N)
    side = 8 * W
    rev_rows, rev_cols = (k == 3) != flip, k == 1
    tiles = -(-N // side)
    for tt in range(tiles * tiles):
        i0, j0 = (tt // tiles) * side, (tt % tiles) * side
        h, w = min(side, N - i0), min(side, N - j0)
        r0 = N - j0 - w if rev_rows else j0
        c0 = N - i0 - h if rev_cols else i0
        tile = np.full((side * 8, W), -1)  # 8 words a row, swizzled
        for e in range(w * 8):
            r, q = e >> 3, e & 7
            if q * W < h:
                slot = r * 8 + (q ^ ((r // W) & 7))
                assert slot < side * 8
                tile[slot] = plane[r0 + r, c0 // W + q]
        for e in range(h * 8):
            ii, wj = e >> 3, e & 7
            if wj * W >= w:
                continue
            cc = h - 1 - ii if rev_cols else ii
            for q in range(W):
                rr = w - 1 - (wj * W + q) if rev_rows else wj * W + q
                v = tile[rr * 8 + ((cc // W) ^ ((rr // W) & 7)), cc % W]
                assert v >= 0, "read a tile slot this tile did not stage"
                out[i0 + ii, j0 // W + wj, q] = v
    return out.reshape(N, N)


def _replay(sources, src, k_idx, shift, refl, G, n):
    """`select_word_kernel` on the CPU: each (b, c) block's sample
    (`Sample`), then its plane through the replayed map, on raw words."""
    B, C, N, _ = sources[0].shape
    W = 16 // sources[0].element_size()
    bits = [_bits(s) for s in sources]
    out = torch.empty_like(bits[0])
    maps = {}
    for b in range(B):
        s = min(max(int(src[b]), 0), len(sources) - 1)
        k = int(k_idx[b]) & 3
        flip = refl is not None and int(refl[b]) == 1
        if (k, flip) not in maps:
            maps[k, flip] = torch.from_numpy(_word_map(N, W, k, flip))
        for c in range(C):
            cs = c
            if shift is not None:
                p, sh = c % G, int(shift[b])
                q = (p - sh) % n if p < n else n + (p - n + sh) % n
                cs = (c // G) * G + q
            out[b, c] = bits[s][b, cs].flatten()[maps[k, flip]]
    return out


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("dtype,N", [(torch.bfloat16, 8), (torch.bfloat16, 72),
                                     (torch.float32, 4), (torch.float32, 40),
                                     (torch.float32, 64)])
def test_word_kernel_replay_equals_plain(dtype, N, group):
    n, reflect = GROUPS[group]
    G = 2 * n if reflect else n
    gen = torch.Generator().manual_seed(N + G)
    B, S = 8, 2
    srcs = [_with_payloads(torch.randn(B, G, N, N, generator=gen).to(dtype))
            for _ in range(S)]
    src = torch.randint(-1, S + 1, (B,), generator=gen).int()  # clamped
    k = (torch.arange(B) % 4 - 4 * (torch.arange(B) % 3)).int()  # every k, some < 0
    shift = torch.randint(-2 * n, 2 * n, (B,), generator=gen).int()
    refl = (torch.arange(B) // 4 % 2).int() if reflect else None
    words = [_bits(s) for s in srcs]
    ref = tsw.select_planes_plain(words, src, k, shift, refl, G, n)
    assert torch.equal(_replay(srcs, src, k, shift, refl, G, n), ref)
    # K1: no shift, no flip, a fiber of one
    ref = tsw.select_planes_plain(words, src, k)
    assert torch.equal(_replay(srcs, src, k, None, None, 1, 1), ref)


# ------------------------------------------- plain version against Pallas

@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("N", [7, 17])
def test_k2_plain_equals_pallas_as_integers(group, N):
    n, reflect = GROUPS[group]
    G = 2 * n if reflect else n
    rng = np.random.default_rng(N * G)
    B = 8
    residues, src_of, k_of = jsw._c_n_decomposition(n, 1.0)
    idx = np.arange(B) % n  # k = 0 and k != 0 in every group
    src = np.asarray(src_of, np.int32)[idx]
    k = np.asarray(k_of, np.int32)[idx]
    srcs = []
    for _ in residues:
        x = rng.normal(size=(B, 2 * G, N, N)).astype(np.float32)
        x.view(np.int32)[:, :, 0, 0] = 0x7FC00123 + np.arange(2 * G)  # payloads
        x[:, :, -1, -1] = -0.0
        srcs.append(x)
    shift = rng.integers(-3 * n, 0, size=B).astype(np.int32)  # negative
    refl = (np.arange(B) % 2).astype(np.int32) if reflect else None
    ours = tsw.select_planes_rolled(
        [torch.from_numpy(s) for s in srcs], torch.from_numpy(src),
        torch.from_numpy(k), torch.from_numpy(shift), G, n,
        refl=None if refl is None else torch.from_numpy(refl))
    ref = np.asarray(jsw._pallas_selectn_rolled(
        tuple(jnp.asarray(s) for s in srcs), jnp.asarray(src), jnp.asarray(k),
        jnp.asarray(shift), G, n,
        refl=None if refl is None else jnp.asarray(refl), interpret=True))
    ours = ours.numpy()
    k0 = (k % 4 == 0) & (refl == 0 if reflect else True)  # no matmul
    assert k0.any() and not k0.all()
    assert np.array_equal(ours[k0].view(np.int32), ref[k0].view(np.int32))
    exact = ~np.isnan(ref) & (ref != 0)
    assert np.array_equal(ours.view(np.int32)[exact], ref.view(np.int32)[exact])
    assert not (np.isnan(ours) & ~np.isnan(ref)).any()


# ------------------------------------------------------- argument checks

def test_select_wrappers_reject_floating_indices():
    s = torch.zeros(2, 8, 8, 8)
    i = torch.zeros(2, dtype=torch.int32)
    f = torch.zeros(2)
    with pytest.raises(TypeError, match="integer"):
        tsw.select_planes([s], f, i)
    with pytest.raises(TypeError, match="integer"):
        tsw.select_planes_rolled([s], i, i, f, 8, 8)
    with pytest.raises(TypeError, match="integer"):
        tsw.select_planes_nhwc([s], i, torch.zeros(2, dtype=torch.bool))


def test_rolled_select_rejects_no_rotations():
    s = torch.zeros(2, 8, 8, 8)
    i = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="num_rotations"):
        tsw.select_planes_rolled([s], i, i, i, 0, 0)
