"""K4's launch paths (`csrc/orbit.cu`) on the CPU.

The CUDA kernel runs only on the card; what the host can describe of it is
checked here:
* `_orbit_path` ("word", "tile" or "chunk") by C, dtype and alignment;
* what `_launch` hands the library (a stub): the dtype code, the shapes, the
  element table packed three bits an element, the path code, and the
  counts by dtype and by path;
* the kernel's index maps, replayed in Python on the bit patterns of the
  input and held against the plain version `rot90_flip_orbit_plain` bit for
  bit (it is pure data movement, so it runs on integer tensors; NaN
  payloads and -0.0 included): the tile paths' map of each 32 x 32 input
  tile onto its output tile under (k, f), ragged edge tiles included, with
  the hflip folded into the output column map (one affine offset
  off + u du + v dv from the turn of three pixels), and the word path's
  inverse turn of each input pixel, column mirrored for a flip.
"""

import types

import numpy as np
import pytest
import torch

from equiadapt_tpu_torch.ops.kernels import _build
from equiadapt_tpu_torch.ops.kernels import orbit as torbit
from torch_port_cpu import one_intra_op_thread  # noqa: F401

TILE = 32
BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
# (num_rotations, reflections) of each G
ORBITS = {1: (1, False), 2: (2, False), 4: (4, False), 8: (4, True)}


def _with_payloads(x):
    """A NaN carrying a payload first and a -0.0 last in every image."""
    x.view(BITS[x.dtype]).flatten(1)[:, 0] = (
        0x7FC00123 if x.element_size() == 4 else 0x7FC3)
    x.flatten(1)[:, -1] = -0.0
    return x


# ------------------------------------------------------------ launch path


@pytest.mark.parametrize("C", [1, 2, 3, 4, 5, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_orbit_path_follows_channels_dtype_and_alignment(dtype, C):
    x = torch.zeros(2, 7, 7, C, dtype=dtype)
    out = torch.empty((4,) + tuple(x.shape), dtype=dtype)
    whole = (C * x.element_size()) % 16 == 0
    tile = "tile" if C <= 4 else "chunk"
    assert torbit._orbit_path(x, out) == ("word" if whole else tile)
    view = torch.zeros(x.numel() + 1, dtype=dtype)[1:].view(x.shape)
    assert view.data_ptr() % 16 != 0
    assert torbit._orbit_path(view, out) == tile
    out_view = torch.zeros(out.numel() + 1, dtype=dtype)[1:].view(out.shape)
    assert torbit._orbit_path(x, out_view) == tile


class _Recorder:
    """A stand-in for a ctypes function: records its arguments, returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def stub_lib(monkeypatch):
    lib = types.SimpleNamespace(eqt_rot90_flip_orbit=_Recorder())
    monkeypatch.setattr(torbit, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    torbit.reset_launches()
    yield lib
    torbit.reset_launches()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_hands_over_path_table_and_shapes(stub_lib, dtype):
    B, N = 3, 9
    words = 16 // (4 if dtype == torch.float32 else 2)
    ks, flips = torbit._elements(4, True, -1.0)
    cases = []
    for C in (3, 5, words):
        x = torch.zeros(B, N, N, C, dtype=dtype)
        cases.append((x, "word" if C == words else ("tile" if C <= 4 else "chunk")))
    # the misaligned view of whole-word pixels takes a tile path
    view = torch.zeros(B * N * N * words + 1, dtype=dtype)[1:].view(B, N, N, words)
    cases.append((view, "tile" if words <= 4 else "chunk"))
    for x, path in cases:
        out = torbit._launch(x, ks, flips)
        args = stub_lib.eqt_rot90_flip_orbit.calls[-1]
        code, xp, op, b, n, c, g, table, path_code, stream = args
        assert code == _build.DTYPE_CODES[dtype]
        assert (xp, op) == (x.data_ptr(), out.data_ptr())
        assert (b, n, c, g) == (B, N, x.shape[-1], 8)
        assert path_code == {"tile": 0, "word": 1, "chunk": 2}[path]
        assert out.shape == (8, B, N, N, x.shape[-1]) and out.dtype == dtype
        for e in range(8):
            assert (table >> (3 * e)) & 3 == ks[e]
            assert bool((table >> (3 * e + 2)) & 1) == flips[e]
        assert table >> 24 == 0
    tag = str(dtype).removeprefix("torch.")
    assert torbit.launches == {f"rot90_flip_orbit/{tag}": 4}
    want = {}
    for _, path in cases:
        key = f"rot90_flip_orbit/{tag}/{path}"
        want[key] = want.get(key, 0) + 1
    assert torbit.path_launches == want
    assert len(want) == 3


def test_launch_rejects_what_the_kernel_does_not_take(stub_lib):
    ks, flips = torbit._elements(4, False, 1.0)
    with pytest.raises(TypeError):
        torbit._launch(torch.zeros(2, 4, 4, 3, dtype=torch.float16), ks, flips)
    with pytest.raises(ValueError):
        torbit._launch(torch.zeros(torbit.MAX_B + 1, 1, 1, 1), ks, flips)
    assert stub_lib.eqt_rot90_flip_orbit.calls == []


# ------------------------------------------------------- index-map replay


def _turn(k, n, ii, jj):
    """quarter_turn.cuh's `quarter_turn`: the source pixel of pixel (ii, jj)
    of rot90^k of an n x n image."""
    if k == 0:
        return ii, jj
    if k == 1:
        return jj, n - 1 - ii
    if k == 2:
        return n - 1 - ii, n - 1 - jj
    return n - 1 - jj, ii


def _tile_map(k, flip, n, r0, c0, h, w, pitch, pixel):
    """orbit.cu's `TileMap`: the output tile (oi0, oj0, oh, ow) of the input
    tile at (r0, c0) of h x w pixels, and the affine shared-memory offset
    (off, du, dv) of its pixels' sources."""
    oi0, oj0, oh, ow = {
        0: (r0, c0, h, w), 1: (n - c0 - w, r0, w, h),
        2: (n - r0 - h, n - c0 - w, h, w), 3: (c0, n - r0 - h, w, h)}[k]
    if flip:
        oj0 = n - oj0 - ow

    def at(u, v):
        j = oj0 + v
        si, sj = _turn(k, n, oi0 + u, n - 1 - j if flip else j)
        return (si - r0) * pitch + (sj - c0) * pixel

    off = at(0, 0)
    return oi0, oj0, oh, ow, off, at(1, 0) - off, at(0, 1) - off


def _replay_tile(x, ks, flips, kernel):
    """The tile paths on integer words x (B, N, N, C): stage each input tile
    in a flat buffer of TILE rows, `pitch` elements apart, then write each
    element's output tile through the affine offset. "tile" (C <= 4) stages
    the whole pixel on a (32 + 1) C four-byte-word pitch; "chunk" stages
    16-byte chunks of channels on TileShape's pitch."""
    B, N, _, C = x.shape
    G = len(ks)
    out = np.full((G, B, N, N, C), -1, np.int64)
    if kernel == "tile":
        chunk, pitch = C, (TILE + 1) * C * (4 // x.itemsize)
    else:
        per_word = 16 // x.itemsize  # TileShape<E>::kChannels
        chunk, pitch = min(C, per_word), TILE * per_word + 4 // x.itemsize
    uu, vv = np.meshgrid(np.arange(TILE), np.arange(TILE), indexing="ij")
    for b in range(B):
        for r0 in range(0, N, TILE):
            for c0 in range(0, N, TILE):
                h, w = min(TILE, N - r0), min(TILE, N - c0)
                for ch0 in range(0, C, chunk):
                    cc = min(chunk, C - ch0)
                    tile = np.full(TILE * pitch, -1, np.int64)
                    r, c = uu[:h, :w], vv[:h, :w]
                    for ch in range(cc):
                        tile[r * pitch + c * chunk + ch] = x[b, r0 + r, c0 + c, ch0 + ch]
                    for g in range(G):
                        oi0, oj0, oh, ow, off, du, dv = _tile_map(
                            ks[g], flips[g], N, r0, c0, h, w, pitch, chunk)
                        u, v = uu[:oh, :ow], vv[:oh, :ow]
                        for ch in range(cc):
                            out[g, b, oi0 + u, oj0 + v, ch0 + ch] = (
                                tile[off + u * du + v * dv + ch])
    return out


def _replay_word(x, ks, flips):
    """The word path: every input pixel (a, s) goes to the inverse turn of
    (a, s), its column mirrored for a flip, in each element."""
    B, N, _, C = x.shape
    out = np.full((len(ks), B, N, N, C), -1, np.int64)
    a, s = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    for g, (k, flip) in enumerate(zip(ks, flips)):
        i, j = _turn((4 - k) % 4, N, a, s)
        if flip:
            j = N - 1 - j
        out[g][:, i, j] = x[:, a, s]
    return out


@pytest.mark.parametrize("sign", [-1.0, 1.0])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("C", [1, 2, 3, 4, 5, 16])
@pytest.mark.parametrize("N", [1, 7, 33, 96])
def test_replayed_index_maps_equal_the_plain_version(N, C, G, sign):
    rng = np.random.default_rng(N * 100 + C * 10 + G)
    dtype = torch.bfloat16 if (N + C) % 2 else torch.float32
    x = _with_payloads(torch.from_numpy(
        rng.normal(size=(2, N, N, C)).astype(np.float32)).to(dtype))
    n, refl = ORBITS[G]
    ks, flips = torbit._elements(n, refl, sign)
    words = x.view(BITS[dtype])
    ref = torbit.rot90_flip_orbit_plain(words, n, refl, sign).numpy().astype(np.int64)
    xi = words.numpy()
    # the kernel takes "tile" at C <= 4 and "chunk" otherwise; the chunk
    # kernel's map is checked at every C
    if C <= 4:
        np.testing.assert_array_equal(_replay_tile(xi, ks, flips, "tile"), ref)
    np.testing.assert_array_equal(_replay_tile(xi, ks, flips, "chunk"), ref)
    np.testing.assert_array_equal(_replay_word(xi, ks, flips), ref)
    # the plain version on the floats keeps every word (no arithmetic)
    plain = torbit.rot90_flip_orbit_plain(x, n, refl, sign)
    assert torch.equal(plain.view(BITS[dtype]).to(torch.int64), torch.from_numpy(ref))


def test_tile_map_of_ragged_edge_tiles():
    """Every element maps the ragged corner tile of a 33 x 33 image (1 x 1
    pixel at (32, 32)) and the edge tiles (1 x 32, 32 x 1) onto tiles of the
    transposed or same shape inside the image."""
    n = 33
    for k in range(4):
        for flip in (False, True):
            for r0, c0, h, w in ((32, 32, 1, 1), (32, 0, 1, 32), (0, 32, 32, 1)):
                oi0, oj0, oh, ow, *_ = _tile_map(k, flip, n, r0, c0, h, w, 99, 3)
                assert (oh, ow) == ((h, w) if k % 2 == 0 else (w, h))
                assert 0 <= oi0 and oi0 + oh <= n and 0 <= oj0 and oj0 + ow <= n


@pytest.mark.parametrize("itemsize", [4, 2])
def test_transposed_walk_of_the_c3_tile_is_free_of_bank_conflicts(itemsize):
    """The tile path's row pitch at C = 3, (32 + 1) 3 = 99 four-byte words,
    is odd: a warp's 32 elements of a transposed output row (11 pixels from
    11 consecutive staged rows) lie in distinct 4-byte words of distinct
    banks (bf16: two lanes may share a word, which is a broadcast)."""
    C = 3
    pitch = (TILE + 1) * C * (4 // itemsize)  # elements
    assert (pitch * itemsize // 4) % 2 == 1
    words = {(e // C) * pitch * itemsize // 4 + (e % C) * itemsize // 4
             for e in range(32)}
    assert len({w % 32 for w in words}) == len(words)
