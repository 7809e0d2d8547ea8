"""The port's native batch loader (`native/`) against the JAX package's.

Both packages build the same C++ source (the port its own copy, under
`equiadapt_tpu_torch/_build/`) and read one record file with the same seed:
their batches must be byte-identical, in the same order, over two epochs,
whatever the thread counts, and equal to the plain version
(`read_batch_plain`: the SplitMix64 epoch order in Python, numpy reads).
An epoch covers every record once; a seed fixes the order. Where the JAX
loader falls back to numpy, the port's raises: no compiler, no file.
"""

import time

import numpy as np
import pytest

import equiadapt_tpu.native.loader as jloader
import equiadapt_tpu_torch.native.loader as tloader
from equiadapt_tpu_torch.ops.kernels import _build

RECORDS, BATCH = 64, 16


@pytest.fixture()
def record_file(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {
        "image": rng.normal(size=(RECORDS, 8, 8, 3)).astype(np.float32),
        "label": rng.integers(0, 10, size=(RECORDS,)).astype(np.int32),
        "index": np.arange(RECORDS, dtype=np.int64),
    }
    path = str(tmp_path / "data.bin")
    spec = tloader.write_record_file(path, arrays)
    assert spec == jloader.write_record_file(str(tmp_path / "jax.bin"), arrays)
    assert (tmp_path / "data.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    return path, spec, arrays


def _jax_native_ready():
    """Whether the JAX package's library loads, waiting out a build of it by
    another test process (its `make` writes the library in place)."""
    for _ in range(150):
        if jloader.native_available():
            return True
        time.sleep(0.2)
    return False


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("threads", [(1, 3), (4, 1)])
@pytest.mark.parametrize("shuffle", [True, False])
def test_batches_byte_identical_to_jax_and_plain(record_file, threads, shuffle):
    path, spec, _ = record_file
    assert _jax_native_ready() and tloader.native_available()
    with tloader.NativeBatchLoader(path, spec, BATCH, num_threads=threads[0], seed=7,
                                   shuffle=shuffle) as ours:
        theirs = jloader.NativeBatchLoader(path, spec, BATCH, num_threads=threads[1],
                                           seed=7, shuffle=shuffle)
        assert theirs._handle is not None  # the JAX native path, not its fallback
        for i in range(2 * RECORDS // BATCH):  # two epochs
            got = ours.next()
            _same(got, theirs.next())
            _same(got, tloader.read_batch_plain(path, spec, BATCH, i, seed=7,
                                                shuffle=shuffle))
        theirs.close()


def test_each_epoch_covers_every_record_once(record_file):
    path, spec, arrays = record_file
    with tloader.NativeBatchLoader(path, spec, BATCH, num_threads=2, seed=1) as loader:
        for epoch in range(2):
            seen = []
            for _ in range(RECORDS // BATCH):
                b = loader.next()
                idx = b["index"]
                np.testing.assert_array_equal(b["image"], arrays["image"][idx])
                np.testing.assert_array_equal(b["label"], arrays["label"][idx])
                seen += idx.tolist()
            assert sorted(seen) == list(range(RECORDS)), epoch
            np.testing.assert_array_equal(
                seen, tloader.epoch_order(RECORDS, 1, epoch)[:len(seen)])


def test_order_is_fixed_by_the_seed(record_file):
    path, spec, _ = record_file

    def first_batches(seed, threads):
        with tloader.NativeBatchLoader(path, spec, 8, num_threads=threads, seed=seed) as ld:
            return [ld.next()["index"].tolist() for _ in range(3)]

    assert first_batches(7, 1) == first_batches(7, 3)
    assert first_batches(7, 1) != first_batches(8, 1)
    assert tloader.epoch_order(RECORDS, 7, 0).tolist() != tloader.epoch_order(RECORDS, 7, 1).tolist()


def test_ragged_epoch_wraps_as_the_cpp_loader(tmp_path):
    """10 records in batches of 4: two batches an epoch, the third batch
    starts the next epoch's order."""
    arrays = {"index": np.arange(10, dtype=np.int64)}
    spec = tloader.write_record_file(str(tmp_path / "r.bin"), arrays)
    with tloader.NativeBatchLoader(str(tmp_path / "r.bin"), spec, 4, seed=3) as ld:
        for i in range(5):
            _same(ld.next(), tloader.read_batch_plain(str(tmp_path / "r.bin"), spec, 4, i,
                                                      seed=3))


def test_no_compiler_raises_instead_of_falling_back(record_file, tmp_path, monkeypatch):
    path, spec, _ = record_file
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "empty_build")
    monkeypatch.setattr(tloader, "_lib", None)
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CXX", raising=False)
    assert not tloader.native_available()
    with pytest.raises(RuntimeError, match="compiler"):
        tloader.NativeBatchLoader(path, spec, BATCH)
    assert not (tmp_path / "empty_build").exists() or not any(
        (tmp_path / "empty_build").glob("*.so"))


def test_missing_file_and_bad_arrays_raise(record_file, tmp_path):
    _, spec, _ = record_file
    with pytest.raises(RuntimeError, match="could not open"):
        tloader.NativeBatchLoader(str(tmp_path / "absent.bin"), spec, BATCH)
    with pytest.raises(ValueError, match="leading dimension"):
        tloader.write_record_file(str(tmp_path / "x.bin"),
                                  {"a": np.zeros((4, 2)), "b": np.zeros((5,))})
    loader = tloader.NativeBatchLoader(record_file[0], spec, BATCH)
    loader.close()
    with pytest.raises(RuntimeError, match="closed"):
        loader.next()
