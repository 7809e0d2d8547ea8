"""ctypes wrapper of the native threaded batch loader.

Counterpart of `equiadapt_tpu/native/loader.py`. `NativeBatchLoader`
streams shuffled batches of fixed-size records from a memory-mapped binary
file on the C++ worker pool of `csrc/batch_loader.cc`; `write_record_file`
writes numpy arrays in that format. The library is built with the host C++
compiler (`$CXX`, else `g++` on the PATH) at first use, into
`equiadapt_tpu_torch/_build/` under a name carrying a hash of the source,
as `ops/kernels/_build.py` builds the CUDA sources.

One deliberate difference from the JAX package: where the library cannot
be built or loaded, or the file cannot be mapped, the loader raises; it
never falls back to a numpy reader (`native_available()` says whether the
library loads). `epoch_order` and `read_batch_plain` are the plain version
of the loader's order and batches (SplitMix64 Fisher-Yates per epoch, as
the C++ source), which the tests hold the library to byte for byte.

Batches come back as numpy arrays, one per field; hand them to the card
with `torch.from_numpy(...).to(device)`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np

from equiadapt_tpu_torch.ops.kernels import _build

__all__ = ["NativeBatchLoader", "write_record_file", "native_available",
           "epoch_order", "read_batch_plain"]

SOURCE = _build.CSRC_DIR / "batch_loader.cc"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _cxx() -> str:
    name = os.environ.get("CXX", "g++")
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(
            f"host C++ compiler {name!r} not found on the PATH ($CXX names "
            f"another): the native batch loader is built from "
            f"{SOURCE.name} at first use")
    return found


def _target() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return _build.BUILD_DIR / f"libeqt_loader_{digest}.so"


def load_library() -> ctypes.CDLL:
    """The loaded loader library, built first if needed; raises when it
    cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        target = _target()
        if not target.exists():
            target.parent.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"building {SOURCE.name} failed:\n{proc.stderr}")
            os.replace(tmp, target)
        lib = ctypes.CDLL(str(target))
        lib.eqt_loader_create.restype = ctypes.c_void_p
        lib.eqt_loader_create.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong, ctypes.c_int,
        ]
        lib.eqt_loader_next.restype = ctypes.c_long
        lib.eqt_loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.eqt_loader_destroy.restype = None
        lib.eqt_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def native_available() -> bool:
    """Whether the loader library builds (or is built) and loads."""
    try:
        load_library()
    except (RuntimeError, OSError):
        return False
    return True


def write_record_file(path: str, arrays: Dict[str, np.ndarray]) -> Dict:
    """Serialize aligned arrays (one leading dimension) into one record file,
    the fields of a record in name order. Returns the spec a
    `NativeBatchLoader` takes."""
    names = sorted(arrays)
    n = arrays[names[0]].shape[0]
    fields = []
    for k in names:
        a = np.ascontiguousarray(arrays[k])
        if a.shape[0] != n:
            raise ValueError(f"{k}: leading dimension {a.shape[0]}, expected {n}")
        fields.append((k, a.dtype.str, a.shape[1:], a.reshape(n, -1)))
    record = np.concatenate([f[3].view(np.uint8).reshape(n, -1) for f in fields], axis=1)
    record.tofile(path)
    return {
        "num_records": n,
        "record_bytes": record.shape[1],
        "fields": [(k, dt, shp, arr.shape[1] * np.dtype(dt).itemsize)
                   for k, dt, shp, arr in fields],
    }


_MASK = (1 << 64) - 1


def epoch_order(num_records: int, seed: int, epoch: int,
                shuffle: bool = True) -> np.ndarray:
    """The record order of one epoch, as the C++ loader draws it: a
    Fisher-Yates shuffle from the back, j = splitmix64(s) mod (i + 1), the
    state seeded seed + 0x9e3779b9 (epoch + 1)."""
    order = list(range(num_records))
    if shuffle:
        s = (seed + 0x9E3779B9 * (epoch + 1)) & _MASK
        for i in range(num_records - 1, 0, -1):
            s = (s + 0x9E3779B97F4A7C15) & _MASK
            z = ((s ^ (s >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
            z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
            j = (z ^ (z >> 31)) % (i + 1)
            order[i], order[j] = order[j], order[i]
    return np.asarray(order, dtype=np.int64)


def batch_records(spec: Dict, batch_size: int, index: int, seed: int,
                  shuffle: bool = True) -> np.ndarray:
    """The record indices of batch `index` of a loader over `spec`."""
    n = spec["num_records"]
    per_epoch = n // batch_size
    epoch, in_epoch = (index // per_epoch, index % per_epoch) if per_epoch else (0, 0)
    order = epoch_order(n, seed, epoch, shuffle)
    return order[(in_epoch * batch_size + np.arange(batch_size)) % n]


def _split(raw: np.ndarray, spec: Dict, batch_size: int) -> Dict[str, np.ndarray]:
    out = {}
    rec = raw.reshape(batch_size, spec["record_bytes"])
    off = 0
    for name, dt, shp, nbytes in spec["fields"]:
        # a copy: the loader reuses its buffer on the next call
        field = np.array(rec[:, off:off + nbytes], copy=True)
        out[name] = field.view(np.dtype(dt)).reshape((batch_size,) + tuple(shp))
        off += nbytes
    return out


def read_batch_plain(path: str, spec: Dict, batch_size: int, index: int,
                     seed: int = 0, shuffle: bool = True) -> Dict[str, np.ndarray]:
    """Plain version of batch `index` of a `NativeBatchLoader` (numpy
    reads of the records `batch_records` names)."""
    mm = np.memmap(path, np.uint8, "r").reshape(spec["num_records"], spec["record_bytes"])
    recs = batch_records(spec, batch_size, index, seed, shuffle)
    return _split(np.ascontiguousarray(mm[recs]).reshape(-1), spec, batch_size)


class NativeBatchLoader:
    """Shuffled, prefetching batch iterator over a record file; batches come
    in order 0, 1, 2, ... whatever the number of threads, epoch after epoch
    (each epoch has num_records // batch_size batches)."""

    def __init__(self, path: str, spec: Dict, batch_size: int, num_threads: int = 2,
                 prefetch_depth: int = 4, seed: int = 0, shuffle: bool = True):
        self.spec = spec
        self.batch_size = batch_size
        self._handle = None
        self._lib = load_library()
        self._buf = np.empty(batch_size * spec["record_bytes"], np.uint8)
        self._handle = self._lib.eqt_loader_create(
            os.fsencode(path), spec["record_bytes"], spec["num_records"], batch_size,
            num_threads, prefetch_depth, seed, int(shuffle))
        if not self._handle:
            raise RuntimeError(f"the native loader could not open or map {path}")

    def next(self) -> Dict[str, np.ndarray]:
        if self._handle is None:
            raise RuntimeError("the loader is closed")
        rc = self._lib.eqt_loader_next(self._handle,
                                       self._buf.ctypes.data_as(ctypes.c_void_p))
        if rc < 0:
            raise RuntimeError("native loader stopped")
        return _split(self._buf, self.spec, self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()

    def close(self) -> None:
        if self._handle is not None:
            self._lib.eqt_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self) -> "NativeBatchLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()
