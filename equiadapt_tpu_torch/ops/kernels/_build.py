"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` compiles on its own into a shared library with a plain
C interface (no PyTorch headers, so a build takes seconds), under
`equiadapt_tpu_torch/_build/`. The library name carries a hash of the source
and of every header in `csrc/` (`*.cuh`, which the sources include), so an
edited source or header is rebuilt and a stale library is never loaded. The build
runs at first use, in the process that needs the kernel; `build_all` starts
one nvcc per source at once, for a caller that wants every kernel ready.

Nothing here runs when a module is imported, and nothing here is reached for
CPU tensors: `route` sends the wrappers to their plain PyTorch versions
there.

Every wrapper launches through a custom operator registered with
`torch.library` in the namespace `OP_NAMESPACE` (`register_op`, one a
launch function, defined beside it), whose fake implementation gives the
output's shape and dtype without a card. A `torch.export` trace on the card
therefore records the launch as a graph node; the artifact loads wherever
`equiadapt_tpu_torch` is imported, which registers the operators.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, Sequence

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("select_warp", "shear_rotate", "bilinear_warp", "knn", "orbit", "sam_attention",
           "spectral_conv", "roi_align", "nms", "bn_act")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the namespace of the kernels' registered operators (`torch.ops.eqt.*`)
OP_NAMESPACE = "eqt"
_OPS = torch.library.Library(OP_NAMESPACE, "DEF")

# dtype codes of the C interfaces (every csrc/*.cu): 0 = float32, 1 = bfloat16
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# compiler output (ptxas register and shared-memory report) per source, kept
# beside each library (`<library>.log`) and read back when it is built already
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA kernels "
        "are built from source at first use"
    )


def _target(name: str) -> Path:
    """The library path of `csrc/<name>.cu`: its name hashes the source and
    every `csrc/*.cuh` header, in name order."""
    h = hashlib.sha256()
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> None:
    """Compile every named source not built yet, one nvcc each, all started
    together; each library is written under a temporary name and renamed
    when its nvcc succeeds, its compiler output beside it."""
    with _lock:
        jobs = []
        for name in names:
            target = _target(name)
            if target.exists():
                log = target.with_suffix(".log")
                if log.exists():
                    build_logs[name] = log.read_text()
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, proc, tmp, target))
        for name, proc, tmp, target in jobs:
            log, _ = proc.communicate()
            build_logs[name] = log
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
            target.with_suffix(".log").write_text(log)
            os.replace(tmp, target)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]


def register_op(schema: str, launch: Callable, fake: Callable) -> torch._ops.OpOverload:
    """Define `OP_NAMESPACE::<schema>` with `launch` as its kernel on every
    device and `fake` as its fake (and meta) implementation; returns the
    operator. Defined with `torch.library.Library` rather than
    `torch.library.custom_op`, whose Python layers cost about four times
    the host time a call (`tools/op_dispatch_times.py`)."""
    name = schema.split("(")[0]
    _OPS.define(schema)
    _OPS.impl(name, launch, "CompositeExplicitAutograd")
    torch.library.register_fake(f"{OP_NAMESPACE}::{name}", fake, lib=_OPS)
    return getattr(getattr(torch.ops, OP_NAMESPACE), name).default


def whole_words(*tensors) -> bool:
    """True when a pixel (the last dimension) of each tensor is a whole
    number of 16-byte words and each tensor starts on a 16-byte boundary:
    the condition of the kernels' 16-byte-word paths."""
    return all((t.shape[-1] * t.element_size()) % 16 == 0
               and t.data_ptr() % 16 == 0 for t in tensors)


_SHAPES_ONLY = contextvars.ContextVar("shapes_only", default=False)


@contextlib.contextmanager
def shapes_only() -> Iterator[None]:
    """Within the block, a wrapper given meta tensors returns an empty
    result of its kernel's shape (a FLOP count, `utils.flops`: the kernels
    count no operations, as a Pallas call counts none in the JAX package's
    count); outside it, meta tensors raise like any device but the CPU and
    CUDA."""
    token = _SHAPES_ONLY.set(True)
    try:
        yield
    finally:
        _SHAPES_ONLY.reset(token)


def refuse_grad(tensors: Sequence, kernels: str, differentiable: str) -> None:
    """Raise when autograd would need a gradient of a kernel that has no
    backward: grad mode is on and a tensor among `tensors` requires grad
    (a floating or complex one: no other can). The CUDA result would carry
    no `grad_fn`, while the CPU's plain version is differentiable, so the
    two devices would give different gradients without a word.
    `differentiable` names the route that will give the gradient on the
    card."""
    if not torch.is_grad_enabled():
        return
    if any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernels}: no backward on the card, and an input requires grad "
            f"under grad mode; {differentiable}. Call under torch.no_grad() (or "
            f"torch.inference_mode()), detach the inputs, or use CPU tensors, "
            f"whose plain version is differentiable")


def route(tensors: Sequence, kernels: str) -> str:
    """"cpu" (plain version) or "cuda" (kernel) for a wrapper's tensors, or
    "meta" for meta tensors inside `shapes_only()`; anything else (another
    device, or devices mixed) raises."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"} or (types == {"meta"} and _SHAPES_ONLY.get()):
        return types.pop()
    if types == {"cuda"} and len({t.device for t in tensors}) == 1:
        return "cuda"
    raise RuntimeError(
        f"{kernels} take CUDA tensors on one device (or CPU tensors, which "
        f"take the plain version); got {sorted(str(t.device) for t in tensors)}"
    )
