"""Start the local ranks of a run: one fresh process per rank.

    results = spawn(fn, world=2, backend="gloo", args=(...), timeout=300)

`fn(rank, world, *args)` runs in each of `world` fresh Python processes,
each already in the process group
(NCCL, one GPU per rank, rank r on GPU r; or gloo on the CPU), rendezvous
through a file in a temporary directory, so concurrent runs never share a
port. `fn` must be a module-level function of a module the parent can
import (the parent's `sys.path` is passed on; a function of a script run
as `__main__` is found by the script's file name). Each rank's return
value comes back pickled through that directory, in rank order.

Rank 0 writes to the parent's standard output and error; the other
ranks' output goes to files, shown when a rank fails. A rank that fails
stops the run: the others are killed and `spawn` raises with its output.
So does the deadline: past `timeout` seconds every rank is killed and
`spawn` raises `TimeoutError`, so a hang in a collective fails instead of
holding the caller. Every collective also times out on its own
(`COLLECTIVE_TIMEOUT`).
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["spawn"]


def _fn_ref(fn: Callable) -> tuple:
    """(module name, qualified name, extra path) that re-imports fn."""
    module = fn.__module__
    extra = []
    if module == "__main__":
        path = os.path.abspath(sys.modules["__main__"].__file__)
        module = os.path.splitext(os.path.basename(path))[0]
        extra.append(os.path.dirname(path))
    return module, fn.__qualname__, extra


def spawn(fn: Callable, world: int, backend: Optional[str] = None,
          args: Sequence[Any] = (), timeout: Optional[float] = 600.0, *,
          threads: Optional[int] = None) -> List[Any]:
    """Run `fn(rank, world, *args)` on `world` new ranks and return their
    results in rank order.

    backend: "nccl" (one GPU a rank; never two ranks on one card) or
    "gloo"; by default NCCL when CUDA is available. `timeout`: the
    deadline in seconds for the whole run (None: none). `threads`: intra-op threads of
    each rank (`torch.set_num_threads`). Each collective times out after
    COLLECTIVE_TIMEOUT."""
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(f"NCCL takes one GPU a rank: {world} ranks, "
                         f"{torch.cuda.device_count()} GPUs")
    module, name, extra = _fn_ref(fn)
    with tempfile.TemporaryDirectory(prefix="eqt_ranks_") as tmp:
        with open(os.path.join(tmp, "spec.pkl"), "wb") as f:
            pickle.dump({"module": module, "name": name, "args": tuple(args),
                         "world": world, "backend": backend, "threads": threads,
                         "init": f"file://{os.path.join(tmp, 'rendezvous')}"}, f)
        env = dict(os.environ)
        paths = extra + [p for p in sys.path if p and os.path.isdir(p)]
        env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(paths))
        env.update(WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
        procs, logs = [], []
        try:
            for r in range(world):
                out = None
                if r > 0:
                    out = open(os.path.join(tmp, f"rank{r}.log"), "w")
                    logs.append(out)
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", _CHILD, tmp, str(r)],
                    env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                    stdout=out, stderr=subprocess.STDOUT if out else None))
            _wait(procs, None if timeout is None else time.monotonic() + timeout, tmp, timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"result{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


# a collective that does not complete in this time raises
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)
# seconds this rank took to join its process group (a spawned rank's)
init_seconds = None

_CHILD = ("import sys; from equiadapt_tpu_torch.parallel.launch import _rank_main; "
          "_rank_main(sys.argv[1], int(sys.argv[2]))")


def _tail(tmp: str, r: int, n: int = 6000) -> str:
    path = os.path.join(tmp, f"rank{r}.log")
    if not os.path.exists(path):
        return "(rank 0's output is this process's)"
    with open(path) as f:
        return f.read()[-n:]


def _wait(procs, deadline: Optional[float], tmp: str, timeout: Optional[float]) -> None:
    while True:
        codes = [p.poll() for p in procs]
        if any(c not in (None, 0) for c in codes):
            # the others fail at their next collective: let them, then
            # report every failed rank
            end = time.monotonic() + 10.0
            while any(p.poll() is None for p in procs) and time.monotonic() < end:
                time.sleep(0.05)
            codes = [p.poll() for p in procs]
            raise RuntimeError("\n".join(
                f"rank {r} of {len(procs)} exited with code {c}:\n{_tail(tmp, r)}"
                for r, c in enumerate(codes) if c not in (None, 0)))
        if all(c == 0 for c in codes):
            return
        if deadline is not None and time.monotonic() > deadline:
            raise TimeoutError(
                f"{len(procs)} ranks still running after {timeout:.0f} s "
                f"(ranks {[r for r, c in enumerate(codes) if c is None]}); killed")
        time.sleep(0.05)


def _rank_main(tmp: str, r: int) -> None:
    with open(os.path.join(tmp, "spec.pkl"), "rb") as f:
        spec = pickle.load(f)
    if spec["threads"]:
        torch.set_num_threads(spec["threads"])
    device = None
    if spec["backend"] == "nccl":
        torch.cuda.set_device(r)
        device = torch.device("cuda", r)
    global init_seconds
    t0 = time.perf_counter()
    dist.init_process_group(
        spec["backend"], init_method=spec["init"], world_size=spec["world"], rank=r,
        timeout=COLLECTIVE_TIMEOUT, device_id=device)
    init_seconds = time.perf_counter() - t0
    try:
        fn = importlib.import_module(spec["module"])
        for part in spec["name"].split("."):
            fn = getattr(fn, part)
        result = fn(r, spec["world"], *spec["args"])
        out = os.path.join(tmp, f"result{r}.pkl")
        with open(out + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(out + ".tmp", out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
