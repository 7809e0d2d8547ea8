#!/usr/bin/env python3
"""Host time of one call through a registered operator, by registration API.

    python3 equiadapt_tpu_torch/tools/op_dispatch_times.py [--calls 20000]

The kernels' wrappers launch through `torch.library` operators
(`ops/kernels/_build.register_op`). This times, on the host clock and on
CPU tensors (no kernel, no card needed), one call of a function that
returns a new tensor, with K1's argument list: called directly, through
an operator defined with `torch.library.Library` (what `register_op`
does) and through one defined with `torch.library.custom_op`. Prints one
JSON line: microseconds a call, the median of 5 runs of `--calls` calls.
"""

from __future__ import annotations

import argparse
import json
import platform
import time
from typing import List, Optional

import torch

Tensor = torch.Tensor


def _body(name, sources, src_idx, k_idx, shift, refl, G, n):
    return torch.empty_like(sources[0])


def _fake(name, sources, src_idx, k_idx, shift, refl, G, n):
    return sources[0].new_empty(sources[0].shape)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--calls", type=int, default=20000)
    args = parser.parse_args()

    lib = torch.library.Library("eqt_dispatch_times", "DEF")
    lib.define("library(str name, Tensor[] sources, Tensor src_idx, Tensor k_idx, "
               "Tensor? shift, Tensor? refl, int G, int n) -> Tensor")
    lib.impl("library", _body, "CompositeExplicitAutograd")
    torch.library.register_fake("eqt_dispatch_times::library", _fake, lib=lib)

    @torch.library.custom_op("eqt_dispatch_times::custom_op", mutates_args=())
    def custom(name: str, sources: List[Tensor], src_idx: Tensor, k_idx: Tensor,
               shift: Optional[Tensor], refl: Optional[Tensor], G: int, n: int) -> Tensor:
        return _body(name, sources, src_idx, k_idx, shift, refl, G, n)

    custom.register_fake(_fake)
    sources = [torch.zeros(2, 3, 4, 4)]
    idx = torch.zeros(2, dtype=torch.int32)
    calls = {"direct": _body, "library": torch.ops.eqt_dispatch_times.library.default,
             "custom_op": custom}
    out = {"host": platform.processor() or platform.machine(), "torch": torch.__version__}
    for key, fn in calls.items():
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(args.calls):
                fn("select_planes", sources, idx, idx, None, None, 1, 1)
            runs.append((time.perf_counter() - t0) / args.calls * 1e6)
        out[f"{key}_us"] = sorted(runs)[2]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
