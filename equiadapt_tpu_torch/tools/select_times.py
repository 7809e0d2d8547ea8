#!/usr/bin/env python3
"""Forward and backward device times of the select kernels (K1, K2, K3).

    python3 equiadapt_tpu_torch/tools/select_times.py [--root CHECKOUT] [--out times.json]

Imports `equiadapt_tpu_torch` from CHECKOUT (this file's checkout by
default), so that one copy of the script times two trees in turn. At the
main-path shapes: K1 (256, 3, 224, 224) with the C8 sources (two) and with
one source, K2 (256, 16, 224, 224) C8 with its fiber roll, K3 (256, 224,
224, 3) NHWC; fp32 and bf16. Each time is the median of WINDOWS windows of
REPS calls by CUDA events (the min and max beside it), the forward and
backward windows taking turns; the backward is `torch.autograd.grad`
through the wrapper (one kernel launch on the cotangent, then a mask per
source). Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

WINDOWS, REPS, B, N, C_K2, NUM_ROT = 5, 10, 256, 224, 16, 8


def window_ms(fn, reps):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(fns):
    """{name: [median, min, max]} over WINDOWS windows, the fns in turn."""
    for fn in fns.values():
        fn()
        fn()
    torch.cuda.synchronize()
    got = {name: [] for name in fns}
    for _ in range(WINDOWS):
        for name, fn in fns.items():
            got[name].append(window_ms(fn, REPS))
    return {name: [sorted(ts)[len(ts) // 2], min(ts), max(ts)] for name, ts in got.items()}


def case(sw, name, dtype, one_source=False):
    gen = torch.Generator(device="cuda").manual_seed(0)
    rolled = name == "select_planes_rolled"
    residues, src_of, k_of = sw._c_n_decomposition(NUM_ROT, 1.0 if rolled else -1.0)
    idx = torch.randint(0, NUM_ROT, (B,), device="cuda", generator=gen)
    src = torch.tensor(src_of, device="cuda")[idx].int()
    k = torch.tensor(k_of, device="cuda")[idx].int()
    C = C_K2 if rolled else 3
    shape = (B, N, N, C) if name == "select_planes_nhwc" else (B, C, N, N)
    srcs = [torch.randn(*shape, device="cuda", generator=gen).to(dtype)
            for _ in (residues[:1] if one_source else residues)]
    if one_source:
        src = torch.zeros_like(src)
    leaves = [s.requires_grad_(True) for s in srcs]

    def call():
        if rolled:
            return sw.select_planes_rolled(leaves, src, k, idx.int(), NUM_ROT, NUM_ROT)
        return getattr(sw, name)(leaves, src, k)

    def forward():
        with torch.no_grad():
            return call()

    with torch.enable_grad():
        out = call()
        g = torch.randn_like(out)
        times = timed({"forward": forward,
                       "backward": lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)})
    tag = str(dtype).removeprefix("torch.") + (",1 source" if one_source else "")
    return {"name": f"{name}[{tag}]", "shape": list(shape), "sources": len(srcs),
            "forward_ms": times["forward"], "backward_ms": times["backward"]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    parser.add_argument("--out")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("select_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from equiadapt_tpu_torch.ops.kernels import select_warp as sw

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, os.path.abspath(args.root), flush=True)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, one in (("select_planes", False), ("select_planes", True),
                          ("select_planes_rolled", False), ("select_planes_nhwc", False)):
            rows.append(case(sw, name, dtype, one))
            print(json.dumps(rows[-1]), flush=True)
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "root": os.path.abspath(args.root),
                       "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
