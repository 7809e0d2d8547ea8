#!/usr/bin/env python3
"""Where K6's resident kernel spends a block's time, phase by phase.

    python3 equiadapt_tpu_torch/tools/k6_phases.py [--out phases.json]

Builds an instrumented copy of `csrc/shear_rotate.cu` under `_build/`: the
first thread of each block reads the device's global timer at each phase
boundary (start, after the first cluster barrier, after pass 1 with the
load, after the second barrier, after pass 2, after pass 3, after the third
barrier, at the end). Runs the main-path shapes of the continuous serving
preset, (256, 224, 224, 16) zeros and (256, 224, 224, 3) border, in bf16
and fp32, each with the wrapper's cluster and with clusters of one block,
checks each output `torch.equal` to the plain version, and prints per case
the span of the launch, the blocks alive at its midpoint and the median
block time of each phase, in microseconds. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from equiadapt_tpu_torch.ops.kernels import _build  # noqa: E402
from equiadapt_tpu_torch.ops.kernels import shear_rotate as sr  # noqa: E402

PHASES = ("start", "load_pass1", "barrier1", "pass2", "pass3", "barrier2", "write")
CASES = ((16, "zeros", torch.bfloat16), (16, "zeros", torch.float32),
         (3, "border", torch.bfloat16), (3, "border", torch.float32))


def instrumented_source() -> str:
    """csrc/shear_rotate.cu with a timestamp at each phase boundary of
    `shear_resident_kernel` into a table passed by `eqt_set_stamps`."""
    s = (_build.CSRC_DIR / "shear_rotate.cu").read_text()
    edits = [
        ("                      int pitch, float cx, float cy, int zeros) {\n"
         "  float* const plane = resident_plane;",
         "                      int pitch, float cx, float cy, int zeros,\n"
         "                      unsigned long long* stamps) {\n"
         "  float* const plane = resident_plane;\n"
         "  unsigned long long* st = stamps + 8 * (blockIdx.y * gridDim.x + blockIdx.x);\n"
         "  auto stamp = [&](int i) {\n"
         "    if (threadIdx.x == 0) {\n"
         "      unsigned long long t;\n"
         "      asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
         "      st[i] = t;\n"
         "    }\n"
         "  };\n"
         "  stamp(0);"),
        ("  // pass 1 (x-shear about cy) while loading",
         "  stamp(1);\n  // pass 1 (x-shear about cy) while loading"),
        ("  cluster_barrier<CS>();\n\n  // pass 2 (y-shear about cx)",
         "  stamp(2);\n  cluster_barrier<CS>();\n  stamp(3);\n\n  // pass 2 (y-shear about cx)"),
        ("  // pass 3 (x-shear about cy)", "  stamp(4);\n  // pass 3 (x-shear about cy)"),
        ("  cluster_barrier<CS>();\n\n  // the write:",
         "  stamp(5);\n  cluster_barrier<CS>();\n  stamp(6);\n\n  // the write:"),
        ("  if constexpr (CS > 1) cluster_barrier<CS>();\n}",
         "  if constexpr (CS > 1) cluster_barrier<CS>();\n  stamp(7);\n}"),
        ("                           static_cast<T*>(out), coef, H, W, C, pitch, cx, cy,\n"
         "                           zeros);",
         "                           static_cast<T*>(out), coef, H, W, C, pitch, cx, cy,\n"
         "                           zeros, g_stamps);"),
        ("namespace {\n\nnamespace cg",
         "unsigned long long* g_stamps = nullptr;\n"
         "extern \"C\" void eqt_set_stamps(void* p) {\n"
         "  g_stamps = static_cast<unsigned long long*>(p);\n}\n\n"
         "namespace {\n\nnamespace cg"),
    ]
    for old, new in edits:
        if s.count(old) != 1:
            raise RuntimeError(f"shear_rotate.cu changed: cannot instrument at {old[:60]!r}")
        s = s.replace(old, new)
    return s


def build() -> ctypes.CDLL:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "k6_phases.cu"
    src.write_text(instrumented_source())
    lib = _build.BUILD_DIR / "libk6_phases.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o", str(lib),
           str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{done.stdout}{done.stderr}")
    out = ctypes.CDLL(str(lib))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    out.eqt_shear_rotate_resident.argtypes = [
        ci, vp, vp, vp, ci, ci, ci, ci, cf, cf, ci, ci, ci, ci, vp]
    out.eqt_shear_rotate_resident.restype = ci
    out.eqt_set_stamps.argtypes = [vp]
    return out


def measure(lib, C, padding, dtype, cluster, B=256, N=224, reps=3):
    gen = torch.Generator(device="cuda").manual_seed(0)
    z = torch.rand(B, N, N, C, device="cuda", generator=gen).to(dtype)
    r = (torch.rand(B, device="cuda", generator=gen) * 2 - 1) * (torch.pi / 4)
    out = torch.empty_like(z)
    ab = sr._shear_coefficients(r).contiguous()
    stamps = torch.zeros(B * C * 8, dtype=torch.int64, device="cuda")
    lib.eqt_set_stamps(stamps.data_ptr())
    words = int(sr._shear_words(z, out, cluster))
    c = float(N // 2)
    for _ in range(reps):  # the last launch's stamps stay
        err = lib.eqt_shear_rotate_resident(
            _build.DTYPE_CODES[dtype], z.data_ptr(), out.data_ptr(), ab.data_ptr(),
            B, N, N, C, c, c, int(padding == "zeros"), cluster, words,
            sr._resident_bytes(N, N), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")
    torch.cuda.synchronize()
    ref = sr.shear_rotate_residual_plain(z, r, c, c, padding)
    assert torch.equal(out, ref), (C, padding, dtype, cluster)
    s = stamps.view(B * C, 8).double()
    t0, t1 = s[:, 0].min(), s[:, 7].max()
    mid = (t0 + t1) / 2
    phases = ((s[:, 1:] - s[:, :-1]) / 1e3).median(dim=0).values.tolist()
    return {"shape": [B, N, N, C], "padding": padding,
            "dtype": str(dtype).removeprefix("torch."), "cluster": cluster,
            "words": bool(words), "span_us": ((t1 - t0) / 1e3).item(),
            "block_us": ((s[:, 7] - s[:, 0]) / 1e3).median().item(),
            "alive_at_mid": int(((s[:, 0] <= mid) & (s[:, 7] >= mid)).sum()),
            "phases_us": dict(zip(PHASES, phases))}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="write the rows as JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("k6_phases: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    lib = build()
    rows = []
    with torch.no_grad():
        for C, padding, dtype in CASES:
            own = sr._shear_cluster(C, torch.empty(0, dtype=dtype).element_size())
            for cluster in sorted({own, 1}, reverse=True):
                row = measure(lib, C, padding, dtype, cluster)
                rows.append(row)
                print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
