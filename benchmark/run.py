"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload c8-resnet50.serve --seed 7 \\
        --seconds 20 --trace 0

The cell's configuration, traffic mix and per-layer metrics are found by
name from `BENCHMARK.json` (`benchmark/harness/cell.py`). Set-up (the
program's build and kernels, weights and inputs made on the card from the
seed, warm-up of the cell's shapes) is timed from the process's start;
then the window runs for `--seconds`; then the program is freed and what
it produced is compared with the plain reference. `--trace 0` prints the
cell's end-to-end metrics, `--trace 1` its per-layer metrics, read from
spans and a device trace of the window's head. The last line of standard
output is one JSON object; the numbers compared, each with its limit, are
the last lines of standard error and the result's last key.

The run needs as many CUDA devices as the cell asks for and refuses to run
on anything else. Build and kernel caches stay inside the checkout:
the port's nvcc libraries in its own `equiadapt_tpu_torch/_build/`, and
Triton's in `.bench_cache/triton/`.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "equiadapt_tpu")


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def fail(code: int, message: str):
    print(f"benchmark: {message}", file=sys.stderr)
    sys.exit(code)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    os.environ["USE_FLAX"] = "0"
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_cache" / "triton")
    if not (ROOT / "BENCHMARK.json").is_file():
        fail(2, f"no BENCHMARK.json in {ROOT}")
    if not (ROOT / "equiadapt_tpu_torch" / "__init__.py").is_file():
        fail(2, f"the program (equiadapt_tpu_torch) is not in {ROOT}")
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark.harness import cell as cells
    from benchmark.harness import check

    cell = cells.resolve(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        fail(3, f"{args.workload} needs {cell.chips} CUDA device(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    device = "cuda:0"
    torch.cuda.set_device(0)
    res = cell.driver().run(cell, args.seed, args.seconds, bool(args.trace), device, T0)
    found = loaded_forbidden()
    if found:
        fail(4, f"modules of the JAX side were loaded: {found}")

    record = res["record"]
    info = {"workload": cell.name, "seed": args.seed, "card": power_limit(),
            "iterations": res["iterations"], "window_s": res["window_s"],
            "memory_peak_bytes": res["memory_peak_bytes"]}
    if args.trace:
        tr = record["trace"]
        info["launches_per_iter"] = tr["device_events"] / max(tr["iterations"], 1)
        info["busy_ms_per_iter"] = 1e3 * tr["busy_s"] / max(tr["iterations"], 1)
        info["spans_ms_mean"] = {k: sum(v) / len(v) for k, v in record["spans_ms"].items() if v}
        metrics = cells.read_metrics(cell, record, ROOT)
    else:
        metrics = {m["name"]: {"value": float(res["e2e"][m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    print("info " + json.dumps(info), flush=True)
    correct = check.verdict(res["numbers"], cell.limits) and res["failed"] == 0
    checks = check.report(res["numbers"], cell.limits)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips, "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": bool(correct), "attempted": int(res["attempted"]),
            "failed": int(res["failed"]), "metrics": metrics, "device": device_info}
    if args.trace:
        tr = record["trace"]
        device_info["busy_s"] = tr["busy_s"]
        device_info["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    line["checks"] = checks
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
