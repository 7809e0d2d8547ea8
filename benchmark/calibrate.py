"""Readings that the limits of `correct` are set from: for each seed, the
program's numbers and those of the control (the reference one precision
below the configuration's, in the program's place) and, for training
cells, of the planted faults. All seeds run in one process, each with a
short window, so the set-up's build and autotune are paid once.

    python3 benchmark/calibrate.py --workload c8-resnet50.serve \\
        --seeds 101,102,103 --seconds 3

Prints one JSON line per seed and writes them to `--out` when given.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", default="",
                   help="the control's precision in place of the cell's (fp8, int8)")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import cell as cells

    cell = cells.resolve(args.workload, ROOT)
    cell.control = args.control or cell.control
    if not torch.cuda.is_available():
        sys.exit("calibrate needs a CUDA device")
    lines = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        res = cell.driver().run(cell, seed, args.seconds, False, "cuda:0", t0, control=True)
        line = {"workload": cell.name, "seed": seed, "control_precision": cell.control, "program": res["numbers"],
                "control": res["control"], "fault": res.get("fault"),
                "detail": res.get("detail"),
                "iterations": res["iterations"],
                "setup_s": res["setup_s"], "e2e": res["e2e"],
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        lines.append(line)
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(l) + "\n" for l in lines))


if __name__ == "__main__":
    main()
