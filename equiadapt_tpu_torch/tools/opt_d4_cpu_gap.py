#!/usr/bin/env python3
"""How far the optimized D4 train step on the card is from the CPU's, over
several seeds, beside the CPU's own spread.

    python3 equiadapt_tpu_torch/tools/opt_d4_cpu_gap.py [--seeds 23-30] [--out gaps.json]

The step is `chip_smoke.py`'s (`opt_d4_step_vs_cpu`: BASELINE config 2's
D4 variant with a learned reference vector, fp32, SGD, batch 8 at 96 px,
dropout and artifact dummies off) from the same weights on the card and
on the CPU, and once more on the CPU with the batch times (1 + 1e-7
noise). Prints one JSON line a seed: the loss, gradient-norm and update
differences (relative, by top-level module), the CPU's own, and the bars
phase 19 holds them to. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", default="23-30", help="first-last, inclusive")
    parser.add_argument("--out", help="write the rows as JSON here")
    args = parser.parse_args()
    first, last = (int(v) for v in args.seeds.split("-"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import equiadapt_tpu_torch as tp
    from equiadapt_tpu_torch.cli import classification_train as cli

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg_dir = os.path.join(ROOT, cs.CLS_CONFIGS)
    cfg = cs.opt_d4_config(cli, cs.config2_args(cfg_dir))
    rows = []
    for seed in range(first, last + 1):
        out = cs.opt_d4_step_vs_cpu(tp, cli, cfg, torch.Generator().manual_seed(seed))
        rows.append({"seed": seed, **out})
        print(json.dumps(rows[-1]), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"device": smi, "seeds": [first, last]}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
