"""The numbers that decide `correct`, each against its limit
(`benchmark/limits/<cell>.json`; PERF.md §2 gives the readings each limit
was set from).

Serving (the worst over the sampled batches):
* the element: the reference module's `element_gaps` (C8: `energy_err`,
  the program's energies against the reference's, whose argmax the
  element is; SO(2): `frame_gap`, the program's frame against the
  reference's frame vector);
* canon_err: max |program canonical image - reference| over max
  |reference|, the reference warping by the program's element;
* logit_err: max |program logits - reference| over max |reference|, the
  reference classifying its canonical image of the program's element.

Training (the first three steps, which the window's own call made; the
reference takes the elements the program chose):
* loss_gap: the largest |program loss - reference loss| / |reference loss|;
* grad_gap: the median leaf's gap between the norms of the program's first
  gradient (as AdamW holds it after step 1: exp_avg / (1 - beta1)) and the
  reference's, over the larger of the leaf's reference norm and the
  median leaf's;
* update_gap: the worst leaf's gap, so measured, of the change over the
  steps.
Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of both: AdamW moves them by round-off alone.
"""

from __future__ import annotations

import math
import statistics
import sys
from typing import Dict, Iterable, List

import torch

Tensor = torch.Tensor


def rel_max(a: Tensor, b: Tensor) -> float:
    """max |a - b| / max |b| (inf where a is not finite)."""
    a, b = a.float(), b.float().to(a.device)
    if not bool(torch.isfinite(a).all()):
        return math.inf
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def each_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                  keep: Iterable[str]) -> Dict[str, float]:
    """|prog - ref| / max(ref, median of ref) of each leaf of `keep` (inf
    where the program's is missing or not finite)."""
    keep = list(keep)
    med = statistics.median(ref[k] for k in keep)
    out = {}
    for k in keep:
        p = prog.get(k, math.nan)
        out[k] = (abs(p - ref[k]) / max(ref[k], med, 1e-30) if math.isfinite(p)
                  else math.inf)
    return out


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Iterable[str]) -> float:
    """The worst leaf's gap (`each_leaf_gap`)."""
    return max(each_leaf_gap(prog, ref, keep).values())


def moved_leaves(ref_grad_norms: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad_norms.values())
    return [k for k, v in ref_grad_norms.items() if v >= 1e-3 * med]


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number finite and within its limit, and every limit read."""
    if not limits or set(limits) != set(numbers):
        return False
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)


def report(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """{name: {"value", "limit"}}, also printed as the last lines of
    standard error."""
    out = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    for k, v in out.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return out
