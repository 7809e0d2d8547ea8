"""Group-parallel (orbit-axis) sharding: the |G| orbit as a mesh axis.

Counterpart of `equiadapt_tpu/parallel/group_parallel.py`. The
canonicalization workloads carry a parallelism axis of their own, the |G|
group orbit:

* `make_mesh_group(n_data, n_group)` is a 2-D ("data", "group") mesh of
  the ranks.
* `group_sharded_inference` runs the per-group-element robustness sweep
  (`pipelines.classification.group_inference`) with the batch split over
  "data" and the orbit's G elements over "group": the rank at (d, g)
  materializes the orbit of its data slice (kernel K4 for quarter turns),
  evaluates the model on its share of the elements (`np.array_split`'s
  shares, so |G| need not divide the group axis) and counts its correct
  predictions per element; the counts are summed over the grid, so the
  metrics equal the unsharded sweep's.

The optimized canonicalizer's `orbit_sharding` splits its training orbit
batch over the same mesh (`images.canonicalization.discrete_group`).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from equiadapt_tpu_torch.parallel.mesh import PartitionSpec as P
from equiadapt_tpu_torch.parallel.mesh import axis_size, axis_slice, make_grid

Tensor = torch.Tensor

__all__ = ["make_mesh_group", "orbit_spec", "group_sharded_inference"]


def make_mesh_group(n_data: int, n_group: int,
                    axis_names: Tuple[str, str] = ("data", "group")):
    """(n_data, n_group) mesh of the world's ranks; "group" indexes orbit
    elements."""
    return make_grid((n_data, n_group), axis_names)


def orbit_spec(group_axis: str = "group", data_axis: str = "data") -> P:
    """The split of a (G, B, ...) orbit tensor: G over the group axis, B
    over the data axis."""
    return P(group_axis, data_axis)


def group_sharded_inference(
    state: Any,
    batch: Dict[str, Tensor],
    mesh,
    *,
    num_rotations: int = 4,
    group_type: str = "rotation",
    grayscale: bool = False,
    data_axis: str = "data",
    group_axis: str = "group",
) -> Dict[str, Tensor]:
    """`group_inference` of the pipeline `state` (a module, or a train
    state's model) on the global `batch` (the same on every rank), with the
    batch over `data_axis` and the orbit over `group_axis`. Every rank
    returns the metrics of the whole sweep."""
    from equiadapt_tpu_torch.ops.kernels.orbit import materialize_orbit

    model = getattr(state, "model", state)
    x_all, labels_all = batch["image"], batch["label"]
    rows = axis_slice(x_all.shape[0], mesh, data_axis)
    x, labels = x_all[rows], labels_all[rows].to(x_all.device)
    B = x.shape[0]
    mode = "zeros" if grayscale else "border"
    orbit = materialize_orbit(x, num_rotations, group_type=group_type,
                              padding_mode=mode, sign=1.0)
    G = orbit.shape[0] // B
    shares = np.array_split(np.arange(G), axis_size(mesh, group_axis))
    mine = shares[mesh.get_local_rank(group_axis)]
    correct = torch.zeros(G, dtype=torch.float64, device=x.device)
    if len(mine):
        lo, hi = int(mine[0]), int(mine[-1]) + 1
        with torch.no_grad():
            logits, _ = model(orbit[lo * B:hi * B], training=False)
        pred = torch.argmax(logits, -1).reshape(hi - lo, B)
        correct[lo:hi] = (pred == labels[None]).sum(dim=1).double()
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.all_reduce(correct)  # every (data, group) cell once
    accs = (correct / x_all.shape[0]).float()
    out = {f"test/acc_element_{g}": accs[g] for g in range(G)}
    out["test/group_acc"] = torch.mean(accs)
    out["test/acc"] = accs[0]
    return out
