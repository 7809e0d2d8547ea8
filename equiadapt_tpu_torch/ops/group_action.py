"""Group actions on prediction-network outputs (`invert_canonicalization`).

Counterpart of `equiadapt_tpu/ops/group_action.py`, eval path. Feature maps
are NHWC; a regular-rep map lays its channels out C-major / G-minor
(channel = c * |G| + g).

The reflection blend is `(1 - r) * rotated + r * hflip(rotated)`, the
group-theoretic inverse of canonicalize (the JAX package's deliberate
correction of the reference's inverted condition, images/utils.py:62-64).

The regular rep with a hard element runs through the fused K2 kernel
(`rotate_roll_select`): rotate-select, hflip and fiber roll in one pass.
The differentiable invert (`invert_regular_fast_diff`, a one-hot carrying
gradients) belongs to the training slice and is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from equiadapt_tpu_torch.ops.kernels.select_warp import (
    rotate_roll_select,
    rotate_select,
)
from equiadapt_tpu_torch.ops.warp import hflip

Tensor = torch.Tensor

__all__ = ["roll_by_gather", "get_action_on_image_features"]


def roll_by_gather(feature_map: Tensor, shifts: Tensor) -> Tensor:
    """Cyclically roll the fiber (last) axis by per-sample shifts: output
    fiber g reads input fiber (g - shift) mod G, shifts truncated toward
    zero like the reference's `.long()`.

    Args:
        feature_map: (B, H, W, C, G).
        shifts: (B,) integer or float shifts.
    """
    B, H, W, C, G = feature_map.shape
    shift = torch.remainder(shifts.to(torch.int32).long(), G)
    g = torch.arange(G, device=feature_map.device)
    src = torch.remainder(g[None, :] - shift[:, None], G)  # (B, G)
    return torch.gather(
        feature_map, -1, src[:, None, None, None, :].expand(B, H, W, C, G)
    )


def get_action_on_image_features(
    feature_map: Tensor,
    *,
    num_rotations: int,
    num_group: int,
    rotation_deg: Tensor,
    reflection: Optional[Tensor] = None,
    induced_rep_type: str = "regular",
    rotation_onehot: Optional[Tensor] = None,
    mode: str = "exact",
) -> Tensor:
    """Apply the stored group element to a canonical-frame NHWC feature map.

    Spatial part: rotate by +rotation_deg, then hflip where the reflection
    indicator is 1. The regular rep also rolls its fiber: rotation fibers by
    +k, reflection fibers by -k, k = trunc(rotation_deg / 360 * n).

    Args:
        feature_map: (B, H, W, C), square; for "regular" C % num_group == 0.
        num_rotations: n, the number of rotations in the group.
        num_group: |G|, n or 2 n.
        rotation_deg: (B,) selected angles in degrees.
        reflection: (B,) hard 0/1 indicator, or None for C_n.
        induced_rep_type: "regular", "scalar" or "vector".
        rotation_onehot: a one-hot carrying gradients (training); not ported.
    """
    if rotation_onehot is not None:
        raise NotImplementedError(
            "the differentiable invert (training) is not ported yet: ROADMAP "
            "queue 1, training slice"
        )
    B, H, W, C = feature_map.shape
    n = num_rotations
    step = 360.0 / n
    # the two integer conversions of the JAX package: the spatial element
    # rounds half to even, the fiber shift truncates toward zero
    idx = torch.remainder(torch.round(rotation_deg / step).to(torch.int32), n)
    refl_i = (
        None if reflection is None else torch.round(reflection).to(torch.int32)
    )

    if induced_rep_type == "regular":
        if C % num_group != 0:
            raise ValueError(
                f"regular rep needs channels divisible by |G|={num_group}, got {C}"
            )
        if num_group not in (n, 2 * n) or (reflection is None) != (num_group == n):
            raise ValueError(
                f"|G|={num_group} with n={n} needs a reflection exactly for D_n"
            )
        shift = (rotation_deg / 360.0 * n).to(torch.int32)
        return rotate_roll_select(
            feature_map, idx, shift, n, 1.0, "zeros", refl=refl_i, mode=mode
        )

    x_out = rotate_select(feature_map, idx, n, 1.0, "zeros", mode)
    if refl_i is not None:
        x_out = torch.where(
            (refl_i == 1)[:, None, None, None], hflip(x_out), x_out
        )
    if induced_rep_type == "scalar":
        return x_out
    if induced_rep_type == "vector":
        # v'(x) = R(theta) v(R(-theta) x): channel pairs (v_x, v_y) mix by
        # the same rotation; rotation-only groups, as in the JAX package
        if reflection is not None:
            raise NotImplementedError(
                "vector rep under reflections needs an orientation convention"
            )
        if C % 2 != 0:
            raise ValueError(f"vector rep needs even channels, got {C}")
        rad = torch.deg2rad(rotation_deg).to(x_out.dtype)
        cos = torch.cos(rad)[:, None, None, None]
        sin = torch.sin(rad)[:, None, None, None]
        v = x_out.reshape(B, H, W, C // 2, 2)
        vx, vy = v[..., 0], v[..., 1]
        v_rot = torch.stack([cos * vx - sin * vy, sin * vx + cos * vy], dim=-1)
        return v_rot.reshape(B, H, W, C)
    raise ValueError("induced_rep_type must be regular, scalar or vector")
