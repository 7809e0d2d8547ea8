"""Group actions on prediction-network outputs (`invert_canonicalization`).

Counterpart of `equiadapt_tpu/ops/group_action.py`. Feature maps are NHWC;
a regular-rep map lays its channels out C-major / G-minor
(channel = c * |G| + g).

The reflection blend is `(1 - r) * rotated + r * hflip(rotated)`, the
group-theoretic inverse of canonicalize (the JAX package's deliberate
correction of the reference's inverted condition, images/utils.py:62-64).

The regular rep with a hard element runs through the fused K2 kernel
(`rotate_roll_select`): rotate-select, hflip and fiber roll in one pass.
In training (a rotation one-hot carrying gradients) the regular rep in
fast mode takes `invert_regular_fast_diff`, K2 forward and backward;
otherwise the one-hot blend of static warps (`rotate_discrete`), the soft
reflection blend and the fiber roll, as the JAX package off the TPU. The
JAX package takes the fused invert on the TPU only; the port takes it on
every device, the CPU through K2's plain version.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from equiadapt_tpu_torch.ops.kernels.select_warp import (
    MAX_SOURCES,
    _c_n_decomposition,
    rotate_roll_select,
    rotate_select,
)
from equiadapt_tpu_torch.ops.warp import group_angles, hflip, rotate_discrete

Tensor = torch.Tensor

__all__ = ["roll_by_gather", "get_action_on_image_features",
           "invert_regular_fast_diff"]


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


class _InvertFastDiff(torch.autograd.Function):
    """`invert_regular_fast_diff` (JAX: group_action.py:70-219)."""

    @staticmethod
    def forward(ctx, feature_map, rotation_onehot, reflection, n):
        idx = torch.argmax(rotation_onehot, dim=-1).to(torch.int32)
        refl_i = (None if reflection is None
                  else torch.round(reflection).to(torch.int32))
        # the roll amount equals the element index for C_n fibers
        out = rotate_roll_select(feature_map, idx, idx, n, 1.0, "zeros",
                                 refl=refl_i)
        ctx.n = n
        ctx.oh_dtype = rotation_onehot.dtype
        ctx.refl_dtype = None if reflection is None else reflection.dtype
        ctx.save_for_backward(idx, refl_i, out)
        return out

    @staticmethod
    def backward(ctx, g):
        idx, refl_i, out = ctx.saved_tensors
        n = ctx.n
        B, H, W, C = out.shape
        dt = torch.promote_types(out.dtype, torch.float32)
        gf = g.to(dt)
        dev = out.device

        # input cotangent: the transpose Roll_{-s} . Flip^r . Rot', one more
        # K2 launch; Rot_{-theta} . Flip^r == Flip^r . Rot_{(-1)^(1-r) theta}
        neg = torch.remainder(-idx, n)
        idx_t = neg if refl_i is None else torch.where(refl_i == 1, idx, neg)
        xbar = rotate_roll_select(g, idx_t, neg, n, 1.0, "zeros", refl=refl_i)

        # rotation one-hot: the angle pathway. u = Flip^r(Roll_{-s}(out)) is
        # the purely rotated field; d u / d phi(p) = du/dx * (-(py - cy))
        # + du/dy * (px - cx) about ((W-1)/2, (H-1)/2), with gh the matching
        # permuted cotangent
        fiber = n if refl_i is None else 2 * n
        u = out.to(dt).reshape(B, H, W, C // fiber, fiber)
        gh = gf.reshape(B, H, W, C // fiber, fiber)
        s = idx.to(dt)
        if refl_i is None:
            u, gh = roll_by_gather(u, -s), roll_by_gather(gh, -s)
        else:
            r = refl_i[:, None, None, None, None].to(dt)

            def unroll(t):
                t = torch.cat([roll_by_gather(t[..., :n], -s),
                               roll_by_gather(t[..., n:], s)], dim=-1)
                return (1.0 - r) * t + r * torch.flip(t, dims=(2,))

            u, gh = unroll(u), unroll(gh)
        u = u.reshape(B, H, W, C)
        gh = gh.reshape(B, H, W, C)
        du_dy = torch.gradient(u, dim=1)[0]
        du_dx = torch.gradient(u, dim=2)[0]
        px = torch.arange(W, dtype=dt, device=dev) - (W - 1) / 2.0
        py = torch.arange(H, dtype=dt, device=dev) - (H - 1) / 2.0
        vel = du_dx * (-py[None, :, None, None]) + du_dy * px[None, None, :, None]
        # inscribed-disk mask: central differences across the zeros-padding
        # boundary give spurious velocity terms there
        rad2 = px[None, None, :] ** 2 + py[None, :, None] ** 2
        disk = (rad2 <= (min(H, W) / 2.0 - 2.0) ** 2).to(dt)[..., None]
        phi_bar = torch.sum(gh * vel * disk, dim=(1, 2, 3))  # d loss / d rad
        theta_bar_deg = phi_bar * (math.pi / 180.0)
        angles = group_angles(n, device=dev, dtype=dt)
        onehot_bar = (theta_bar_deg[:, None] * angles[None, :]).to(ctx.oh_dtype)

        # reflection: d out / d r = (1 - 2 r) (hflip(out) - out) at the
        # hard branch
        refl_bar = None
        if refl_i is not None:
            sign_r = 1.0 - 2.0 * refl_i.to(dt)
            o = out.to(dt)
            refl_bar = (sign_r * torch.sum(gf * (hflip(o) - o), dim=(1, 2, 3))
                        ).to(ctx.refl_dtype)
        return xbar.to(g.dtype), onehot_bar, refl_bar, None


def invert_regular_fast_diff(feature_map: Tensor, rotation_onehot: Tensor,
                             reflection: Optional[Tensor],
                             num_rotations: int) -> Tensor:
    """Differentiable fused invert of a regular-rep NHWC map.

    Forward: K2 (`rotate_roll_select`, fast mode) at the one-hot's argmax,
    exact for a straight-through one-hot, whose forward values are hard.
    Backward (a `torch.autograd.Function`, as the JAX custom VJP):
    * the map's cotangent: the transposed permutation as one more K2
      launch (exact for quarter turns; the two-pass interpolation's
      sample-for-splat approximation otherwise);
    * the rotation one-hot: the angle pathway, central differences of the
      unrolled output inside the inscribed disk, times the angle table;
    * the reflection: the closed-form blend derivative at the hard branch;
    * the roll shift is hard and takes no gradient.
    """
    return _InvertFastDiff.apply(feature_map, rotation_onehot, reflection,
                                 num_rotations)


def _fused_ok(H: int, W: int, num_rotations: int, num_group: int,
              reflection: Optional[Tensor]) -> bool:
    n = num_rotations
    return (H == W and num_group in (n, 2 * n)
            and (reflection is None) == (num_group == n)
            and len(_c_n_decomposition(n, 1.0)[0]) <= MAX_SOURCES)


def _blend_action(feature_map: Tensor, num_rotations: int, num_group: int,
                  rotation_deg: Tensor, reflection: Optional[Tensor],
                  induced_rep_type: str, rotation_onehot: Tensor,
                  mode: str) -> Tensor:
    """The training action: the one-hot blend of static warps, the soft
    reflection blend, then the representation's part."""
    B, H, W, C = feature_map.shape
    n = num_rotations
    if induced_rep_type == "vector" and reflection is not None:
        raise NotImplementedError(
            "vector rep under reflections needs an orientation convention")
    x_out = rotate_discrete(feature_map, rotation_onehot, n, 1.0, "zeros", mode)
    if reflection is not None:
        r = reflection[:, None, None, None].to(x_out.dtype)
        x_out = (1.0 - r) * x_out + r * hflip(x_out)
    if induced_rep_type == "scalar":
        return x_out
    if induced_rep_type == "regular":
        x_out = x_out.reshape(B, H, W, C // num_group, num_group)
        shift = rotation_deg / 360.0 * n
        if reflection is not None:
            x_out = torch.cat([roll_by_gather(x_out[..., :n], shift),
                               roll_by_gather(x_out[..., n:], -shift)], dim=-1)
        else:
            x_out = roll_by_gather(x_out, shift)
        return x_out.reshape(B, H, W, C)
    return _rotate_vectors(x_out, rotation_deg)


def _rotate_vectors(x_out: Tensor, rotation_deg: Tensor) -> Tensor:
    """v'(x) = R(theta) v: channel pairs (v_x, v_y) mixed by the rotation."""
    B, H, W, C = x_out.shape
    if C % 2 != 0:
        raise ValueError(f"vector rep needs even channels, got {C}")
    rad = torch.deg2rad(rotation_deg).to(x_out.dtype)
    cos = torch.cos(rad)[:, None, None, None]
    sin = torch.sin(rad)[:, None, None, None]
    v = x_out.reshape(B, H, W, C // 2, 2)
    vx, vy = v[..., 0], v[..., 1]
    v_rot = torch.stack([cos * vx - sin * vy, sin * vx + cos * vy], dim=-1)
    return v_rot.reshape(B, H, W, C)


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
        rotation_onehot: (B, n) one-hot carrying gradients (training): the
            regular rep in fast mode takes `invert_regular_fast_diff`, the
            rest the one-hot blend (`_blend_action`).
    """
    B, H, W, C = feature_map.shape
    n = num_rotations
    if induced_rep_type not in ("regular", "scalar", "vector"):
        raise ValueError("induced_rep_type must be regular, scalar or vector")
    if induced_rep_type == "regular" and C % num_group != 0:
        raise ValueError(
            f"regular rep needs channels divisible by |G|={num_group}, got {C}")
    if rotation_onehot is not None:
        if (induced_rep_type == "regular" and mode == "fast"
                and _fused_ok(H, W, n, num_group, reflection)):
            return invert_regular_fast_diff(feature_map, rotation_onehot,
                                            reflection, n)
        return _blend_action(feature_map, n, num_group, rotation_deg,
                             reflection, induced_rep_type, rotation_onehot,
                             mode)
    step = 360.0 / n
    # the two integer conversions of the JAX package: the spatial element
    # rounds half to even, the fiber shift truncates toward zero
    idx = torch.remainder(torch.round(rotation_deg / step).to(torch.int32), n)
    refl_i = (
        None if reflection is None else torch.round(reflection).to(torch.int32)
    )

    if induced_rep_type == "regular":
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
    # vector: v'(x) = R(theta) v(R(-theta) x); rotation-only groups, as in
    # the JAX package
    if reflection is not None:
        raise NotImplementedError(
            "vector rep under reflections needs an orientation convention"
        )
    return _rotate_vectors(x_out, rotation_deg)
