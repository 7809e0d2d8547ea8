"""Discrete-group (C_n / D_n) image canonicalizers.

Counterpart of `equiadapt_tpu/images/canonicalization/discrete_group.py`
(`DiscreteGroupImageCanonicalization`, `GroupEquivariantImageCanonicalization`,
`OptimizedGroupEquivariantImageCanonicalization`,
`optimization_specific_loss`). NHWC in and out. `canonicalize` returns
`(x_canon, info)`:

1. crop and resize the batch for the energy network;
2. (B, |G|) group activations, kept in fp32: the output fiber of a
   group-equivariant network, or, in the optimized variant, the cosine
   score of each element of the batch's |G|-orbit (kernel K4 for quarter
   turns) against a reference vector;
3. hard argmax selection (eval), or a straight-through / Gumbel one-hot
   (training);
4. the D_n reflection blend;
5. eval: the rotate-select of each sample by its element, through kernel
   K3 for an NHWC-contiguous batch or K1 for a view of NCHW memory
   (`ops.kernels.select_warp.rotate_select`); training: the
   `rotate_discrete` blend of the static warps with the rotation one-hot,
   which carries the gradient to the energy network.

`invert_canonicalization` goes through `ops.group_action` (kernel K2 for a
regular rep, in training too where the fused invert applies).

Spans (`utils.profiling.annotate`, the JAX package's scope names): `canon`
around `canonicalize`, with `canon/get_group_activations` (the cast to
`compute_dtype`, `canon/prep` for the crop and resize, the energy
network), `canon/select_element` and `canon/warp` (steps 4-5 and the cast
back) under it; `canon/invert` around the invert.

`training` is an argument, as in the JAX package; the module mode is not
read. Random draws (dropout masks, Gumbel noise, the optimized variant's
artifact rotations) come from the `generator` given to `canonicalize`.
With `targets` (boxes (B, N, 4) and, optionally, masks (B, N, H, W)),
`canonicalize` returns `(x_canon, targets_canon, info)`: the boxes and
masks take the selected element too, the masks in eval through K1 (their
(B, H, W, N) view of NCHW memory), in training through the
`rotate_discrete` blend.
The optimized variant's `orbit_sharding` splits its orbit batch over a
(data, group) mesh of ranks (`parallel.make_mesh_group`). The JAX
package's NCHW-spine serving branch is a TPU layout path with no
counterpart here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from equiadapt_tpu_torch.common.base import BaseCanonicalization
from equiadapt_tpu_torch.common.info import (
    DiscreteCanonicalizationInfo,
    DiscreteGroupElement,
)
from equiadapt_tpu_torch.common.layers import all_gather_rows, orbit_shard, sharded_draw
from equiadapt_tpu_torch.common.selector import select_onehot
from equiadapt_tpu_torch.ops.boxes import flip_boxes, flip_masks, rotate_boxes
from equiadapt_tpu_torch.ops.group_action import get_action_on_image_features
from equiadapt_tpu_torch.ops.kernels.orbit import materialize_orbit
from equiadapt_tpu_torch.ops.kernels.select_warp import rotate_select
from equiadapt_tpu_torch.ops.warp import (
    crop_and_resize,
    group_angles,
    hflip,
    rotate_discrete,
)
from equiadapt_tpu_torch.utils.profiling import annotate

Tensor = torch.Tensor

__all__ = [
    "DiscreteGroupImageCanonicalization",
    "GroupEquivariantImageCanonicalization",
    "OptimizedGroupEquivariantImageCanonicalization",
    "optimization_specific_loss",
]

class DiscreteGroupImageCanonicalization(BaseCanonicalization):
    """Base discrete image canonicalizer.

    Args mirror the JAX module: `in_shape` (H, W, C); `beta` scales the
    straight-through softmax; `input_crop_ratio` / `resize_shape` shape the
    energy network's input (grayscale inputs skip both and warp with zeros
    fill); `warp_mode` "exact" (static-tap residual warps) or "fast"
    (two-pass products); `compute_dtype` for the energy network and the
    warp (None keeps the input's); `output_dtype` None casts the output back
    to the input dtype, "compute" keeps `compute_dtype`.
    """

    def __init__(self, canonicalization_network: nn.Module,
                 in_shape: Tuple[int, int, int], beta: float = 1.0,
                 input_crop_ratio: float = 1.0,
                 resize_shape: Optional[int] = None,
                 gradient_trick: str = "straight_through",
                 warp_mode: str = "exact",
                 compute_dtype: Optional[torch.dtype] = None,
                 output_dtype: Optional[str] = None,
                 group_type: str = "rotation", num_rotations: int = 4):
        super().__init__()
        self.canonicalization_network = canonicalization_network
        self.in_shape = tuple(in_shape)
        self.beta = beta
        self.input_crop_ratio = input_crop_ratio
        self.resize_shape = resize_shape
        self.gradient_trick = gradient_trick
        self.warp_mode = warp_mode
        self.compute_dtype = compute_dtype
        self.output_dtype = output_dtype
        self.group_type = group_type
        self.num_rotations = num_rotations

    @property
    def is_grayscale(self) -> bool:
        return self.in_shape[-1] == 1

    @property
    def num_group(self) -> int:
        return self.num_rotations * (2 if self.group_type == "roto-reflection" else 1)

    @property
    def padding_mode(self) -> str:
        # RGB: the reference's edge-pad + crop sandwich == border sampling
        return "zeros" if self.is_grayscale else "border"

    def transformations_before_canonicalization_network_forward(
        self, x: Tensor
    ) -> Tensor:
        """Centre-crop by input_crop_ratio, then resize (NHWC)."""
        with annotate("canon/prep"):
            return crop_and_resize(x, self.in_shape, self.input_crop_ratio,
                                   self.resize_shape)

    def get_group_activations(
        self, x: Tensor, training: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Tensor, Dict[str, Any]]:
        """Subclass hook: ((B, |G|) activations, extras dict)."""
        raise NotImplementedError

    def groupactivations_to_groupelement(
        self, group_activations: Tensor, training: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[DiscreteGroupElement, Tensor]:
        """Argmax one-hot (straight-through or Gumbel in training) ->
        (rotation degrees, reflection indicator), differentiable in the
        one-hot."""
        onehot = select_onehot(
            group_activations, gradient_trick=self.gradient_trick,
            beta=self.beta, training=training, generator=generator,
        )
        angles = group_angles(self.num_rotations, device=onehot.device)
        if self.group_type == "roto-reflection":
            rot_table = torch.cat([angles, angles])
            refl_table = torch.cat(
                [torch.zeros_like(angles), torch.ones_like(angles)]
            )
            rotation = torch.sum(onehot * rot_table, dim=-1)
            reflection = torch.sum(onehot * refl_table, dim=-1)
            return DiscreteGroupElement(rotation, reflection), onehot
        rotation = torch.sum(onehot * angles, dim=-1)
        return DiscreteGroupElement(rotation, None), onehot

    def canonicalize(self, x: Tensor, targets: Optional[Any] = None, *,
                     training: bool = False,
                     generator: Optional[torch.Generator] = None,
                     **kwargs: Any):
        """Map an NHWC batch to canonical pose: `(x_canon, info)`.

        training=True runs the energy network in train mode (batch
        statistics, dropout masks drawn from `generator`), selects with the
        straight-through (or Gumbel, noise from `generator`) one-hot and
        warps with the `rotate_discrete` blend, so the loss reaches the
        energy network. Eval selects the hard argmax and warps through the
        select kernels. Further keyword arguments go to the subclass's
        `get_group_activations`.

        With `targets` (a dict with "boxes" (B, N, 4) xyxy and, optionally,
        "masks" (B, N, H, W)) returns `(x_canon, targets_canon, info)`: the
        boxes and masks blended with their flips by the reflection
        indicator (D_n), the boxes rotated with the element's angle and
        re-aligned, the masks rotated as the image is, with zeros fill
        (eval: K1 on their view of NCHW memory; training: the one-hot
        blend). Targets without masks (a served request's box prompts) come
        back with their boxes canonicalized; targets without boxes raise
        `KeyError`."""
        with annotate("canon"):
            in_dtype = x.dtype
            with annotate("canon/get_group_activations"):
                if self.compute_dtype is not None:
                    x = x.to(self.compute_dtype)
                acts, extras = self.get_group_activations(
                    x, training=training, generator=generator, **kwargs)
                acts = acts.float()  # selection stays fp32
            with annotate("canon/select_element"):
                element, onehot = self.groupactivations_to_groupelement(
                    acts, training, generator)
            with annotate("canon/warp"):
                if element.reflection is not None:
                    r = element.reflection[:, None, None, None].to(x.dtype)
                    x = (1.0 - r) * x + r * hflip(x)
                n = self.num_rotations
                rot_onehot = (
                    onehot[:, :n] + onehot[:, n:]
                    if self.group_type == "roto-reflection" else onehot
                )
                if training:
                    x = rotate_discrete(x, rot_onehot.to(x.dtype), n, -1.0,
                                        self.padding_mode, self.warp_mode)
                else:
                    idx = torch.argmax(rot_onehot, dim=-1)
                    x = rotate_select(x, idx, n, -1.0, self.padding_mode,
                                      self.warp_mode)
                if self.output_dtype != "compute":
                    x = x.to(in_dtype)
            info = DiscreteCanonicalizationInfo(
                group_activations=acts,
                onehot=onehot,
                element=element,
                num_rotations=self.num_rotations,
                group_type=self.group_type,
                extras=extras,
            )
            if targets is not None:
                return x, self._canonicalize_targets(
                    targets, element, rot_onehot, x.shape[2], training), info
            return x, info

    def _canonicalize_targets(self, targets: Dict[str, Tensor],
                              element: DiscreteGroupElement, rot_onehot: Tensor,
                              width: int, training: bool) -> Dict[str, Tensor]:
        boxes, masks = targets["boxes"], targets.get("masks")
        if boxes is None:  # {"boxes": None}, as the masks may be left out
            raise KeyError("targets need 'boxes'")
        if element.reflection is not None:
            r = element.reflection
            boxes = ((1.0 - r[:, None, None]) * boxes
                     + r[:, None, None] * flip_boxes(boxes, width))
            if masks is not None:
                masks = ((1.0 - r[:, None, None, None]) * masks
                         + r[:, None, None, None] * flip_masks(masks))
        boxes = rotate_boxes(boxes, element.rotation_deg, width)
        if masks is None:  # a served request: box prompts, no masks
            return {**targets, "boxes": boxes}
        n = self.num_rotations
        masks_nhwc = masks.movedim(1, -1)  # (B, H, W, N), a view of NCHW memory
        if training:
            masks_nhwc = rotate_discrete(masks_nhwc, rot_onehot.to(masks.dtype), n,
                                         -1.0, "zeros", self.warp_mode)
        else:
            masks_nhwc = rotate_select(masks_nhwc, torch.argmax(rot_onehot, dim=-1),
                                       n, -1.0, "zeros", self.warp_mode)
        return {**targets, "boxes": boxes, "masks": masks_nhwc.movedim(-1, 1)}

    def invert_canonicalization(
        self, info: DiscreteCanonicalizationInfo, x_canonicalized_out: Tensor,
        induced_rep_type: str = "regular", training: bool = False,
        **kwargs: Any,
    ) -> Tensor:
        """Apply the stored element to canonical-frame NHWC outputs. With
        training=True the rotation one-hot of the info (the reflection coset
        collapsed onto it) carries the gradient to the selection; the fiber
        roll stays hard, as in the JAX package."""
        with annotate("canon/invert"):
            rotation_onehot = None
            if training:
                oh, n = info.onehot, info.num_rotations
                rotation_onehot = oh[:, :n] + oh[:, n:] if oh.shape[-1] == 2 * n else oh
                rotation_onehot = rotation_onehot.to(x_canonicalized_out.dtype)
            return get_action_on_image_features(
                x_canonicalized_out,
                num_rotations=info.num_rotations,
                num_group=info.num_group,
                rotation_deg=info.element.rotation_deg,
                reflection=info.element.reflection,
                induced_rep_type=induced_rep_type,
                rotation_onehot=rotation_onehot,
                mode=self.warp_mode,
            )


class GroupEquivariantImageCanonicalization(DiscreteGroupImageCanonicalization):
    """Energy from a group-equivariant network: its output fiber is the
    activation vector. `group_type` / `num_rotations` must match the
    network's."""

    def get_group_activations(
        self, x: Tensor, training: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Tensor, Dict[str, Any]]:
        x = self.transformations_before_canonicalization_network_forward(x)
        return self.canonicalization_network(x, training, generator), {}


class OptimizedGroupEquivariantImageCanonicalization(
        DiscreteGroupImageCanonicalization):
    """Energy from orbit scoring with a plain (non-equivariant) network.

    The batch's |G|-orbit is materialized once, group-major (G * B images,
    `ops.kernels.orbit.materialize_orbit`: kernel K4 when every element is a
    quarter turn of a square image, static warps otherwise); the network
    maps it to (G * B, out_vector_size) vectors, and element g of sample b
    scores the cosine of its vector with `reference_vector`, a (1, D)
    parameter drawn from N(0, 1) (trained only with `learn_ref_vec`).
    acts = scores.reshape(G, B).T.

    training=True runs the network in train mode on the orbit (batch
    statistics, dropout masks from `generator`); the orbit is data, built
    from the batch alone, so K4 serves training as it serves eval, and the
    gradient reaches the network through the scores and, through the
    straight-through selection, the `rotate_discrete` warp of the batch.

    With `artifact_err_wt` > 0 each orbit image is also rotated by a random
    element and back (`rotate_discrete`), and the network's vectors of those
    dummies go to `info.extras["vector_out_dummy"]` for
    `optimization_specific_loss`. The random elements are drawn from the
    `generator` that `canonicalize` is given, or handed in as `artifact_idx`
    ((G * B,) integers in [0, num_rotations)).

    `orbit_sharding` = (group axis, data axis), e.g. ("group", "data"),
    names the axes of the active mesh (`parallel.mesh.current_mesh`: the
    mesh of a `parallel.data_parallel_jit` step, whose batch is split over
    the data axis) to split the (G * B) orbit batch over, as the JAX
    module's sharding constraint does: the rank at (d, g) runs the network
    on its share of the G elements (|G| need not divide the group axis;
    `np.array_split`'s shares) for its data slice, BatchNorm takes the
    statistics of the whole orbit batch over every rank of the mesh, and
    the vectors of the other shares are all-gathered over the group axis
    (differentiable) before the scores. None (the default) runs the whole
    orbit on each rank.
    """

    def __init__(self, canonicalization_network: nn.Module,
                 in_shape: Tuple[int, int, int], *, out_vector_size: int = 128,
                 learn_ref_vec: bool = False, artifact_err_wt: float = 0.0,
                 orbit_sharding: Optional[Tuple[str, str]] = None,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 **kwargs: Any):
        super().__init__(canonicalization_network, in_shape, **kwargs)
        self.orbit_sharding = None if orbit_sharding is None else tuple(orbit_sharding)
        self.out_vector_size = out_vector_size
        self.learn_ref_vec = learn_ref_vec
        self.artifact_err_wt = artifact_err_wt
        self.reference_vector = nn.Parameter(
            torch.randn(1, out_vector_size, generator=generator, device=device),
            requires_grad=learn_ref_vec)

    def group_augment(self, x: Tensor) -> Tensor:
        """(B, h, w, C) -> (|G| * B, h, w, C) orbit, group-major, in NHWC
        memory whatever x's (K4 and the static warps walk NHWC rows; the
        copy of the resized batch is small beside the orbit)."""
        return materialize_orbit(
            x.contiguous(), self.num_rotations, group_type=self.group_type,
            padding_mode=self.padding_mode, mode=self.warp_mode)

    def get_group_activations(
        self, x: Tensor, training: bool = False,
        generator: Optional[torch.Generator] = None,
        artifact_idx: Optional[Tensor] = None,
    ) -> Tuple[Tensor, Dict[str, Any]]:
        x = self.transformations_before_canonicalization_network_forward(x)
        B = x.shape[0]
        G = self.num_group
        n = self.num_rotations
        x_aug = self.group_augment(x)  # (G * B, h, w, C)
        net = self.canonicalization_network
        elements, gather = range(G), lambda v: v
        stats_group = "same"
        if self.orbit_sharding is not None:
            elements, gather = self._orbit_share(G, B)
            mine = slice(elements[0] * B, (elements[-1] + 1) * B) if elements else slice(0, 0)
            x_aug = x_aug[mine]
            if artifact_idx is not None:
                artifact_idx = artifact_idx[mine]
            stats_group = None  # every rank of the mesh holds orbit rows
        with orbit_shard(G, elements, stats_group):
            vector_out = net(x_aug, training, generator)
            if self.artifact_err_wt:
                # a random rotation and its inverse isolate the warp artifacts
                if artifact_idx is None:
                    if generator is None:
                        raise ValueError(
                            "artifact_err_wt > 0 draws random rotations: pass "
                            "generator= or artifact_idx= to canonicalize")
                    artifact_idx = sharded_draw(lambda s: torch.randint(
                        0, n, s, generator=generator, device=generator.device),
                        (x_aug.shape[0],))
                oh = F.one_hot(artifact_idx.to(x_aug.device).long(), n).to(x_aug.dtype)
                x_dummy = rotate_discrete(x_aug, oh, n, -1.0, self.padding_mode)
                x_dummy = rotate_discrete(x_dummy, oh, n, 1.0, self.padding_mode)
                dummy = net(x_dummy, training, generator)
        vector_out = gather(vector_out)
        extras = {"vector_out": vector_out}
        if self.artifact_err_wt:
            extras["vector_out_dummy"] = gather(dummy)
        ref = self.reference_vector
        vn = vector_out / (
            torch.linalg.vector_norm(vector_out, dim=-1, keepdim=True) + 1e-12)
        rn = ref / (torch.linalg.vector_norm(ref, dim=-1, keepdim=True) + 1e-12)
        scalar = torch.sum(vn * rn, dim=-1)  # (G * B,)
        return scalar.reshape(G, B).T, extras  # (B, G), group-major unflatten

    def _orbit_share(self, G: int, B: int):
        """(this rank's orbit elements, the gather of every share's rows)
        on the active mesh's (group, data) axes."""
        import numpy as np

        from equiadapt_tpu_torch.parallel.mesh import axis_size, current_mesh

        mesh = current_mesh()
        group_axis, data_axis = self.orbit_sharding
        names = getattr(mesh, "mesh_dim_names", None) or ()
        if group_axis not in names or data_axis not in names:
            raise ValueError(
                f"orbit_sharding {self.orbit_sharding} needs an active mesh with "
                f"those axes (parallel.data_parallel_jit on a make_mesh_group "
                f"mesh); active: {names or None}")
        shares = [list(map(int, a)) for a in
                  np.array_split(np.arange(G), axis_size(mesh, group_axis))]
        mine = shares[mesh.get_local_rank(group_axis)]
        group = mesh.get_group(group_axis)
        sizes = [len(e) * B for e in shares]
        return mine, lambda v: all_gather_rows(v, sizes, group)


def optimization_specific_loss(info: DiscreteCanonicalizationInfo, *,
                               out_vector_size: int,
                               artifact_err_wt: float = 0.0) -> Tensor:
    """Orthogonality (+ rotation-artifact) loss of the optimized
    canonicalizer: the mean |V V^T| over the off-diagonal pairs of each
    sample's orbit vectors, plus `artifact_err_wt` times the MSE between the
    dummy and the clean vectors."""
    vectors = info.extras["vector_out"]  # (G * B, D)
    G = info.num_group
    v = vectors.reshape(G, -1, out_vector_size).transpose(0, 1)  # (B, G, D)
    distances = torch.einsum("bgd,bhd->bgh", v, v)
    mask = 1.0 - torch.eye(G, dtype=distances.dtype, device=distances.device)
    loss = torch.mean(torch.abs(distances * mask))
    if artifact_err_wt:
        dummy = info.extras["vector_out_dummy"]
        loss = loss + artifact_err_wt * torch.mean((dummy - vectors) ** 2)
    return loss
