"""Tensor-parallel (Megatron) sharding of transformer prediction networks.

Counterpart of `equiadapt_tpu/parallel/tp.py`. The rules are the JAX
package's regexes over Flax paths (`vit_tp_spec` for `models.ViT`'s
`EncoderBlock_i` / `MultiHeadDotProductAttention_0`, `sam_tp_spec` for SAM's
encoder `block{i}/attn` and `lin1` / `lin2`), read off the port's modules
through `utils.jax_weights.flax_leaf_layouts`, and return the JAX
`PartitionSpec` of each leaf. `shard_params_tp` then does Megatron by hand
on a 2-D ("data", "model") mesh of ranks:

* each rank keeps its heads' slice of the query / key / value projections
  and of `out` (of SAM's packed qkv, its heads from each of the q, k and v
  segments), and its slice of the MLP's hidden units (`Dense_0` / `lin1`
  columns, `Dense_1` / `lin2` rows), with a local head count;
* the module's forward becomes the tensor-parallel one: its input goes
  through an identity whose backward all-reduces over the model axis, its
  partial output through an all-reduce whose backward is the identity, and
  the output bias is added once after it. SAM's relative-position tables,
  used by every head, take the same identity-forward / all-reduce-backward
  so their gradients are whole. The MLP's dropout mask is drawn at the
  full width and sliced, so every rank drops what the unsharded block
  drops.

A sharded parameter is a plain tensor holding the rank's slice, with its
placement in `param.tp_shard` (`TPShard`): the torch dimension, this
rank's indices along it, the full size, the model axis' process group, and
every rank's indices (for gathering a full checkpoint). Its gradient is
averaged over the data axis only by `parallel.data_parallel_jit`.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from equiadapt_tpu_torch.parallel.mesh import PartitionSpec as P
from equiadapt_tpu_torch.parallel.mesh import axis_size, make_grid, rebind_optimizers
from equiadapt_tpu_torch.utils.jax_weights import flax_flat_index, flax_leaf_layouts

__all__ = [
    "make_mesh_2d",
    "vit_tp_spec",
    "sam_tp_spec",
    "shard_params_tp",
    "shard_state_tp",
    "check_tp_coverage",
    "TPShard",
]

SpecFn = Callable[[str, Tuple[int, ...]], Optional[P]]


def make_mesh_2d(n_data: int, n_model: int,
                 axis_names: Tuple[str, str] = ("data", "model")):
    """(n_data, n_model) mesh of the world's ranks; the model axis is the
    inner one (neighbouring ranks, the same node)."""
    return make_grid((n_data, n_model), axis_names)


_QKV_KERNEL = re.compile(r"MultiHeadDotProductAttention_\d+/(query|key|value)/kernel$")
_QKV_BIAS = re.compile(r"MultiHeadDotProductAttention_\d+/(query|key|value)/bias$")
_OUT_KERNEL = re.compile(r"MultiHeadDotProductAttention_\d+/out/kernel$")
_MLP_UP = re.compile(r"EncoderBlock_\d+/Dense_0/(kernel|bias)$")
_MLP_DOWN_KERNEL = re.compile(r"EncoderBlock_\d+/Dense_1/kernel$")


def vit_tp_spec(path: str, shape: Tuple[int, ...], axis: str = "model") -> Optional[P]:
    """Megatron split of the Flax ViT / EncoderBlock layout, per Flax leaf
    path and shape; None for a replicated leaf."""
    if _QKV_KERNEL.search(path) and len(shape) == 3:
        return P(None, axis, None)  # (D, heads, head_dim)
    if _QKV_BIAS.search(path) and len(shape) == 2:
        return P(axis, None)  # (heads, head_dim)
    if _OUT_KERNEL.search(path) and len(shape) == 3:
        return P(axis, None, None)  # (heads, head_dim, D)
    if _MLP_UP.search(path):
        if len(shape) == 2:
            return P(None, axis)  # (D, mlp_dim)
        if len(shape) == 1:
            return P(axis)  # (mlp_dim,)
    if _MLP_DOWN_KERNEL.search(path) and len(shape) == 2:
        return P(axis, None)  # (mlp_dim, D)
    return None


_SAM_QKV = re.compile(r"block\d+/attn/qkv/(kernel|bias)$")
_SAM_PROJ = re.compile(r"block\d+/attn/proj/kernel$")
_SAM_LIN1 = re.compile(r"block\d+/lin1/(kernel|bias)$")
_SAM_LIN2 = re.compile(r"block\d+/lin2/kernel$")


def sam_tp_spec(path: str, shape: Tuple[int, ...], axis: str = "model") -> Optional[P]:
    """Megatron split of SAM's ViT encoder (block{i}/attn/{qkv,proj},
    lin1 / lin2), per Flax leaf path and shape. The packed qkv output
    (3 C) is split over the model axis; `shard_params_tp` gives each rank
    its heads from each of the q, k and v segments."""
    if _SAM_QKV.search(path):
        return P(None, axis) if len(shape) == 2 else P(axis)
    if _SAM_PROJ.search(path) and len(shape) == 2:
        return P(axis, None)
    if _SAM_LIN1.search(path):
        return P(None, axis) if len(shape) == 2 else P(axis)
    if _SAM_LIN2.search(path) and len(shape) == 2:
        return P(axis, None)
    return None


_TP_FAMILY = re.compile(
    r"(EncoderBlock_\d+|MultiHeadDotProductAttention_\d+|block\d+/(attn|lin[12]))")
_TP_REPLICATED_OK = re.compile(r"rel_pos")


def _param_leaves(tree: Any) -> List[Tuple[str, Tuple[int, ...]]]:
    """(Flax path, Flax shape) of each parameter leaf of a module, or of a
    nested dict of arrays keyed by Flax names."""
    if isinstance(tree, nn.Module):
        return [("/".join(leaf.path), leaf.shape) for leaf in flax_leaf_layouts(tree)
                if leaf.collection == "params"]
    out = []

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (str(k),))
            else:
                out.append(("/".join(prefix + (str(k),)), tuple(np.shape(v))))

    walk(tree, ())
    return out


def check_tp_coverage(tree: Any, spec_fn: SpecFn = vit_tp_spec) -> list:
    """Raise unless the rules cover the transformer trunk: (a) some leaf
    matched a rule, (b) no matrix leaf inside a transformer-block family
    was left without a spec (a renamed sublayer would be replicated
    silently). `tree`: a module or a Flax-named dict of arrays. Returns
    the matched paths."""
    matched, missed = [], []
    for p, shape in _param_leaves(tree):
        if spec_fn(p, shape) is not None:
            matched.append(p)
        elif _TP_FAMILY.search(p) and len(shape) >= 2 and not _TP_REPLICATED_OK.search(p):
            missed.append(p)
    if not matched:
        raise ValueError(
            "TP coverage: no parameter leaf matched any sharding rule — "
            "wrong spec_fn for this parameter tree?")
    if missed:
        raise ValueError(
            "TP coverage: matrix leaves inside transformer blocks got no "
            f"sharding spec (renamed sublayer?): {missed[:8]}")
    return matched


@dataclass
class TPShard:
    """Where a tensor-parallel parameter's slice lies: along torch `dim`,
    at `index` (this rank's) of `size`; `indices` every model rank's, in
    rank order; `group` the model axis' process group."""

    dim: int
    index: torch.Tensor
    size: int
    indices: List[torch.Tensor]
    group: Any


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all-reduce backward over the model axis."""
    return x if dist.get_world_size(group) == 1 else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce forward over the model axis, identity backward."""
    return x if dist.get_world_size(group) == 1 else _ReduceFromModel.apply(x, group)


def _row_parallel(linear: nn.Linear, x: torch.Tensor, group) -> torch.Tensor:
    """A linear layer whose input features are split: the partial product
    all-reduced, then the bias."""
    y = reduce_from_model(F.linear(x, linear.weight), group)
    return y if linear.bias is None else y + linear.bias


def _tp_classes():
    """{unsharded class: its tensor-parallel subclass}."""
    from equiadapt_tpu_torch.models.egnn import MultiHeadDotProductAttention
    from equiadapt_tpu_torch.models.sam_encoder import SamAttention, _Mlp
    from equiadapt_tpu_torch.models.vit import EncoderBlock

    class TPMultiHeadDotProductAttention(MultiHeadDotProductAttention):
        def forward(self, x, kv=None, training=False, generator=None):
            g = self.tp_group
            kv = None if kv is None else copy_to_model(kv, g)
            return _row_parallel(self.out, self._attend(copy_to_model(x, g), kv,
                                                        training, generator), g)

    class TPEncoderBlock(EncoderBlock):
        def forward(self, x, training=False, generator=None):
            g = self.tp_group
            h = self.LayerNorm_0(x)
            x = x + self.MultiHeadDotProductAttention_0(h, training=training,
                                                        generator=generator)
            h = F.gelu(self.Dense_0(copy_to_model(self.LayerNorm_1(x), g)))
            h = self.dropout(h, training, generator)
            return x + _row_parallel(self.Dense_1, h, g)

    class TPSamAttention(SamAttention):
        def forward(self, x):
            B, H, W, C = x.shape
            out = self._attend(copy_to_model(x, self.tp_group))
            return _row_parallel(self.proj, out, self.tp_group).reshape(B, H, W, C)

        def _rel_pos(self):
            return (copy_to_model(self.rel_pos_h, self.tp_group),
                    copy_to_model(self.rel_pos_w, self.tp_group))

    class TPMlp(_Mlp):
        def forward(self, x):
            g = self.tp_group
            return _row_parallel(self.lin2, F.gelu(self.lin1(copy_to_model(x, g))), g)

    return {MultiHeadDotProductAttention: TPMultiHeadDotProductAttention,
            EncoderBlock: TPEncoderBlock, SamAttention: TPSamAttention, _Mlp: TPMlp}


def _indices(module: nn.Module, name: str, f: int, flat: np.ndarray, torch_dim: int,
             n: int) -> List[torch.Tensor]:
    """Every model rank's indices along `torch_dim` of tensor `name`
    whose Flax dimension `f` is split over n ranks (`flat`: the tensor's
    flat index at each Flax position)."""
    from equiadapt_tpu_torch.models.sam_encoder import SamAttention

    size = module.get_parameter(name).shape[torch_dim]
    *scope, attr = name.split(".")
    owner = module.get_submodule(".".join(scope[:-1])) if scope else None
    if scope and scope[-1] == "qkv" and isinstance(owner, SamAttention):
        # each rank takes its heads from each of the q, k and v segments
        c = size // 3
        return [torch.cat([torch.arange(s * c + r * c // n, s * c + (r + 1) * c // n)
                           for s in range(3)]) for r in range(n)]
    shape = module.get_parameter(name).shape
    k = flat.shape[f] // n
    out = []
    for r in range(n):
        chunk = np.take(flat, np.arange(r * k, (r + 1) * k), axis=f)
        coords = np.unique(np.unravel_index(chunk.ravel(), shape)[torch_dim])
        if chunk.size != coords.size * (flat.size // size):
            raise ValueError(f"TP: {name}'s slice is not whole rows of torch dim {torch_dim}")
        out.append(torch.from_numpy(coords))
    return out


def shard_params_tp(tree: nn.Module, mesh, spec_fn: SpecFn = vit_tp_spec,
                    axis_name: str = "model") -> nn.Module:
    """Shard a module's parameters for tensor parallelism by `spec_fn`
    over `axis_name` of `mesh` (in place; returned): each matched leaf
    keeps this rank's slice (`TPShard` in `param.tp_shard`) and its
    module's forward becomes the tensor-parallel one. Raises if a matched
    dimension is not divisible by the model-axis size, or a sharded leaf
    lies in a module with no tensor-parallel forward."""
    n, rank = axis_size(mesh, axis_name), mesh.get_local_rank(axis_name)
    group = mesh.get_group(axis_name)
    tp_cls = _tp_classes()
    touched = {}
    for leaf in flax_leaf_layouts(tree):
        if leaf.collection != "params":
            continue
        path = "/".join(leaf.path)
        spec = spec_fn(path, leaf.shape)
        if spec is None:
            continue
        for d, s in enumerate(spec):
            if s is not None and leaf.shape[d] % n != 0:
                raise ValueError(f"TP: {path} dim {d} ({leaf.shape[d]}) not divisible "
                                 f"by model axis size {n}")
        (f,) = [d for d, s in enumerate(spec) if s is not None]
        _, flat = flax_flat_index(tree, leaf.name)
        dim = leaf.dims[f]
        indices = _indices(tree, leaf.name, f, flat, dim, n)
        *scope, attr = leaf.name.split(".")
        owner = tree.get_submodule(".".join(scope))
        old = getattr(owner, attr)
        new = nn.Parameter(old.detach().index_select(dim, indices[rank].to(old.device))
                           .clone(), requires_grad=old.requires_grad)
        new.tp_shard = TPShard(dim, indices[rank], old.shape[dim], indices, group)
        setattr(owner, attr, new)
        parent = ".".join(scope[:-1])
        touched[parent] = tree.get_submodule(parent) if parent else tree
    for name, module in touched.items():
        cls = tp_cls.get(type(module))
        if cls is None:
            raise ValueError(f"TP: {name} ({type(module).__name__}) has sharded "
                             "parameters but no tensor-parallel forward")
        module.__class__ = cls
        module.tp_group = group
        if hasattr(module, "num_heads"):
            module.num_heads //= n
        if hasattr(module, "Dense_0") and hasattr(module, "dropout"):
            shard = module.Dense_0.weight.tp_shard  # the hidden units
            module.dropout.feature_index, module.dropout.feature_size = shard.index, shard.size
    return tree


def shard_state_tp(state: Any, mesh, spec_fn: SpecFn = vit_tp_spec,
                   axis_name: str = "model") -> Any:
    """Shard a `TrainState` for tensor parallelism (in place; returned):
    the model's parameters by `shard_params_tp`, the optimizers' moments
    sliced with them; BatchNorm statistics and the step count stay
    replicated."""

    def moment(value, old, new):
        shard = getattr(new, "tp_shard", None)
        if shard is None or value.shape != old.shape:
            return value
        return value.index_select(shard.dim, shard.index.to(value.device)).clone()

    with rebind_optimizers(state, moment):
        shard_params_tp(state.model, mesh, spec_fn, axis_name)
    return state
