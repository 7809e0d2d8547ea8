"""Carry weights from a Flax variable tree into the port's modules.

`load_flax_variables(module, variables)` takes the Flax
`{"params": ..., "batch_stats": ...}` tree as nested dicts of numpy arrays
(convert JAX arrays with `np.asarray` first; nothing here imports JAX) and
fills the torch module in place. The port's submodules carry the names
Flax gives their counterparts, so a leaf's path names its torch owner:

* `nn.Conv2d`: `kernel` HWIO -> `weight` OIHW, `bias` as is;
* `nn.ConvTranspose2d` (Flax `ConvTranspose`, kernel 2, stride 2):
  `kernel` (kh, kw, in, out) flipped in space -> `weight` (in, out, kh, kw),
  since Flax's transposed conv applies its kernel unflipped;
* `nn.Linear`: `kernel` (in, out) -> `weight` (out, in);
* BatchNorm: `scale` / `bias` -> `weight` / `bias`, batch stats `mean` /
  `var` -> `running_mean` / `running_var`;
* GCNN layers: `weights` and `bias` copied as they are (same shapes);
* steerable layers, copied as they are: `SteerableConv` `w_{fo}_{fi}`
  (J, 2), `NormNonlinearity` `bias_{fi}` (1,), `NormBatchNorm` `scale`
  (params) and `norm_sq` (batch_stats). `NormBatchNorm` is not a torch
  BatchNorm, so its leaves never take the BatchNorm renaming;
* `VNBilinear` `bilinear` (C1, C2, out) copied as it is;
* `nn.MultiHeadDotProductAttention`'s `query` / `key` / `value` / `out`
  (the port's `models.egnn.DenseGeneral`, a Linear over flattened axes):
  `kernel` (d, heads, head_dim) or (heads, head_dim, d) -> `weight`
  (out, in) of the flattened kernel, `bias` flattened;
* `nn.LayerNorm`: `scale` / `bias` -> `weight` / `bias`;
* `nn.Embed`: `embedding` (num, features) -> `weight`;
* a raw parameter of any other owner, copied as it is when the owner has a
  parameter of that name (the optimized canonicalizer's own
  `reference_vector` (1, D), beside its network's leaves; the transformers'
  `pos_embedding`, `cls_token`, `rel_pos_h`, ...). A `SamAttention` built
  with use_rel_pos=False has no `rel_pos_*` tables, as its Flax tree has
  no such leaves, so the two trees match both ways.

A module whose torch names differ from its Flax names (SAM's encoder, named
after SAM's torch tree) carries `flax_aliases`, {Flax name: torch path}
for its children; paths are translated through them both ways.

It raises on a leaf it cannot place and on a torch parameter or persistent
buffer left unfilled (other than BatchNorm's `num_batches_tracked`).
Non-persistent buffers (constants built from the configuration) are not
weights and are not filled.

`flax_variables(module)` is the inverse: the module's parameters and
BatchNorm statistics as a Flax-path tree of numpy arrays (fp32), in Flax's
layouts, for comparing a trained port with a trained Flax model.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from equiadapt_tpu_torch.images.networks.group_conv import _GroupConvBase
from equiadapt_tpu_torch.images.networks.steerable import (
    NormBatchNorm,
    NormNonlinearity,
    SteerableConv,
)
from equiadapt_tpu_torch.models.egnn import DenseGeneral
from equiadapt_tpu_torch.pointcloud.vector_neurons import VNBilinear

__all__ = ["load_flax_variables", "flax_placements", "flax_variables",
           "FlaxLeaf", "flax_leaf_layouts", "flax_flat_index"]

_BN_NAMES = {
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}

_LN_NAMES = {"scale": "weight", "bias": "bias"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _convert(owner: nn.Module, collection: str, leaf: str, value: np.ndarray):
    """(torch attribute name, array in torch layout) for one Flax leaf."""
    if isinstance(owner, nn.modules.batchnorm._BatchNorm):
        name = _BN_NAMES.get((collection, leaf))
        if name is not None:
            return name, value
    elif collection == "params" and isinstance(owner, DenseGeneral):
        if leaf == "kernel":
            return "weight", value.reshape(owner.in_features, owner.out_features).T
        if leaf == "bias":
            return "bias", value.reshape(-1)
    elif collection == "params" and isinstance(owner, nn.LayerNorm):
        if leaf in ("scale", "bias"):
            return _LN_NAMES[leaf], value
    elif collection == "params" and isinstance(owner, nn.Embedding):
        if leaf == "embedding":
            return "weight", value
    elif collection == "params" and isinstance(owner, nn.ConvTranspose2d):
        if leaf == "kernel":
            return "weight", value[::-1, ::-1].transpose(2, 3, 0, 1)
        if leaf == "bias":
            return "bias", value
    elif collection == "params" and isinstance(owner, nn.Conv2d):
        if leaf == "kernel":
            return "weight", value.transpose(3, 2, 0, 1)
        if leaf == "bias":
            return "bias", value
    elif collection == "params" and isinstance(owner, nn.Linear):
        if leaf == "kernel":
            return "weight", value.T
        if leaf == "bias":
            return "bias", value
    elif collection == "params" and isinstance(owner, _GroupConvBase):
        if leaf in ("weights", "bias"):
            return leaf, value
    elif collection == "params" and isinstance(owner, (SteerableConv,
                                                       NormNonlinearity)):
        return leaf, value  # a name the module lacks fails as an extra leaf
    elif collection == "params" and isinstance(owner, VNBilinear):
        if leaf == "bilinear":
            return leaf, value
    elif isinstance(owner, NormBatchNorm):
        if (collection, leaf) in (("params", "scale"), ("batch_stats", "norm_sq")):
            return leaf, value
    elif collection == "params" and leaf in dict(owner.named_parameters(recurse=False)):
        return leaf, value
    raise KeyError(
        f"no place for Flax leaf {collection}/{leaf} in {type(owner).__name__}"
    )


def _torch_scope(module: nn.Module, scope) -> list:
    """The torch path of a Flax scope, through each owner's `flax_aliases`."""
    out, node = [], module
    for key in scope:
        path = getattr(node, "flax_aliases", {}).get(key, key)
        node = node.get_submodule(path)
        out += path.split(".")
    return out


def _flax_scope(module: nn.Module, parts) -> list:
    """The Flax scope of a torch path (the inverse of `_torch_scope`)."""
    out, node, i = [], module, 0
    while i < len(parts):
        key, n = parts[i], 1
        for flax_name, path in getattr(node, "flax_aliases", {}).items():
            steps = path.split(".")
            if list(parts[i:i + len(steps)]) == steps:
                key, n = flax_name, len(steps)
                break
        node = node.get_submodule(".".join(parts[i:i + n]))
        out.append(key)
        i += n
    return out


def _targets(module: nn.Module) -> Dict[str, torch.Tensor]:
    return {
        n: t for n, t in module.state_dict(keep_vars=True).items()
        if not n.endswith("num_batches_tracked")
    }


def flax_placements(module: nn.Module,
                    variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """{torch tensor name: array in torch layout} for every Flax leaf,
    after checking that every leaf has a tensor of its shape and every
    tensor a leaf; raises otherwise. Nothing is copied."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unknown Flax collections: {sorted(unknown)}")
    filled: Dict[str, np.ndarray] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            *scope, leaf = path
            try:
                scope = _torch_scope(module, scope)
                owner = module.get_submodule(".".join(scope))
            except AttributeError as e:
                raise KeyError(
                    f"no submodule for Flax leaf {collection}/{'/'.join(path)}"
                ) from e
            name, array = _convert(owner, collection, leaf, value)
            filled[".".join(scope + [name])] = array

    targets = _targets(module)
    missing = sorted(set(targets) - set(filled))
    if missing:
        raise KeyError(f"torch tensors left unfilled: {missing}")
    extra = sorted(set(filled) - set(targets))
    if extra:
        raise KeyError(f"Flax leaves with no torch tensor: {extra}")
    for name, array in filled.items():
        if tuple(targets[name].shape) != array.shape:
            raise ValueError(
                f"{name}: torch shape {tuple(targets[name].shape)}, "
                f"Flax shape {array.shape}"
            )
    return filled


def load_flax_variables(module: nn.Module,
                        variables: Mapping[str, Any]) -> nn.Module:
    """Fill `module` from a Flax variable tree of numpy arrays; returns it."""
    filled = flax_placements(module, variables)
    targets = _targets(module)
    with torch.no_grad():
        for name, array in filled.items():
            targets[name].copy_(torch.from_numpy(np.array(array)))
    return module


_BN_LEAVES = {v: k for k, v in _BN_NAMES.items()}
_LN_LEAVES = {v: k for k, v in _LN_NAMES.items()}


def _unconvert(owner: nn.Module, name: str, value: np.ndarray):
    """(collection, Flax leaf, array in Flax layout) for one torch tensor."""
    if isinstance(owner, nn.modules.batchnorm._BatchNorm):
        return (*_BN_LEAVES[name], value)
    if isinstance(owner, DenseGeneral):
        if name == "weight":
            return "params", "kernel", value.T.reshape(owner.kernel_shape)
        return "params", "bias", value.reshape(owner.bias_shape)
    if isinstance(owner, nn.LayerNorm):
        return "params", _LN_LEAVES[name], value
    if isinstance(owner, nn.Embedding) and name == "weight":
        return "params", "embedding", value
    if isinstance(owner, nn.ConvTranspose2d) and name == "weight":
        return "params", "kernel", value.transpose(2, 3, 0, 1)[::-1, ::-1].copy()
    if isinstance(owner, nn.Conv2d) and name == "weight":
        return "params", "kernel", value.transpose(2, 3, 1, 0)
    if isinstance(owner, nn.Linear) and name == "weight":
        return "params", "kernel", value.T
    if isinstance(owner, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)) and name == "bias":
        return "params", "bias", value
    if isinstance(owner, NormBatchNorm) and name == "norm_sq":
        return "batch_stats", name, value
    if name in dict(owner.named_parameters(recurse=False)):
        return "params", name, value
    raise KeyError(f"no Flax leaf for {type(owner).__name__}.{name}")


def flax_variables(module: nn.Module) -> Dict[str, Dict[str, Any]]:
    """{"params": ..., "batch_stats": ...} of `module` as nested dicts of
    fp32 numpy arrays keyed by Flax paths; the inverse of
    `load_flax_variables`."""
    out: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for name, tensor in _targets(module).items():
        *scope, attr = name.split(".")
        owner = module.get_submodule(".".join(scope))
        value = tensor.detach().float().cpu().numpy().copy()  # a snapshot
        collection, leaf, array = _unconvert(owner, attr, value)
        node = out[collection]
        for key in _flax_scope(module, scope):
            node = node.setdefault(key, {})
        node[leaf] = array
    if not out["batch_stats"]:
        del out["batch_stats"]
    return out


class FlaxLeaf(NamedTuple):
    """A torch tensor's Flax leaf: `name` (torch), `collection`, `path`
    (Flax names), `shape` (Flax layout) and `dims[f]`, the torch dimension
    along which Flax dimension f runs (None for a dimension of size 1)."""

    name: str
    collection: str
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    dims: Tuple[Optional[int], ...]


def flax_flat_index(module: nn.Module, name: str) -> Tuple[FlaxLeaf, np.ndarray]:
    """Tensor `name` of `module` as its Flax leaf, and the tensor's flat
    torch index at each position of the Flax leaf (the loader's layout
    change carried out on the indices)."""
    tensor = _targets(module)[name]
    *scope, attr = name.split(".")
    owner = module.get_submodule(".".join(scope))
    shape = tuple(tensor.shape)
    idx = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.int64).reshape(shape)
    collection, leaf, flat = _unconvert(owner, attr, idx)
    dims = []
    for f in range(flat.ndim):
        if flat.shape[f] < 2:
            dims.append(None)
            continue
        step = abs(int(np.take(flat, 1, axis=f).flat[0]) - int(np.take(flat, 0, axis=f).flat[0]))
        moved = [t for t, v in enumerate(np.unravel_index(step, shape)) if v]
        dims.append(moved[0] if len(moved) == 1 else None)
    return FlaxLeaf(name, collection, tuple(_flax_scope(module, scope)) + (leaf,),
                    tuple(flat.shape), tuple(dims)), flat


def flax_leaf_layouts(module: nn.Module) -> List[FlaxLeaf]:
    """Every parameter and persistent buffer of `module` as its Flax leaf."""
    return [flax_flat_index(module, name)[0] for name in _targets(module)]
