"""`torch.export` artifacts of serving functions (the deployment path).

Counterpart of `equiadapt_tpu/utils/export.py`, which lowers a jitted
function to serialized StableHLO. Here `export_apply` traces
`apply_fn(variables, batch)` with `torch.export.export` as the forward of
a closure module that holds `variables` (a module's parameters and buffers
become the program's state, any other tensor a constant), so the artifact
is self-contained: no Python model code, the weights baked in. It is
returned as the bytes of `torch.export.save`:

    blob = export_apply(lambda pipe, x: pipe(x, training=False)[0], pipe, sample)
    pathlib.Path("model.pt2").write_bytes(blob)
    # ... on the serving host:
    import equiadapt_tpu_torch  # registers the kernels' operators
    fn = load_exported(blob)
    logits = fn(batch)

The hand kernels stay in the artifact. Every kernel wrapper launches
through a custom operator registered with `torch.library`
(`torch.ops.eqt.*`, `ops/kernels/_build.register_op`) whose fake
implementation gives the output's shape, so a trace on the card records
each launch as a graph node, at a fixed batch and at a symbolic one alike;
the JAX package's fallback to XLA blends for symbolic batches has no
counterpart. Loading an artifact needs `equiadapt_tpu_torch` imported,
which registers the operators (this module's import does); no other module
of the model is needed.

The JAX function's `platforms` has no torch counterpart: an artifact runs
on the device it was traced on (tensors made inside the function, and
every kernel launch, are bound to it). Export on the card to serve on the
card, on the CPU (plain versions of the kernels) to serve on the CPU.
`export_sharded_apply` needs a device mesh, which the port does not have
yet (`parallel/`, ROADMAP.md item 16), and raises.
"""

from __future__ import annotations

import io
from typing import Any, Callable

import torch
import torch.utils._pytree as pytree
from torch import nn

__all__ = ["export_apply", "export_sharded_apply", "load_exported"]


class _Closure(nn.Module):
    """`apply_fn(variables, batch)` as a module's forward; a module in
    `variables` is registered, so its tensors are the program's state."""

    def __init__(self, apply_fn: Callable[..., Any], variables: Any):
        super().__init__()
        self.apply_fn = apply_fn
        self.variables = variables

    def forward(self, batch):
        return self.apply_fn(self.variables, batch)


def _batch_dims(sample: Any):
    """A dynamic-shape spec marking axis 0 of every tensor leaf of `sample`."""

    def poly(leaf):
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"symbolic_batch takes tensor leaves, got {type(leaf).__name__}")
        if leaf.dim() == 0:
            raise ValueError(
                "symbolic_batch needs every sample leaf to carry the batch on "
                f"axis 0; got a scalar leaf {leaf!r}")
        return {0: torch.export.Dim.DYNAMIC}

    return pytree.tree_map(poly, sample)


def export_apply(apply_fn: Callable[..., Any], variables: Any, sample: Any, *,
                 symbolic_batch: bool = False) -> bytes:
    """Serialize `apply_fn(variables, sample)` to a `torch.export` artifact.

    Args:
        apply_fn: function of (variables, batch), e.g.
            ``lambda pipe, x: pipe(x, training=False)[0]``; traced under
            `torch.no_grad()`.
        variables: a module or tensors, baked into the artifact (re-export
            after finetuning).
        sample: an example batch (a tensor or a pytree of them) fixing the
            shapes, dtypes and device.
        symbolic_batch: trace axis 0 of every `sample` leaf as a dynamic
            dimension, so one artifact serves any batch size; a scalar leaf
            raises.

    Returns:
        The bytes of `torch.export.save` of the exported program.
    """
    module = _Closure(apply_fn, variables)
    dynamic = (_batch_dims(sample),) if symbolic_batch else None
    with torch.no_grad():
        program = torch.export.export(module, (sample,), dynamic_shapes=dynamic)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_sharded_apply(apply_fn: Callable[..., Any], variables: Any, sample: Any,
                         mesh: Any, *, axis_name: str = "data") -> bytes:
    """A data-parallel artifact over a device mesh: not ported yet."""
    raise NotImplementedError(
        "export_sharded_apply needs a device mesh (parallel/), not ported yet "
        "(ROADMAP.md item 16)")


def load_exported(data: bytes) -> Callable[..., Any]:
    """Deserialize an `export_apply` artifact into a callable of the batch.

    It runs on the device the artifact was traced on and takes batches of
    the traced shapes and dtypes (any batch size with `symbolic_batch`)."""
    module = torch.export.load(io.BytesIO(bytes(data))).module()

    def fn(batch):
        with torch.no_grad():
            return module(batch)

    return fn
