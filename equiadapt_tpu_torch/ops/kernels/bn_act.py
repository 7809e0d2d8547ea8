"""Eval BatchNorm, an optional residual and ReLU in one hand-written pass.

For y (N, C, H, W), the raw output of a convolution, and the BatchNorm
`bn` that follows it in eval, the output is

    relu(y s_a + t_a [+ r] [+ r s_b + t_b]),
    s = weight / sqrt(running_var + eps),  t = bias - running_mean s

of each BatchNorm, in one of three forms: "none" (no residual), "identity"
(r, a residual block's input, added) and "projected" (r a projection's raw
convolution output, with its own BatchNorm `residual_bn`). That is
`torch.relu(bn(y) [+ r] [+ residual_bn(r)])` with eval statistics, which
PyTorch runs as three to five passes over the activation.

`bn_act` launches the kernel of `csrc/bn_act.cu` for CUDA tensors: y and r
channels-last contiguous, 16-byte aligned, bf16 or fp32, C % 8 == 0 and
C <= MAX_CHANNELS; the BatchNorms' fp32 parameters and statistics read as
they are, s and t derived inside the kernel (no host-side precompute, no
cache to keep in step with the weights); arithmetic in fp32, one rounding
at the store, into a new channels-last tensor (y is left as it is). CPU
tensors take `bn_act_plain`, the same arithmetic in PyTorch, which the
kernel matches operation for operation. `takes` decides, from what a call
can observe, whether a ResNet site (`models.resnet`) launches the kernel or
composes the modules as before. The kernel replaces no TPU kernel: XLA fuses
these passes into the JAX package's convolutions. Its source says what
bounds it and how it is built.

`launches` counts the launches by dtype (`launches["bn_act/bfloat16"]`),
`path_launches` by dtype and form (`path_launches["bn_act/bfloat16/identity"]`).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence

import torch

from equiadapt_tpu_torch.ops.kernels import _build

Tensor = torch.Tensor

__all__ = ["bn_act", "bn_act_plain", "takes", "launches", "path_launches", "reset_launches",
           "FORMS", "MAX_CHANNELS"]

_KERNELS = "the BatchNorm-residual-ReLU kernel"
_DIFFERENTIABLE = "the composed modules are the differentiable path, and `takes` sends " \
                  "a call under grad mode there"
FORMS = ("none", "identity", "projected")
# channels a thread; a block holds a whole row of C channels (256 threads)
VEC = 8
MAX_CHANNELS = 2048

# kernel launches by dtype and by dtype and form, e.g. launches["bn_act/bfloat16"],
# path_launches["bn_act/bfloat16/projected"]
launches: Dict[str, int] = {}
path_launches: Dict[str, int] = {}


def reset_launches() -> None:
    launches.clear()
    path_launches.clear()


def _on_card(t: Tensor) -> bool:
    return t.device.type == "cuda"


def _fits(t: Tensor) -> bool:
    """The kernel's layout: 4-D channels-last contiguous, bf16 or fp32,
    C % VEC == 0 and C <= MAX_CHANNELS, 16-byte aligned within its storage
    (read from the offset, not the pointer, so that a `torch.export` trace
    of fake tensors decides as a call on the card does; `_launch` checks
    the pointer)."""
    return (t.dim() == 4 and t.dtype in _build.DTYPE_CODES and t.shape[1] % VEC == 0
            and t.shape[1] <= MAX_CHANNELS and (t.storage_offset() * t.element_size()) % 16 == 0
            and t.is_contiguous(memory_format=torch.channels_last))


def takes(y: Tensor, training: bool, residual: Optional[Tensor] = None) -> bool:
    """True when a BatchNorm-(residual-)ReLU site of a ResNet launches the
    kernel for y (and its residual): eval (`training` False) with grad mode
    off, on the card, y in the kernel's layout (`_fits`) and the residual,
    if any, of y's shape, dtype and device in the same layout. Any other
    call composes the modules (the present path), which autograd, train-mode
    statistics, the CPU and other layouts need."""
    if training or torch.is_grad_enabled() or not _on_card(y) or not _fits(y):
        return False
    return residual is None or (residual.shape == y.shape and residual.dtype == y.dtype
                                and residual.device == y.device and _fits(residual))


def _form(residual: Optional[Tensor], r_params: Sequence[Tensor]) -> str:
    """The kernel's form for a call: "none", "identity" or "projected"."""
    return "none" if residual is None else "projected" if r_params else "identity"


def _args(y: Tensor, bn, residual: Optional[Tensor], residual_bn):
    """(params, r_params, r_eps) of a call, checked: the BatchNorms'
    (weight, bias, running_mean, running_var) in fp32 (a module cast to
    bf16 keeps its values; the kernel reads fp32), r_params empty without a
    residual BatchNorm."""
    if residual is None and residual_bn is not None:
        raise ValueError("a residual BatchNorm needs a residual")
    if y.dim() != 4:
        raise ValueError(f"y (N, C, H, W), got {tuple(y.shape)}")
    params = [bn.weight, bn.bias, bn.running_mean, bn.running_var]
    r_params = [] if residual_bn is None else [residual_bn.weight, residual_bn.bias,
                                               residual_bn.running_mean,
                                               residual_bn.running_var]
    params = [p if p.dtype == torch.float32 else p.float() for p in params]
    r_params = [p if p.dtype == torch.float32 else p.float() for p in r_params]
    C = y.shape[1]
    for p in (*params, *r_params):
        if p.shape != (C,):
            raise ValueError(f"BatchNorm parameters and statistics ({C},), got {tuple(p.shape)}")
    if residual is not None and (residual.shape != y.shape or residual.dtype != y.dtype):
        raise ValueError(f"a residual of y's shape and dtype {tuple(y.shape)} {y.dtype}, got "
                         f"{tuple(residual.shape)} {residual.dtype}")
    return params, r_params, float(residual_bn.eps) if residual_bn is not None else 0.0


def _affine(params: Sequence[Tensor], eps: float):
    """(s, t) as (C, 1, 1) fp32: s = weight / sqrt(var + eps), t = bias - mean s."""
    w, b, m, v = (p.float() for p in params)
    s = w / torch.sqrt(v + eps)
    t = b - m * s
    return s[:, None, None], t[:, None, None]


def _plain(y: Tensor, params: Sequence[Tensor], eps: float, residual: Optional[Tensor],
           r_params: Sequence[Tensor], r_eps: float) -> Tensor:
    s, t = _affine(params, eps)
    out = y.float() * s + t
    if residual is not None:
        r = residual.float()
        if r_params:
            rs, rt = _affine(r_params, r_eps)
            r = r * rs + rt
        out = out + r
    return torch.relu(out).to(y.dtype)


def bn_act_plain(y: Tensor, bn, residual: Optional[Tensor] = None,
                 residual_bn=None) -> Tensor:
    """The kernel's function in PyTorch (module docstring), in fp32 with
    one rounding to y's dtype at the end, each operation in the kernel's
    order. `bn` and `residual_bn` are BatchNorm modules (their `weight`,
    `bias`, `running_mean`, `running_var` and `eps` are read)."""
    params, r_params, r_eps = _args(y, bn, residual, residual_bn)
    return _plain(y, params, float(bn.eps), residual, r_params, r_eps)


def _fake(y, params, eps, residual, r_params, r_eps):
    return torch.empty_like(y, memory_format=torch.channels_last)


def bn_act(y: Tensor, bn, residual: Optional[Tensor] = None, residual_bn=None) -> Tensor:
    """`relu(bn(y) [+ residual] [+ residual_bn(residual)])` in eval (module
    docstring): the kernel for CUDA tensors, `bn_act_plain` for CPU
    tensors; a new tensor of y's shape and dtype. Meta tensors inside
    `_build.shapes_only()` give an empty result of that shape."""
    params, r_params, r_eps = _args(y, bn, residual, residual_bn)
    tensors = [y, *params, *r_params] + ([residual] if residual is not None else [])
    where = _build.route(tensors, _KERNELS)
    if where == "meta":
        return _fake(y, params, bn.eps, residual, r_params, r_eps)
    if where == "cpu":
        return _plain(y, params, float(bn.eps), residual, r_params, r_eps)
    _build.refuse_grad(tensors, _KERNELS, _DIFFERENTIABLE)
    return _bn_act_op(y, params, float(bn.eps), residual, r_params, r_eps)


# the kernel as a registered operator around `_launch` (`_build.register_op`)
_bn_act_op = _build.register_op(
    "bn_act(Tensor y, Tensor[] params, float eps, Tensor? residual, Tensor[] r_params, "
    "float r_eps) -> Tensor",
    lambda *args: _launch(*args), _fake)


def _count(dtype: torch.dtype, form: str) -> None:
    key = f"bn_act/{str(dtype).removeprefix('torch.')}"
    launches[key] = launches.get(key, 0) + 1
    path = f"{key}/{form}"
    path_launches[path] = path_launches.get(path, 0) + 1


def _validate_launch(y: Tensor, params: Sequence[Tensor], residual: Optional[Tensor],
                     r_params: Sequence[Tensor]) -> None:
    """What the kernel takes beyond `_args`: y and the residual in its
    layout (`_fits`), the parameters fp32 and contiguous."""
    for name, t in (("y", y), ("residual", residual)):
        if t is not None and not (_fits(t) and t.data_ptr() % 16 == 0):
            raise ValueError(
                f"{_KERNELS} takes channels-last contiguous bf16 or fp32 {name} with C % {VEC} "
                f"== 0 and C <= {MAX_CHANNELS} from a 16-byte aligned start, got "
                f"{tuple(t.shape)} {t.dtype} strides {t.stride()}")
    for p in (*params, *r_params):
        if p.dtype != torch.float32 or not p.is_contiguous():
            raise TypeError(f"{_KERNELS} reads contiguous fp32 BatchNorm parameters and "
                            f"statistics, got {p.dtype} strides {p.stride()}")


def _lib() -> ctypes.CDLL:
    lib = _build.load("bn_act")
    fn = lib.eqt_bn_act
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, ctypes.POINTER(vp), ctypes.c_float, ctypes.c_float,
                       ctypes.c_longlong, ci, ci, ci, vp]
        fn.restype = ci
    return lib


def _launch(y: Tensor, params: List[Tensor], eps: float, residual: Optional[Tensor],
            r_params: List[Tensor], r_eps: float) -> Tensor:
    form = _form(residual, r_params)
    _validate_launch(y, params, residual, r_params)
    out = torch.empty_like(y, memory_format=torch.channels_last)
    N, C, H, W = y.shape
    ptrs = (ctypes.c_void_p * 8)(*[p.data_ptr() for p in params],
                                 *([p.data_ptr() for p in r_params] or [None] * 4))
    err = _lib().eqt_bn_act(
        y.data_ptr(), residual.data_ptr() if residual is not None else None, out.data_ptr(),
        ptrs, eps, r_eps, N * H * W, C, FORMS.index(form), _build.DTYPE_CODES[y.dtype],
        torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bn_act launch failed: cudaError {err}")
    _count(y.dtype, form)
    return out
