"""The port's public surface against the JAX package's, module by module.

One case for each module of `equiadapt_tpu/` (its `ops/pallas/` modules
map to the port's `ops/kernels/`). Each case imports the JAX module and
its port counterpart and checks that

* every public JAX name (the module's `__all__`, else every name it binds
  that is not a module, a `typing` construct under its own name or a
  `__future__` feature) exists in the port module;
* every field of each exported dataclass (Flax modules without `parent`
  and `name`, Flax structs, config dataclasses), and every parameter of
  each exported function or other class, is a parameter of the port's
  counterpart (or the counterpart takes `**kwargs`).

The deliberate exceptions are listed below, one reason each; nothing else
is excused.

The last test holds the port's test files themselves to their CPU-thread
rule (`tests/torch_port_cpu.py`).
"""

import ast
import dataclasses
import functools
import importlib
import inspect
import types
import typing
from pathlib import Path

import flax.linen as fnn
import pytest
import torch
from torch_port_cpu import one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
JAX_MODULES = sorted(
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    for p in (REPO / "equiadapt_tpu").rglob("*.py"))

# JAX modules with no port module
NO_PORT_MODULE = {
    "equiadapt_tpu.kernel_options": "the port has no backend switch: a CUDA tensor "
                                    "launches its kernel or raises",
}

# public JAX names with no port counterpart: module -> {name: reason}
NO_PORT_NAME = {
    "equiadapt_tpu": {
        name: "the port has no backend switch"
        for name in ("kernel_options", "KernelOptions", "current_kernel_options")},
    "equiadapt_tpu.ops.pallas.select_warp": {
        "rotate_select_nchw": "the TPU's NCHW entry; the port's `rotate_select` reads "
                              "NCHW memory through its strides (K1)"},
    "equiadapt_tpu.ops.pallas.bilinear_warp": {
        "exact_warp_tiling": "the TPU kernel's lane tiling; K7 has its own launch "
                             "paths (`_path`)"},
    "equiadapt_tpu.ops.pallas.knn": {
        "knn_fused_supported": "a TPU capability probe; K8 serves every shape"},
    "equiadapt_tpu.utils.flops": {
        "jaxpr_flops": "walks a JAX jaxpr; the port counts from its modules"},
}
# TPU-only entry points of `ops/pallas/`: the Pallas calls themselves
TPU_ONLY_PREFIX = "pallas_"
# type and helper imports a JAX module binds at its top level
IMPORTED = {"Array": "`jax.Array`, a type alias of the JAX module",
            "FrozenDict": "Flax's variable container",
            "partial": "`functools.partial`, imported"}

# JAX parameters the port's counterparts do not take: name -> reason
NO_PORT_PARAM = {
    "rng": "a `jax.random` key; the port takes a `torch.Generator` (`generator`)",
    "jit": "the port compiles nothing; its steps run eagerly",
    "platforms": "StableHLO lowering platforms; a torch.export artifact runs on "
                 "the device it was exported on",
    "create_perfetto_link": "a JAX profiler option; the port's trace is torch.profiler's",
    "interpret": "runs a Pallas kernel in interpret mode; the port's route follows "
                 "the tensor's device",
    "use_pallas": "chooses the Pallas or the XLA form; the port's route follows the "
                  "tensor's device",
}
# parameters of the functions whose JAX form takes Flax or optax state:
# (function, parameter) -> reason
_INIT = ("Flax initialises from a key and a sample; a torch module holds its "
         "weights when it is built")
_STATE = "Flax's TrainState; the port passes the torch module, which holds its weights"
NO_PORT_STATE_PARAM = {
    ("create_train_state", "pipeline"): _STATE + " (`model`)",
    ("create_train_state", "sample_batch"): _INIT,
    ("create_train_state", "init_rngs"): _INIT,
    ("create_nbody_state", "sample"): _INIT,
    ("create_pointcloud_state", "sample"): _INIT,
    ("create_segmentation_state", "sample_images"): _INIT,
    ("create_segmentation_state", "sample_targets"): _INIT,
    **{(f, "tx"): "an optax transformation; the port builds its optimizers from "
                  "`learning_rate` and `weight_decay`"
       for f in ("create_nbody_state", "create_pointcloud_state",
                 "create_segmentation_state")},
    ("make_train_step", "rng_names"): "Flax's random streams; the port's step draws "
                                      "from one `torch.Generator`",
    ("vanilla_inference", "state"): _STATE,
    ("group_inference", "state"): _STATE,
    ("lr_find", "create_state"): _STATE + " (`model`)",
    ("lr_find", "optimizer"): "an optax constructor; the port's range test ramps AdamW",
    ("convert_resnet_checkpoint", "variables"): "a Flax tree; the port fills a state "
                                                "dict (`template`)",
    ("load_pretrained_prediction", "variables"): "a Flax tree; the port fills a state "
                                                 "dict (`template`)",
    ("convert_vit_checkpoint", "params"): "a Flax tree; the port fills a state dict "
                                          "(`template`)",
    ("convert_sam_checkpoint", "params"): "a Flax tree; the port fills the module "
                                          "(`model`)",
}
# exported dataclass fields the port's counterparts do not take:
# (class, field) -> reason
NO_PORT_FIELD = {
    **{(cls, "dtype"): "the Flax module's compute dtype; a torch module computes in "
                       "its parameters' dtype (`.to(dtype)`)"
       for cls in ("BasicBlock", "Bottleneck", "EncoderBlock", "ViT")},
    ("VNStdFeature", "dim"): "unused by the JAX module",
    **{("TrainState", f): "Flax's TrainState; the port's holds the torch module, "
                          "its optimizers and schedulers"
       for f in ("apply_fn", "params", "tx", "opt_state", "batch_stats")},
}


def port_module_name(name: str) -> str:
    return ("equiadapt_tpu_torch" + name.removeprefix("equiadapt_tpu")).replace(
        ".ops.pallas.", ".ops.kernels.")


def public_names(module: types.ModuleType):
    names = getattr(module, "__all__", None)
    if names is not None:
        return list(names)
    out = []
    for key, value in vars(module).items():
        if key.startswith("_") or isinstance(value, types.ModuleType):
            continue
        if getattr(typing, key, None) is value or type(value).__name__ == "_Feature":
            continue
        out.append(key)
    return out


def jax_parameters(obj):
    """(kind, names) of what a call of `obj` may name: "field" for a
    dataclass's fields (a Flax module's, or a partial of one, without
    Flax's `parent` and `name`), "param" for a function's or class's
    parameters; None for what takes no arguments (constants)."""
    cls = obj.func if isinstance(obj, functools.partial) else obj
    if inspect.isclass(cls) and dataclasses.is_dataclass(cls):
        skip = {"parent", "name"} if issubclass(cls, fnn.Module) else set()
        return "field", [f.name for f in dataclasses.fields(cls)
                         if f.init and f.name not in skip]
    if callable(obj):
        try:
            sig = inspect.signature(obj)
        except (TypeError, ValueError):
            return None
        return "param", [p.name for p in sig.parameters.values()
                         if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
    return None


def port_accepts(obj):
    """The parameter names `obj` takes, or None when it takes **kwargs."""
    params = inspect.signature(obj).parameters.values()
    if any(p.kind == p.VAR_KEYWORD for p in params):
        return None
    return {p.name for p in params}


@pytest.mark.parametrize("name", JAX_MODULES)
def test_port_has_the_jax_modules_surface(name):
    jmod = importlib.import_module(name)
    pname = port_module_name(name)
    if name in NO_PORT_MODULE:
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(pname)
        return
    pmod = importlib.import_module(pname)
    excused = NO_PORT_NAME.get(name, {})
    missing, refused = [], []
    for key in public_names(jmod):
        if key in excused or key in IMPORTED or key.startswith(TPU_ONLY_PREFIX):
            continue
        if not hasattr(pmod, key):
            missing.append(key)
            continue
        jobj, pobj = getattr(jmod, key), getattr(pmod, key)
        spec = jax_parameters(jobj)
        if spec is None:
            continue
        kind, wanted = spec
        accepted = port_accepts(pobj)
        if accepted is None:
            continue
        for p in wanted:
            if p in accepted:
                continue
            if kind == "field" and (key, p) in NO_PORT_FIELD:
                continue
            if kind == "param" and (p in NO_PORT_PARAM
                                    or (key, p) in NO_PORT_STATE_PARAM):
                continue
            refused.append(f"{key}({p}=)")
    assert not missing, f"{pname} lacks {missing}"
    assert not refused, f"{pname} refuses {refused}"


def test_every_listed_exception_is_still_needed():
    """Each excused name is public in its JAX module and absent from the
    port, so the list shrinks when the port grows."""
    for name, excused in NO_PORT_NAME.items():
        jmod = importlib.import_module(name)
        pmod = importlib.import_module(port_module_name(name))
        for key in excused:
            assert key in public_names(jmod), (name, key)
            assert not hasattr(pmod, key), (name, key)


def test_every_port_test_file_runs_on_one_intra_op_thread():
    """Every `tests/test_torch_port_*.py` imports `one_intra_op_thread` from
    `tests/torch_port_cpu.py` at its top level, and none sets torch's
    thread count itself: the torch setters that module calls appear in no
    port test file."""
    here = Path(__file__).parent
    shared = ast.parse((here / "torch_port_cpu.py").read_text())
    setters = {node.attr for node in ast.walk(shared)
               if isinstance(node, ast.Attribute) and node.attr.startswith("set_")}
    assert setters
    files = sorted(here.glob("test_torch_port_*.py"))
    assert files
    unpinned, setting = [], []
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        if not any(isinstance(node, ast.ImportFrom) and node.module == "torch_port_cpu"
                   and any(a.name == "one_intra_op_thread" and a.asname is None
                           for a in node.names)
                   for node in tree.body):
            unpinned.append(path.name)
        if any(isinstance(node, ast.Attribute) and node.attr in setters
               for node in ast.walk(tree)):
            setting.append(path.name)
    assert not unpinned, f"do not import the shared thread fixture: {unpinned}"
    assert not setting, f"set torch's thread count themselves: {setting}"
    assert torch.get_num_threads() == 1
