"""Utilities: the config taxonomy, the registries and weights carried across
from the JAX package.

The registries and the weight loader are bound at first use: they import
the networks and canonicalizers, which import `utils.profiling`, so binding
them here would import this package inside its own import."""

import importlib

from equiadapt_tpu_torch.utils.config import (
    CanonicalizationConfig,
    CheckpointConfig,
    Config,
    DatasetConfig,
    ExperimentConfig,
    NetworkHyperparams,
    PredictionConfig,
    TrainingLossConfig,
    compose_config,
    load_yaml,
)
from equiadapt_tpu_torch.utils.export import (
    export_apply,
    export_sharded_apply,
    load_exported,
)

__all__ = [
    "CanonicalizationConfig",
    "CheckpointConfig",
    "Config",
    "DatasetConfig",
    "ExperimentConfig",
    "NetworkHyperparams",
    "PredictionConfig",
    "TrainingLossConfig",
    "compose_config",
    "load_yaml",
    "export_apply",
    "export_sharded_apply",
    "load_exported",
    "flax_variables",
    "load_flax_variables",
    "get_image_canonicalization_network",
    "get_image_canonicalizer",
    "get_image_prediction_network",
    "get_pointcloud_canonicalizer",
    "get_pointcloud_prediction_network",
    "get_segmentation_prediction_network",
    "get_nbody_canonicalizer",
    "get_nbody_prediction_network",
]

_LAZY = {
    "flax_variables": "jax_weights",
    "load_flax_variables": "jax_weights",
    **{name: "registry" for name in __all__ if name.startswith("get_")},
}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
    globals()[name] = value
    return value
