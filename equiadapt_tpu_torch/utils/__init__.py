"""Utilities: the config taxonomy, the registries and weights carried across
from the JAX package."""

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
from equiadapt_tpu_torch.utils.jax_weights import flax_variables, load_flax_variables
from equiadapt_tpu_torch.utils.registry import (
    get_image_canonicalization_network,
    get_image_canonicalizer,
    get_image_prediction_network,
    get_nbody_canonicalizer,
    get_nbody_prediction_network,
    get_pointcloud_canonicalizer,
    get_pointcloud_prediction_network,
    get_segmentation_prediction_network,
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
