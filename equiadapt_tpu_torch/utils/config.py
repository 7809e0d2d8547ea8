"""Config taxonomy: dataclass mirror of the reference's Hydra config groups.

The port's own copy of `equiadapt_tpu/utils/config.py` (the port imports
nothing of the JAX package): the same frozen dataclasses, key names and
defaults, so a config composed here equals the JAX package's field for
field. The groups are canonicalization / experiment / dataset / prediction /
checkpoint (examples/images/classification/configs/), with
`to_dict` / `from_dict` for checkpoint embedding.

YAML loading is supported via `load_yaml` (plain pyyaml, imported when
called); CLI overrides use dotted `key=value` pairs like Hydra's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


def _asdict(obj) -> Dict[str, Any]:
    return dataclasses.asdict(obj)


@dataclass(frozen=True)
class NetworkHyperparams:
    """canonicalization.network_hyperparams group
    (configs/canonicalization/*.yaml)."""

    kernel_size: int = 3
    out_channels: int = 16
    num_layers: int = 2
    group_type: str = "rotation"
    num_rotations: int = 4
    out_vector_size: int = 128
    n_knn: int = 20
    pooling: str = "mean"
    # "exact" / "fused" / "approx": the JAX package's kNN modes; in the port
    # all three compute exact first-occurrence kNN (kernel K8 on the card)
    knn_mode: str = "exact"
    # serving-mode energy: 2x2/s2 avg pool after the GCNN lift (exactly
    # rot90-equivariant on even sizes; 4x cheaper group convs)
    pool_after_lift: bool = False
    # round-3 serving preset: fold the pool INTO the lift filters (stride-2
    # conv; the full-resolution lift output is never materialized)
    fused_pool_lift: bool = False
    hidden_dim: int = 16
    layer_pooling: str = "mean"
    final_pooling: str = "mean"
    nonlinearity: str = "relu"
    canon_feature: str = "p"
    canon_translation: bool = False
    dropout: float = 0.0
    out_dim: int = 4


@dataclass(frozen=True)
class CanonicalizationConfig:
    """canonicalization group: type x network_type
    (examples/images/common/utils.py:25-118 registry keys)."""

    canonicalization_type: str = "group_equivariant"
    network_type: str = "e2cnn"
    network_hyperparams: NetworkHyperparams = field(default_factory=NetworkHyperparams)
    beta: float = 1.0
    input_crop_ratio: float = 1.0
    resize_shape: Optional[int] = None
    gradient_trick: str = "straight_through"
    learn_ref_vec: bool = False
    artifact_err_wt: float = 0.0
    # "exact" = torch-parity 4-tap warps; "fast" = two-pass product warps
    warp_mode: str = "exact"
    # computation dtype name for energy net + warps ("bfloat16"); None = input
    compute_dtype: Optional[str] = None
    # canonicalized-output dtype: None = cast back to the input dtype;
    # "compute" = keep compute_dtype (serving: avoids a bf16->fp32->bf16
    # convert pair feeding a bf16 prediction network)
    output_dtype: Optional[str] = None
    # pointcloud only: SE(3) canonicalization (centroid removed before the
    # rotation; invert adds it back). False = reference SO(3) behavior
    # (reference pointcloud/canonicalization/continuous_group.py:1-2 states
    # rotation-only as a proof-of-concept limitation).
    enable_translation: bool = False


@dataclass(frozen=True)
class TrainingLossConfig:
    """experiment.training.loss weights (experiment/default.yaml: task /
    prior=100 / group_contrast)."""

    task_weight: float = 1.0
    prior_weight: float = 100.0
    group_contrast_weight: float = 0.0


@dataclass(frozen=True)
class ExperimentConfig:
    """experiment group (run_mode, seed, devices, loss weights, inference)."""

    run_mode: str = "train"  # train | test | dryrun | auto_tune
    seed: int = 0
    num_epochs: int = 1
    batch_size: int = 128
    learning_rate: float = 1e-3
    canonicalization_learning_rate: float = 1e-3
    weight_decay: float = 0.0
    num_nodes: int = 1
    num_devices: int = 1
    loss: TrainingLossConfig = field(default_factory=TrainingLossConfig)
    inference_method: str = "vanilla"  # vanilla | group
    num_group_elements_for_inference: int = 4
    # profiler trace of the first training steps or of the serving CLI's
    # timed batches, with the spans report (utils/profiling.py)
    profile: bool = False
    profile_dir: str = "/tmp/eqt_profile"
    # per-subtree gradient norms in the step metrics — the reference's
    # wandb.watch(model, log="all") analog (train.py:92-97)
    watch_gradients: bool = False


@dataclass(frozen=True)
class DatasetConfig:
    dataset_name: str = "synthetic"
    data_path: str = "./data"
    image_size: int = 32
    num_classes: int = 10
    in_channels: int = 3
    num_points: int = 1024
    num_nodes_graph: int = 5
    augment: str = "none"


@dataclass(frozen=True)
class PredictionConfig:
    architecture: str = "resnet50"  # resnet50 | resnet18 | vit
    freeze_encoder: bool = False
    pretrained: bool = False
    # local torchvision checkpoint (.pth) converted via models/convert.py
    # when pretrained=true (reference model_utils.py loads weights="DEFAULT";
    # this environment has no egress, so the file must be provided)
    pretrained_path: str = ""
    hidden_dim: int = 64
    num_layers: int = 4
    # computation dtype name ("bfloat16" for the production serving mode);
    # None keeps fp32 (params are always fp32)
    dtype: Optional[str] = None
    # rematerialize prediction-network activations on backward (memory vs
    # ~1/3 extra forward FLOPs — pipelines/classification.py remat field)
    remat: bool = False


@dataclass(frozen=True)
class CheckpointConfig:
    checkpoint_path: str = "./checkpoints"
    checkpoint_name: str = ""
    save_canonized_images: bool = False
    strict_loading: bool = True
    # resume an interrupted run from the newest step under checkpoint_path
    # (async step-indexed saves via AsyncTrainCheckpointer); the crash-resume
    # analog of Lightning's ckpt_path="last"
    resume: bool = False


@dataclass(frozen=True)
class Config:
    """Top-level config (the Hydra defaults-list composition)."""

    canonicalization: CanonicalizationConfig = field(default_factory=CanonicalizationConfig)
    experiment: ExperimentConfig = field(default_factory=ExperimentConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    prediction: PredictionConfig = field(default_factory=PredictionConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)

    def to_dict(self) -> Dict[str, Any]:
        return _asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Config":
        return Config(
            canonicalization=_cfg_from(CanonicalizationConfig, d.get("canonicalization", {})),
            experiment=_cfg_from(ExperimentConfig, d.get("experiment", {})),
            dataset=_cfg_from(DatasetConfig, d.get("dataset", {})),
            prediction=_cfg_from(PredictionConfig, d.get("prediction", {})),
            checkpoint=_cfg_from(CheckpointConfig, d.get("checkpoint", {})),
        )

    def override(self, *assignments: str) -> "Config":
        """Apply Hydra-style dotted overrides: 'experiment.seed=3'."""
        d = self.to_dict()
        for a in assignments:
            key, _, raw = a.partition("=")
            parts = key.split(".")
            node = d
            for p in parts[:-1]:
                node = node[p]
            node[parts[-1]] = _parse_value(raw)
        return Config.from_dict(d)

    def merged(self, partial: Dict[str, Any]) -> "Config":
        """Deep-merge a partial nested dict (e.g. a YAML group file) over
        this config; unknown keys are ignored (the reference's Hydra configs
        carry framework-specific keys like `device`/`core`)."""
        d = self.to_dict()
        _deep_update(d, partial)
        return Config.from_dict(d)


def _cfg_from(cls, d: Dict[str, Any]):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if dataclasses.is_dataclass(f.type) or f.name in (
            "network_hyperparams", "loss",
        ):
            sub_cls = {"network_hyperparams": NetworkHyperparams, "loss": TrainingLossConfig}[f.name]
            v = _cfg_from(sub_cls, v) if isinstance(v, dict) else v
        kwargs[f.name] = v
    return cls(**kwargs)


def _parse_value(raw: str) -> Any:
    r = raw.strip()
    if r.lower() in ("true", "false"):
        return r.lower() == "true"
    if r.lower() in ("null", "none"):
        return None
    try:
        return int(r)
    except ValueError:
        pass
    try:
        return float(r)
    except ValueError:
        pass
    return r


def _deep_update(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v


def load_yaml(path: str) -> Config:
    """Load a config YAML (same key taxonomy as the reference's groups)."""
    import yaml

    with open(path) as f:
        return Config.from_dict(yaml.safe_load(f))


def compose_config(
    argv,
    config_dir: Optional[str] = None,
    base=(),
    start: Optional[Config] = None,
) -> Config:
    """Hydra-style config composition for the example CLIs.

    Mirrors the reference's `@hydra.main(config_path="./configs")` +
    defaults-list semantics (reference examples/*/configs/default.yaml):

    * `config=<path>`    — merge a full YAML file over the defaults;
    * `<group>=<name>`   — bare (dot-free) selector resolving to
      `<config_dir>/<group>/<name>.yaml`, merged as that group's subtree
      (e.g. `canonicalization=opt_group_equivariant`, the reference's
      primary override style from its README run commands);
    * `a.b.c=value`      — dotted leaf overrides, applied LAST so the CLI
      always wins over files (Hydra's override order).

    `base` holds the example's built-in defaults (applied first); `start`
    replaces the dataclass defaults as the root config (e.g. a config
    restored from a checkpoint).
    """
    import os

    import yaml

    cfg = (start if start is not None else Config()).override(*base)
    dotted = []
    for a in argv:
        key, sep, val = a.partition("=")
        if not sep:
            raise ValueError(f"override '{a}' is not of the form key=value")
        if key == "config":
            with open(val) as f:
                cfg = cfg.merged(yaml.safe_load(f) or {})
        elif "." not in key:
            if config_dir is None:
                raise ValueError(
                    f"group override '{a}' needs a configs/ directory"
                )
            path = os.path.join(config_dir, key, f"{val}.yaml")
            if not os.path.isfile(path):
                raise FileNotFoundError(
                    f"config group file not found: {path}"
                )
            with open(path) as f:
                group = yaml.safe_load(f) or {}
            # accept both group-file styles: bare content (the reference's
            # Hydra convention) and content wrapped in the group key
            if set(group) == {key}:
                group = group[key]
            cfg = cfg.merged({key: group})
        else:
            dotted.append(a)
    return cfg.override(*dotted)


def load_env_file(path: str = ".env") -> Dict[str, str]:
    """Parse a .env of `export KEY=value` lines into os.environ
    (the reference's python-dotenv flow, train_utils.py:133-143; recognized
    keys: DATA_PATH, CHECKPOINT_PATH, WANDB_* ...)."""
    import os

    loaded = {}
    if not os.path.isfile(path):
        return loaded
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith("export "):
                line = line[len("export "):]
            key, _, val = line.partition("=")
            val = val.strip().strip('"').strip("'")
            os.environ[key.strip()] = val
            loaded[key.strip()] = val
    return loaded


def apply_env_paths(cfg: Config) -> Config:
    """Fill dataset/checkpoint paths from DATA_PATH / CHECKPOINT_PATH env."""
    import os

    overrides = []
    if os.environ.get("DATA_PATH"):
        overrides.append(f"dataset.data_path={os.environ['DATA_PATH']}")
    if os.environ.get("CHECKPOINT_PATH") and not cfg.checkpoint.checkpoint_path:
        overrides.append(f"checkpoint.checkpoint_path={os.environ['CHECKPOINT_PATH']}")
    return cfg.override(*overrides) if overrides else cfg
