"""Data, FSDP, tensor, pipeline and orbit-axis parallelism over
`torch.distributed` (one process a rank: NCCL on the card, gloo on the
CPU), with the JAX package's public names (`equiadapt_tpu/parallel/`),
and `spawn`, which starts a run's local ranks."""

from equiadapt_tpu_torch.parallel.mesh import (
    data_parallel_jit,
    init_distributed,
    make_mesh,
    replicate,
    shard_batch,
)

from equiadapt_tpu_torch.parallel.fsdp import (
    fsdp_sharding,
    shard_params_fsdp,
    shard_state_fsdp,
)

from equiadapt_tpu_torch.parallel.group_parallel import (
    group_sharded_inference,
    make_mesh_group,
    orbit_spec,
)

from equiadapt_tpu_torch.parallel.pp import (
    make_mesh_stage,
    pipeline_apply,
    stack_layer_params,
    vit_pipeline_apply,
)

from equiadapt_tpu_torch.parallel.tp import (
    check_tp_coverage,
    make_mesh_2d,
    sam_tp_spec,
    shard_params_tp,
    shard_state_tp,
    vit_tp_spec,
)

from equiadapt_tpu_torch.parallel.launch import spawn

__all__ = [
    "data_parallel_jit",
    "init_distributed",
    "make_mesh",
    "replicate",
    "shard_batch",
    "fsdp_sharding",
    "shard_params_fsdp",
    "shard_state_fsdp",
    "group_sharded_inference",
    "make_mesh_group",
    "orbit_spec",
    "make_mesh_stage",
    "pipeline_apply",
    "stack_layer_params",
    "vit_pipeline_apply",
    "make_mesh_2d",
    "sam_tp_spec",
    "check_tp_coverage",
    "shard_params_tp",
    "shard_state_tp",
    "vit_tp_spec",
    "spawn",
]
