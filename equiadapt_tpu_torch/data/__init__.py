"""Data: the n-body simulators, the synthetic batches and (in `data.images`
and `data.autoaugment`) the image dataset loaders."""

from equiadapt_tpu_torch.data.nbody_sim import (
    generate_nbody_dataset,
    simulate_charged,
    simulate_springs,
)
from equiadapt_tpu_torch.data.synthetic import (
    batch_iterator,
    synthetic_image_batch,
    synthetic_pointcloud_batch,
)

__all__ = [
    "generate_nbody_dataset",
    "simulate_charged",
    "simulate_springs",
    "batch_iterator",
    "synthetic_image_batch",
    "synthetic_pointcloud_batch",
]
