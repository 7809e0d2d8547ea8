"""Data: the n-body simulators, the synthetic batches, the point-cloud
dataset loaders, the COCO reader and rectangles task (`data.coco`) and (in
`data.images` and `data.autoaugment`) the image dataset loaders."""

from equiadapt_tpu_torch.data.coco import (
    load_coco_annotations,
    resize_and_pad,
    synthetic_coco_batch,
)
from equiadapt_tpu_torch.data.nbody_sim import (
    generate_nbody_dataset,
    simulate_charged,
    simulate_springs,
)
from equiadapt_tpu_torch.data.pointcloud import (
    load_modelnet40,
    load_shapenet_part,
    normalize_pointcloud,
)
from equiadapt_tpu_torch.data.synthetic import (
    batch_iterator,
    synthetic_image_batch,
    synthetic_pointcloud_batch,
)

__all__ = [
    "load_coco_annotations",
    "resize_and_pad",
    "synthetic_coco_batch",
    "generate_nbody_dataset",
    "simulate_charged",
    "simulate_springs",
    "load_modelnet40",
    "load_shapenet_part",
    "normalize_pointcloud",
    "batch_iterator",
    "synthetic_image_batch",
    "synthetic_pointcloud_batch",
]
