"""Pipelines: canonicalizer plus prediction network (eval halves)."""

from equiadapt_tpu_torch.pipelines.pointcloud import (
    PointcloudClassificationPipeline,
    classification_metrics,
    random_rotate,
)

__all__ = ["PointcloudClassificationPipeline", "classification_metrics",
           "random_rotate"]
