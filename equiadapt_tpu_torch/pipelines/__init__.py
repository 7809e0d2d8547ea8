"""Pipelines: canonicalizer plus prediction network (eval halves)."""

from equiadapt_tpu_torch.pipelines.classification import (
    ImageClassifierPipeline,
    classification_loss,
    group_inference,
    make_eval_step,
    vanilla_inference,
)
from equiadapt_tpu_torch.pipelines.pointcloud import (
    PointcloudClassificationPipeline,
    classification_metrics,
    random_rotate,
)

__all__ = ["ImageClassifierPipeline", "classification_loss", "group_inference",
           "make_eval_step", "vanilla_inference",
           "PointcloudClassificationPipeline", "classification_metrics",
           "random_rotate"]
