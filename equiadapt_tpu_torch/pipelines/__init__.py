"""Pipelines: canonicalizer plus prediction network."""

from equiadapt_tpu_torch.pipelines.classification import (
    ImageClassifierPipeline,
    TrainState,
    classification_loss,
    create_train_state,
    group_inference,
    make_eval_step,
    make_optimizer,
    make_train_step,
    to_network_layout,
    vanilla_inference,
)
from equiadapt_tpu_torch.pipelines.nbody import (
    NBodyPipeline,
    create_nbody_state,
    make_nbody_train_step,
    nbody_eval_mse,
)
from equiadapt_tpu_torch.pipelines.pointcloud import (
    PointcloudClassificationPipeline,
    PointcloudPartSegPipeline,
    classification_metrics,
    create_pointcloud_state,
    make_pointcloud_train_step,
    pointcloud_loss,
    random_point_dropout,
    random_rotate,
    random_scale_shift,
)
from equiadapt_tpu_torch.pipelines.segmentation import (
    ImageSegmentationPipeline,
    create_segmentation_state,
    make_segmentation_train_step,
    mask_iou_map_metric,
    mean_average_precision_segm,
    segmentation_group_inference,
    segmentation_task_loss,
)

__all__ = ["ImageClassifierPipeline", "TrainState", "classification_loss",
           "create_train_state", "group_inference", "make_eval_step",
           "make_optimizer", "make_train_step", "to_network_layout",
           "vanilla_inference",
           "NBodyPipeline", "create_nbody_state", "make_nbody_train_step",
           "nbody_eval_mse",
           "PointcloudClassificationPipeline", "PointcloudPartSegPipeline",
           "classification_metrics", "create_pointcloud_state",
           "make_pointcloud_train_step", "pointcloud_loss",
           "random_point_dropout", "random_rotate", "random_scale_shift",
           "ImageSegmentationPipeline", "create_segmentation_state",
           "make_segmentation_train_step", "mask_iou_map_metric",
           "mean_average_precision_segm", "segmentation_group_inference",
           "segmentation_task_loss"]
