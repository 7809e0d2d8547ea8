"""equiadapt_tpu_torch: the PyTorch/CUDA port of equiadapt_tpu.

Same modules, public names and functional contract as the JAX package
(NHWC tensors; `canonicalize` returns `(x_canon, info)`;
`invert_canonicalization(info, y)` undoes it), written for an NVIDIA H100:
plain tensor work is PyTorch, and each Pallas TPU kernel on a ported path is
a hand-written CUDA kernel under `csrc/`, built with nvcc at first use.
Modules default to `device="cuda"`; pass `device="cpu"` explicitly to run the
plain PyTorch versions of the kernels on the CPU.

Ported so far:
* the discrete (C_n / D_n) path: GCNN energy -> hard select ->
  rotate-select (kernel K3 for an NHWC-contiguous batch, K1 for a view of
  NCHW memory) -> prediction network -> regular-rep invert (kernel K2),
  and its training: straight-through / Gumbel selection, the one-hot warp
  blend, train-mode BatchNorm and dropout, the differentiable fused invert
  (`invert_regular_fast_diff`, K2 forward and backward), the select
  kernels' backward;
* the continuous (SO(2) / O(2)) steerable path: steerable network ->
  rotation matrix -> warp, exact (kernel K7) or fast (kernels K5 + K6) ->
  prediction network -> scalar invert (the same warp kernels), and its
  training: train-mode `NormBatchNorm`, the differentiable fast warp
  (`warp_center_rotation_fast_diff`: K5 + K6 forward, and on the image's
  cotangent), the exact warp differentiated through its sample
  coordinates, and the optimized (self-supervised) steerable canonicalizer
  with `steerable_optimization_loss`;
* the SO(3) point-cloud path: VNSmall frame estimation (kNN graph by
  kernel K8) -> Gram-Schmidt -> x @ R^T -> PointNet or DGCNN (kNN graphs
  by K8) -> point-valued invert y @ R, the DGCNN part segmenter
  (`DGCNNPartSeg`, `PointcloudPartSegPipeline`), and their training: the
  augmentations, train-mode VN and DGCNN BatchNorm, dropout,
  `create_pointcloud_state` and `make_pointcloud_train_step`, the
  ModelNet40 / ShapeNet-Part loaders and the CLIs `python -m
  equiadapt_tpu_torch.cli.pointcloud_train` and `.partseg_train`;
* the optimized (orbit-scoring) discrete canonicalizer: the batch's
  |G|-orbit (kernel K4 for quarter turns, static warps otherwise) ->
  `ConvNetwork` -> cosine scores against a reference vector -> select
  (kernel K1 on NCHW memory, K3 on NHWC);
* the n-body family: the charged-particle and spring simulators on the
  device (`data`), VN-DeepSets and the SE(3) `EuclideanGroupNBody`
  (`nbody`), the EGNN-style GNN, MLP and Transformer predictors
  (`models.egnn`), `NBodyPipeline` with its train step, the checkpoint
  and metric harness (`utils.checkpoint`, `utils.metrics`) and the CLI
  `python -m equiadapt_tpu_torch.cli.nbody_train` (no kernel on its path);
* the segmentation path (BASELINE config 5): the discrete canonicalizer
  with targets (boxes and masks co-canonicalized; the masks through K1) ->
  `SAMLite` (the light ViT encoder or SAM's ViT encoder, box prompts, the
  two-way mask decoder) -> `ImageSegmentationPipeline.invert_masks` (K1),
  the prior-regularized train step, the mAP group sweep, the SAM
  checkpoint converters, ViT, the rectangles data and the CLI `python -m
  equiadapt_tpu_torch.cli.segmentation_train`;
* the image-classification pipeline (`ImageClassifierPipeline`,
  `classification_loss`, the training half `TrainState`, `make_optimizer`,
  `create_train_state`, `make_train_step`, and `make_eval_step`,
  `vanilla_inference`, `group_inference`, whose orbit is K4), which hands
  the batch to the canonicalizer in the memory layout its prediction
  network runs fastest on (`to_network_layout`), with the config taxonomy
  and the registries.

* the harness: torchvision checkpoints onto the port's networks
  (`models.convert`, the CLI's `prediction.pretrained=true`),
  `models.MaskRCNNLite` and `cli.maskrcnn_lite_experiment`, the native
  batch loader (`native`, host C++ built at first use) and `torch.export`
  artifacts (`utils.export`; every kernel launch is a registered
  `torch.ops.eqt` operator, so artifacts keep the kernels; importing this
  package registers them).

Every family, its networks and the ResNets take `training` as an argument
and ignore the torch module mode.
"""

from equiadapt_tpu_torch.common import (
    BaseCanonicalization,
    ContinuousCanonicalizationInfo,
    ContinuousGroupElement,
    DiscreteCanonicalizationInfo,
    DiscreteGroupElement,
    IdentityCanonicalization,
    IdentityCanonicalizationInfo,
    LieParameterization,
    gram_schmidt,
    identity_metric,
    modified_gram_schmidt,
    prior_regularization_loss,
)
from equiadapt_tpu_torch.images import (
    ContinuousGroupImageCanonicalization,
    ConvNetwork,
    CustomEquivariantNetwork,
    DiscreteGroupImageCanonicalization,
    EquivariantNetwork,
    EquivariantWideResNet,
    GroupEquivariantImageCanonicalization,
    OptimizedGroupEquivariantImageCanonicalization,
    OptimizedSteerableImageCanonicalization,
    ResNet18Network,
    RotationEquivariantConv,
    RotationEquivariantConvLift,
    RotoReflectionEquivariantConv,
    RotoReflectionEquivariantConvLift,
    SteerableImageCanonicalization,
    SteerableNetwork,
    WideResNet50Network,
    WideResNet101Network,
    optimization_specific_loss,
    steerable_optimization_loss,
)
from equiadapt_tpu_torch.data import (
    batch_iterator,
    synthetic_coco_batch,
    generate_nbody_dataset,
    simulate_charged,
    simulate_springs,
    synthetic_image_batch,
    synthetic_pointcloud_batch,
)
from equiadapt_tpu_torch.models import (
    DGCNN,
    DGCNNPartSeg,
    GNN,
    NBodyMLP,
    NBodyTransformer,
    PointNet,
    ResNet18,
    ResNet50,
    SAMLite,
    SamVitEncoder,
    TransformNet,
    ViT,
    ViTB16,
)
from equiadapt_tpu_torch.nbody import EuclideanGroupNBody, VNDeepSets
from equiadapt_tpu_torch.ops.group_action import (
    get_action_on_image_features,
    invert_regular_fast_diff,
)
from equiadapt_tpu_torch.ops.kernels.orbit import materialize_orbit, rot90_flip_orbit
from equiadapt_tpu_torch.pipelines import (
    ImageClassifierPipeline,
    ImageSegmentationPipeline,
    NBodyPipeline,
    PointcloudClassificationPipeline,
    PointcloudPartSegPipeline,
    TrainState,
    classification_loss,
    create_nbody_state,
    create_pointcloud_state,
    create_segmentation_state,
    create_train_state,
    group_inference,
    make_eval_step,
    make_nbody_train_step,
    make_optimizer,
    make_pointcloud_train_step,
    make_segmentation_train_step,
    make_train_step,
    mean_average_precision_segm,
    nbody_eval_mse,
    pointcloud_loss,
    random_point_dropout,
    random_rotate,
    random_scale_shift,
    segmentation_group_inference,
    segmentation_task_loss,
    to_network_layout,
    vanilla_inference,
)
from equiadapt_tpu_torch.pointcloud import (
    ContinuousGroupPointcloudCanonicalization,
    EquivariantPointcloudCanonicalization,
    VNBatchNorm,
    VNBilinear,
    VNLeakyReLU,
    VNLinear,
    VNLinearLeakyReLU,
    VNMaxPool,
    VNSmall,
    VNSoftplus,
    VNStdFeature,
    graph_feature_cross,
    mean_pool,
)
from equiadapt_tpu_torch.utils import (
    Config,
    compose_config,
    get_image_canonicalization_network,
    get_image_canonicalizer,
    get_image_prediction_network,
    get_nbody_canonicalizer,
    get_nbody_prediction_network,
    get_pointcloud_canonicalizer,
    get_pointcloud_prediction_network,
    get_segmentation_prediction_network,
    flax_variables,
    load_flax_variables,
    load_yaml,
)
from equiadapt_tpu_torch.utils.flops import (
    count_flops,
    resnet50_eval_flops,
    train_step_flops,
)

# the reference's name for the point-cloud edge features (graph_feature_cross)
get_graph_feature_cross = graph_feature_cross

__all__ = [
    "BaseCanonicalization",
    "IdentityCanonicalization",
    "DiscreteGroupElement",
    "DiscreteCanonicalizationInfo",
    "ContinuousGroupElement",
    "ContinuousCanonicalizationInfo",
    "IdentityCanonicalizationInfo",
    "prior_regularization_loss",
    "identity_metric",
    "LieParameterization",
    "gram_schmidt",
    "modified_gram_schmidt",
    "DiscreteGroupImageCanonicalization",
    "GroupEquivariantImageCanonicalization",
    "OptimizedGroupEquivariantImageCanonicalization",
    "optimization_specific_loss",
    "EquivariantNetwork",
    "CustomEquivariantNetwork",
    "EquivariantWideResNet",
    "ConvNetwork",
    "ResNet18Network",
    "WideResNet50Network",
    "WideResNet101Network",
    "RotationEquivariantConv",
    "RotationEquivariantConvLift",
    "RotoReflectionEquivariantConv",
    "RotoReflectionEquivariantConvLift",
    "ContinuousGroupImageCanonicalization",
    "SteerableImageCanonicalization",
    "OptimizedSteerableImageCanonicalization",
    "steerable_optimization_loss",
    "SteerableNetwork",
    "ResNet18",
    "ResNet50",
    "PointNet",
    "DGCNN",
    "DGCNNPartSeg",
    "TransformNet",
    "SAMLite",
    "SamVitEncoder",
    "ViT",
    "ViTB16",
    "ImageSegmentationPipeline",
    "create_segmentation_state",
    "make_segmentation_train_step",
    "segmentation_group_inference",
    "segmentation_task_loss",
    "mean_average_precision_segm",
    "synthetic_coco_batch",
    "get_segmentation_prediction_network",
    "GNN",
    "NBodyMLP",
    "NBodyTransformer",
    "EuclideanGroupNBody",
    "VNDeepSets",
    "simulate_charged",
    "simulate_springs",
    "generate_nbody_dataset",
    "synthetic_image_batch",
    "synthetic_pointcloud_batch",
    "batch_iterator",
    "ContinuousGroupPointcloudCanonicalization",
    "EquivariantPointcloudCanonicalization",
    "VNSmall",
    "graph_feature_cross",
    "get_graph_feature_cross",
    "VNBatchNorm",
    "VNBilinear",
    "VNLeakyReLU",
    "VNLinear",
    "VNLinearLeakyReLU",
    "VNMaxPool",
    "VNSoftplus",
    "VNStdFeature",
    "mean_pool",
    "PointcloudClassificationPipeline",
    "PointcloudPartSegPipeline",
    "create_pointcloud_state",
    "make_pointcloud_train_step",
    "pointcloud_loss",
    "random_point_dropout",
    "random_rotate",
    "random_scale_shift",
    "ImageClassifierPipeline",
    "classification_loss",
    "TrainState",
    "make_optimizer",
    "create_train_state",
    "make_train_step",
    "make_eval_step",
    "to_network_layout",
    "vanilla_inference",
    "group_inference",
    "NBodyPipeline",
    "create_nbody_state",
    "make_nbody_train_step",
    "nbody_eval_mse",
    "get_action_on_image_features",
    "invert_regular_fast_diff",
    "rot90_flip_orbit",
    "materialize_orbit",
    "Config",
    "compose_config",
    "load_yaml",
    "get_image_canonicalization_network",
    "get_image_canonicalizer",
    "get_image_prediction_network",
    "get_pointcloud_canonicalizer",
    "get_pointcloud_prediction_network",
    "get_nbody_canonicalizer",
    "get_nbody_prediction_network",
    "load_flax_variables",
    "flax_variables",
    "count_flops",
    "train_step_flops",
    "resnet50_eval_flops",
]
