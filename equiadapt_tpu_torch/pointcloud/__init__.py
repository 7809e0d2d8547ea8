"""Point-cloud canonicalization: vector-neuron layers, VNSmall and the
SO(3) / SE(3) canonicalizers."""

from equiadapt_tpu_torch.pointcloud.canonicalization import (
    ContinuousGroupPointcloudCanonicalization,
    EquivariantPointcloudCanonicalization,
)
from equiadapt_tpu_torch.pointcloud.networks import (
    VNSmall,
    graph_feature_cross,
    knn_indices,
)
from equiadapt_tpu_torch.pointcloud.vector_neurons import (
    VNBatchNorm,
    VNBilinear,
    VNLeakyReLU,
    VNLinear,
    VNLinearLeakyReLU,
    VNMaxPool,
    VNSoftplus,
    VNStdFeature,
    mean_pool,
)

__all__ = [
    "ContinuousGroupPointcloudCanonicalization",
    "EquivariantPointcloudCanonicalization",
    "VNSmall",
    "graph_feature_cross",
    "knn_indices",
    "VNBatchNorm",
    "VNBilinear",
    "VNLeakyReLU",
    "VNLinear",
    "VNLinearLeakyReLU",
    "VNMaxPool",
    "VNSoftplus",
    "VNStdFeature",
    "mean_pool",
]
