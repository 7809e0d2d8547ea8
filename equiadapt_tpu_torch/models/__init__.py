"""Prediction networks."""

from equiadapt_tpu_torch.models.egnn import (
    GCL,
    GCLRF,
    GNN,
    NBodyMLP,
    NBodyTransformer,
    edge_attributes,
    positional_encoding,
)
from equiadapt_tpu_torch.models.pointnet import (
    DGCNN,
    DGCNNPartSeg,
    PointNet,
    TransformNet,
    get_graph_feature,
)
from equiadapt_tpu_torch.models.resnet import (
    BasicBlock,
    Bottleneck,
    ResNet,
    ResNet18,
    ResNet50,
    WideResNet50,
    WideResNet101,
)

__all__ = ["GCL", "GCLRF", "GNN", "NBodyMLP", "NBodyTransformer",
           "edge_attributes", "positional_encoding",
           "DGCNN", "DGCNNPartSeg", "PointNet", "TransformNet", "get_graph_feature", "BasicBlock", "Bottleneck",
           "ResNet", "ResNet18", "ResNet50", "WideResNet50", "WideResNet101"]
