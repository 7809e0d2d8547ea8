"""Prediction networks."""

from equiadapt_tpu_torch.models.convert import (
    apply_pretrained_to_state,
    convert_resnet_checkpoint,
    convert_vit_checkpoint,
    load_pretrained_prediction,
    load_torch_state_dict,
)
from equiadapt_tpu_torch.models.detection import MaskRCNNLite, decode_boxes, maskrcnn_lite_loss

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
from equiadapt_tpu_torch.models.sam_convert import (
    convert_sam_checkpoint,
    convert_sam_vit_encoder,
)
from equiadapt_tpu_torch.models.sam_encoder import SamVitEncoder, sam_vit_b_encoder_kwargs
from equiadapt_tpu_torch.models.segmentation import (
    ImageEncoderLite,
    MaskDecoderLite,
    PromptEncoderLite,
    SAMLite,
    calc_iou,
    dice_loss,
    focal_loss,
    segmentation_forward_outputs,
)
from equiadapt_tpu_torch.models.vit import EncoderBlock, ViT, ViTB16
from equiadapt_tpu_torch.models.resnet import (
    BasicBlock,
    Bottleneck,
    ResNet,
    ResNet18,
    ResNet50,
    WideResNet50,
    WideResNet101,
)

__all__ = ["MaskRCNNLite", "maskrcnn_lite_loss", "decode_boxes",
           "apply_pretrained_to_state", "convert_resnet_checkpoint",
           "convert_vit_checkpoint", "load_pretrained_prediction",
           "load_torch_state_dict", "GCL", "GCLRF", "GNN", "NBodyMLP", "NBodyTransformer",
           "edge_attributes", "positional_encoding",
           "DGCNN", "DGCNNPartSeg", "PointNet", "TransformNet", "get_graph_feature", "BasicBlock", "Bottleneck",
           "ResNet", "ResNet18", "ResNet50", "WideResNet50", "WideResNet101",
           "convert_sam_checkpoint", "convert_sam_vit_encoder", "SamVitEncoder",
           "sam_vit_b_encoder_kwargs", "ImageEncoderLite", "MaskDecoderLite",
           "PromptEncoderLite", "SAMLite", "calc_iou", "dice_loss", "focal_loss",
           "segmentation_forward_outputs", "EncoderBlock", "ViT", "ViTB16"]
