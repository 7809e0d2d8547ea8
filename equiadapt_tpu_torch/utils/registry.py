"""Factories: config -> canonicalization network / canonicalizer / predictor.

Counterpart of the ported parts of `equiadapt_tpu/utils/registry.py`, with
the same registry keys, so a `Config` resolves to the same module tree in
both packages (weights carried across by `load_flax_variables`). Modules are
built on `device` ("cuda" unless the caller asks for the CPU).

An unknown key raises; nothing falls back to another network. Torch modules
are built at their input widths, so the ViT and SAM factories take the
image size, which the Flax modules read from their input.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from equiadapt_tpu_torch.common.base import IdentityCanonicalization
from equiadapt_tpu_torch.images.canonicalization.continuous_group import (
    OptimizedSteerableImageCanonicalization,
    SteerableImageCanonicalization,
)
from equiadapt_tpu_torch.images.canonicalization.discrete_group import (
    GroupEquivariantImageCanonicalization,
    OptimizedGroupEquivariantImageCanonicalization,
)
from equiadapt_tpu_torch.images.networks import (
    ConvNetwork,
    CustomEquivariantNetwork,
    EquivariantNetwork,
    EquivariantWideResNet,
    ResNet18Network,
    SteerableNetwork,
    WideResNet50Network,
    WideResNet101Network,
)
from equiadapt_tpu_torch.models import (
    DGCNN,
    GNN,
    NBodyTransformer,
    PointNet,
    ResNet18,
    ResNet50,
)
from equiadapt_tpu_torch.models.detection import MaskRCNNLite
from equiadapt_tpu_torch.models.segmentation import SAMLite
from equiadapt_tpu_torch.models.vit import ViT
from equiadapt_tpu_torch.nbody import EuclideanGroupNBody, VNDeepSets
from equiadapt_tpu_torch.ops.warp import crop_and_resize_size
from equiadapt_tpu_torch.pointcloud.canonicalization import (
    EquivariantPointcloudCanonicalization,
)
from equiadapt_tpu_torch.pointcloud.networks import VNSmall
from equiadapt_tpu_torch.utils.config import CanonicalizationConfig, PredictionConfig

__all__ = [
    "get_image_canonicalization_network",
    "get_image_canonicalizer",
    "get_image_prediction_network",
    "get_segmentation_prediction_network",
    "get_pointcloud_canonicalizer",
    "get_pointcloud_prediction_network",
    "get_nbody_canonicalizer",
    "get_nbody_prediction_network",
]


def _dtype(name: Optional[str]) -> Optional[torch.dtype]:
    return getattr(torch, name) if name else None


def get_image_canonicalization_network(
    cfg: CanonicalizationConfig, in_shape: Tuple[int, int, int], device="cuda"
) -> Optional[nn.Module]:
    """The canonicalization network of `cfg` for (H, W, C) images."""
    h = cfg.network_hyperparams
    C = in_shape[-1]
    t = cfg.canonicalization_type
    if t == "identity":
        return None
    if t == "group_equivariant":
        nets = {
            "e2cnn": lambda: EquivariantNetwork(
                in_channels=C, out_channels=h.out_channels,
                kernel_size=h.kernel_size, group_type=h.group_type,
                num_rotations=h.num_rotations, num_layers=h.num_layers,
                pool_after_lift=h.pool_after_lift,
                fused_pool_lift=h.fused_pool_lift, device=device,
            ),
            "equivariant_wrn": lambda: EquivariantWideResNet(
                in_channels=C, out_channels=h.out_channels,
                kernel_size=h.kernel_size, group_type=h.group_type,
                num_rotations=h.num_rotations, device=device,
            ),
            "custom": lambda: CustomEquivariantNetwork(
                in_channels=C, out_channels=h.out_channels,
                kernel_size=h.kernel_size, group_type=h.group_type,
                num_rotations=h.num_rotations, num_layers=h.num_layers,
                device=device,
            ),
        }
    elif t == "steerable":
        nets = {
            "e2cnn": lambda: SteerableNetwork(
                in_channels=C, out_channels=h.out_channels,
                kernel_size=h.kernel_size, num_layers=h.num_layers,
                device=device,
            ),
        }
    elif t in ("opt_group_equivariant", "opt_steerable"):
        nets = {
            "cnn": lambda: ConvNetwork(
                in_channels=C, out_channels=h.out_channels,
                kernel_size=h.kernel_size, num_layers=h.num_layers,
                out_vector_size=h.out_vector_size,
                input_size=crop_and_resize_size(
                    in_shape, cfg.input_crop_ratio, cfg.resize_shape),
                device=device,
            ),
            "non_equivariant_resnet18": lambda: ResNet18Network(
                out_vector_size=h.out_vector_size, device=device),
            "non_equivariant_wrn50": lambda: WideResNet50Network(
                out_vector_size=h.out_vector_size, device=device),
            "non_equivariant_wrn101": lambda: WideResNet101Network(
                out_vector_size=h.out_vector_size, device=device),
        }
    else:
        raise ValueError(f"{t} is not implemented")
    if cfg.network_type not in nets:
        raise ValueError(
            f"{cfg.network_type} is not implemented for {t} canonicalization"
        )
    return nets[cfg.network_type]()


def get_image_canonicalizer(
    cfg: CanonicalizationConfig, network: Optional[nn.Module],
    in_shape: Tuple[int, int, int], device="cuda",
    generator: Optional[torch.Generator] = None,
):
    """The canonicalizer of `cfg` around `network`; `generator` draws the
    optimized canonicalizer's reference vector."""
    h = cfg.network_hyperparams
    t = cfg.canonicalization_type
    if t == "identity":
        return IdentityCanonicalization()
    common = dict(
        canonicalization_network=network,
        in_shape=in_shape,
        input_crop_ratio=cfg.input_crop_ratio,
        resize_shape=cfg.resize_shape,
    )
    discrete = dict(
        warp_mode=cfg.warp_mode, compute_dtype=_dtype(cfg.compute_dtype),
        output_dtype=cfg.output_dtype,
    )
    if t == "group_equivariant":
        return GroupEquivariantImageCanonicalization(
            beta=cfg.beta, gradient_trick=cfg.gradient_trick,
            group_type=h.group_type, num_rotations=h.num_rotations,
            **discrete, **common,
        )
    if t == "opt_group_equivariant":
        return OptimizedGroupEquivariantImageCanonicalization(
            beta=cfg.beta, gradient_trick=cfg.gradient_trick,
            group_type=h.group_type, num_rotations=h.num_rotations,
            out_vector_size=h.out_vector_size, learn_ref_vec=cfg.learn_ref_vec,
            artifact_err_wt=cfg.artifact_err_wt, device=device,
            generator=generator, **discrete, **common,
        )
    if t == "steerable":
        return SteerableImageCanonicalization(
            group_type=h.group_type, **discrete, **common
        )
    if t == "opt_steerable":
        return OptimizedSteerableImageCanonicalization(
            group_type=h.group_type, artifact_err_wt=cfg.artifact_err_wt,
            **discrete, **common,
        )
    raise ValueError(f"{t} needs a canonicalization network implementation")


def get_pointcloud_canonicalizer(cfg: CanonicalizationConfig, device="cuda"):
    """The point-cloud canonicalizer of `cfg`."""
    h = cfg.network_hyperparams
    if cfg.canonicalization_type == "identity":
        return IdentityCanonicalization()
    if cfg.canonicalization_type == "continuous_group":
        net = VNSmall(n_knn=h.n_knn, pooling=h.pooling, knn_mode=h.knn_mode,
                      device=device)
        return EquivariantPointcloudCanonicalization(
            canonicalization_network=net,
            enable_translation=cfg.enable_translation,
        )
    raise ValueError(f"{cfg.canonicalization_type} is not implemented for pointclouds")


def get_image_prediction_network(
    cfg: PredictionConfig, num_classes: int, small_images: bool, device="cuda",
    image_size: int = 224,
) -> nn.Module:
    """The image prediction network of `cfg` (`image_size` sizes the ViT's
    position embeddings)."""
    dtype = _dtype(cfg.dtype) or torch.float32
    if cfg.architecture == "resnet50":
        return ResNet50(num_classes=num_classes, small_images=small_images,
                        dtype=dtype, device=device)
    if cfg.architecture == "resnet18":
        return ResNet18(num_classes=num_classes, small_images=small_images,
                        dtype=dtype, device=device)
    if cfg.architecture == "vit":
        return ViT(num_classes=num_classes, image_size=image_size, device=device)
    raise ValueError(f"{cfg.architecture} is not implemented as prediction network")


def get_segmentation_prediction_network(architecture: str, image_size: int,
                                        num_classes: int = 91, device="cuda",
                                        **kw) -> nn.Module:
    """SAMLite ("sam", light encoder; "sam_vit", SAM's ViT encoder with 4
    mask tokens) for images of `image_size`, or MaskRCNNLite ("maskrcnn",
    `num_classes` classes; it takes any image size); `kw` goes to the
    module."""
    if architecture == "sam":
        return SAMLite(image_size, device=device, **kw)
    if architecture == "sam_vit":
        return SAMLite(image_size, encoder="sam_vit", num_mask_tokens=4,
                       device=device, **kw)
    if architecture == "maskrcnn":
        return MaskRCNNLite(num_classes=num_classes, device=device, **kw)
    raise ValueError(f"{architecture} is not implemented as a segmentation network")


def get_pointcloud_prediction_network(architecture: str, num_classes: int,
                                      **kw) -> nn.Module:
    """PointNet or DGCNN; `kw` goes to the network (e.g. `device`)."""
    if architecture == "pointnet":
        return PointNet(num_classes=num_classes, **kw)
    if architecture == "DGCNN":
        return DGCNN(num_classes=num_classes, **kw)
    raise ValueError(f"{architecture} is not implemented")


def get_nbody_canonicalizer(cfg: CanonicalizationConfig, device="cuda"):
    """The n-body canonicalizer of `cfg`: the identity, or EuclideanGroupNBody
    around VNDeepSets."""
    h = cfg.network_hyperparams
    if cfg.canonicalization_type == "identity":
        return IdentityCanonicalization()
    net = VNDeepSets(
        hidden_dim=h.hidden_dim, num_layers=h.num_layers,
        layer_pooling=h.layer_pooling, final_pooling=h.final_pooling,
        nonlinearity=h.nonlinearity, canon_feature=h.canon_feature,
        canon_translation=h.canon_translation, dropout=h.dropout,
        out_dim=h.out_dim, device=device,
    )
    return EuclideanGroupNBody(canonicalization_network=net)


def get_nbody_prediction_network(cfg: PredictionConfig, device="cuda") -> nn.Module:
    """GNN, Transformer or VNDeepSets in prediction mode."""
    if cfg.architecture == "GNN":
        return GNN(hidden_dim=cfg.hidden_dim, num_layers=cfg.num_layers, device=device)
    if cfg.architecture == "Transformer":
        return NBodyTransformer(hidden_dim=cfg.hidden_dim, num_layers=cfg.num_layers,
                                device=device)
    if cfg.architecture == "vndeepsets":
        return VNDeepSets(hidden_dim=cfg.hidden_dim, num_layers=cfg.num_layers,
                          out_dim=1, device=device)
    raise ValueError(f"{cfg.architecture} is not implemented as a prediction network")
