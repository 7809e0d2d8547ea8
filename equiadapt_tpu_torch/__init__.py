"""equiadapt_tpu_torch: the PyTorch/CUDA port of equiadapt_tpu.

Same modules, public names and functional contract as the JAX package
(NHWC tensors; `canonicalize` returns `(x_canon, info)`;
`invert_canonicalization(info, y)` undoes it), written for an NVIDIA H100:
plain tensor work is PyTorch, and each Pallas TPU kernel on a ported path is
a hand-written CUDA kernel under `csrc/`, built with nvcc at first use.
Modules default to `device="cuda"`; pass `device="cpu"` explicitly to run the
plain PyTorch versions of the kernels on the CPU.

This first slice ports the discrete (C_n / D_n) eval path: GCNN energy ->
hard select -> rotate-select (kernel K1) -> prediction network ->
regular-rep invert (kernel K2).
"""

from equiadapt_tpu_torch.common import (
    BaseCanonicalization,
    DiscreteCanonicalizationInfo,
    DiscreteGroupElement,
    IdentityCanonicalization,
    IdentityCanonicalizationInfo,
    identity_metric,
    prior_regularization_loss,
)
from equiadapt_tpu_torch.images import (
    DiscreteGroupImageCanonicalization,
    EquivariantNetwork,
    GroupEquivariantImageCanonicalization,
)
from equiadapt_tpu_torch.models import ResNet18, ResNet50
from equiadapt_tpu_torch.ops.group_action import get_action_on_image_features
from equiadapt_tpu_torch.utils import load_flax_variables

__all__ = [
    "BaseCanonicalization",
    "IdentityCanonicalization",
    "DiscreteGroupElement",
    "DiscreteCanonicalizationInfo",
    "IdentityCanonicalizationInfo",
    "prior_regularization_loss",
    "identity_metric",
    "DiscreteGroupImageCanonicalization",
    "GroupEquivariantImageCanonicalization",
    "EquivariantNetwork",
    "ResNet18",
    "ResNet50",
    "get_action_on_image_features",
    "load_flax_variables",
]
