"""N-body SE(3) canonicalization: VN-DeepSets and EuclideanGroupNBody."""

from equiadapt_tpu_torch.nbody.canonicalization import EuclideanGroupNBody
from equiadapt_tpu_torch.nbody.vn_deepsets import (
    VNDeepSetLayer,
    VNDeepSets,
    complete_adjacency,
)

__all__ = [
    "EuclideanGroupNBody",
    "VNDeepSetLayer",
    "VNDeepSets",
    "complete_adjacency",
]
