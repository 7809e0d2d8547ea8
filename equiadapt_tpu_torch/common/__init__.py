"""Canonicalization bases, infos, selectors, frame math and Lie groups."""

from equiadapt_tpu_torch.common.base import (
    BaseCanonicalization,
    IdentityCanonicalization,
)
from equiadapt_tpu_torch.common.info import (
    ContinuousCanonicalizationInfo,
    ContinuousGroupElement,
    DiscreteCanonicalizationInfo,
    DiscreteGroupElement,
    IdentityCanonicalizationInfo,
    identity_metric,
    prior_regularization_loss,
)
from equiadapt_tpu_torch.common.lie import LieParameterization
from equiadapt_tpu_torch.common.math import (
    det_2x2,
    gram_schmidt,
    gram_schmidt_2d,
    modified_gram_schmidt,
    rotmat_2d_from_vector,
)
from equiadapt_tpu_torch.common.selector import (
    gumbel_softmax_onehot,
    hard_onehot,
    select_onehot,
    straight_through_onehot,
)

__all__ = [
    "BaseCanonicalization",
    "IdentityCanonicalization",
    "ContinuousCanonicalizationInfo",
    "ContinuousGroupElement",
    "DiscreteCanonicalizationInfo",
    "DiscreteGroupElement",
    "IdentityCanonicalizationInfo",
    "identity_metric",
    "prior_regularization_loss",
    "LieParameterization",
    "gumbel_softmax_onehot",
    "hard_onehot",
    "select_onehot",
    "straight_through_onehot",
    "det_2x2",
    "gram_schmidt",
    "gram_schmidt_2d",
    "modified_gram_schmidt",
    "rotmat_2d_from_vector",
]
