"""Canonicalization bases, infos and selectors."""

from equiadapt_tpu_torch.common.base import (
    BaseCanonicalization,
    IdentityCanonicalization,
)
from equiadapt_tpu_torch.common.info import (
    DiscreteCanonicalizationInfo,
    DiscreteGroupElement,
    IdentityCanonicalizationInfo,
    identity_metric,
    prior_regularization_loss,
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
    "DiscreteCanonicalizationInfo",
    "DiscreteGroupElement",
    "IdentityCanonicalizationInfo",
    "identity_metric",
    "prior_regularization_loss",
    "gumbel_softmax_onehot",
    "hard_onehot",
    "select_onehot",
    "straight_through_onehot",
]
