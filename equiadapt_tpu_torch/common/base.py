"""Base canonicalization modules.

Counterpart of `equiadapt_tpu/common/base.py`, with the same contract:

    x_canon, info = canonicalizer.canonicalize(x)
    y = prediction_network(x_canon)
    y_orig = canonicalizer.invert_canonicalization(info, y)
    loss += w * prior_regularization_loss(info)
"""

from __future__ import annotations

from typing import Any, Optional

from torch import nn

from equiadapt_tpu_torch.common.info import (
    IdentityCanonicalizationInfo,
    identity_metric,
    prior_regularization_loss,
)

__all__ = [
    "BaseCanonicalization",
    "IdentityCanonicalization",
    "prior_regularization_loss",
    "identity_metric",
]


class BaseCanonicalization(nn.Module):
    """Abstract canonicalizer: `canonicalize(x, targets=None, *,
    training=False)` returns `(x_canon, info)` and
    `invert_canonicalization(info, out)` undoes it."""

    def canonicalize(self, x, targets: Optional[Any] = None, *,
                     training: bool = False, **kwargs: Any):
        raise NotImplementedError

    def forward(self, x, targets: Optional[Any] = None, *,
                training: bool = False, **kwargs: Any):
        return self.canonicalize(x, targets, training=training, **kwargs)

    def invert_canonicalization(self, info, x_canonicalized_out, **kwargs: Any):
        raise NotImplementedError


class IdentityCanonicalization(BaseCanonicalization):
    """No-op canonicalization: prior loss 0, identity metric 1."""

    def canonicalize(self, x, targets: Optional[Any] = None, *,
                     training: bool = False, **kwargs: Any):
        info = IdentityCanonicalizationInfo()
        if targets is not None:
            return x, targets, info
        return x, info

    def invert_canonicalization(self, info, x_canonicalized_out, **kwargs: Any):
        return x_canonicalized_out
