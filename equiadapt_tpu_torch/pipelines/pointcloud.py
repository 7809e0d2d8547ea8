"""Point-cloud classification pipeline, eval half.

Counterpart of `equiadapt_tpu/pipelines/pointcloud.py`: `random_rotate`
(the test-time z / SO(3) rotations), `PointcloudClassificationPipeline`
(canonicalize -> classify) and `classification_metrics`. The random numbers
of `random_rotate` come from a `torch.Generator`, or are handed in as
`draws` (a test gives both packages the same numbers).

Not ported yet, with the training slice (ROADMAP.md item 12):
`random_point_dropout`, `random_scale_shift`, `create_pointcloud_state`,
`make_pointcloud_train_step` and the part-segmentation pipeline.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from equiadapt_tpu_torch.common.lie import son_rep

Tensor = torch.Tensor

__all__ = ["random_rotate", "PointcloudClassificationPipeline",
           "classification_metrics"]


def random_rotate(points: Tensor, mode: str,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[Tensor] = None) -> Tensor:
    """Rotate each cloud (B, N, 3) by a random z-axis ("z") or SO(3)
    ("so3") rotation, points @ R; any other mode returns the points.

    `draws`: (B,) uniforms in [0, 1) for "z", (B, 3) standard normals for
    "so3"; drawn from `generator` on the points' device when not given."""
    if mode not in ("z", "so3"):
        return points
    B = points.shape[0]
    if draws is None:
        draw = torch.rand if mode == "z" else torch.randn
        shape = (B,) if mode == "z" else (B, 3)
        draws = draw(shape, generator=generator, device=points.device)
    draws = draws.to(points.device, points.dtype)
    if mode == "z":
        theta = draws * 2 * math.pi
        c, s = torch.cos(theta), torch.sin(theta)
        zero, one = torch.zeros_like(c), torch.ones_like(c)
        R = torch.stack([c, -s, zero, s, c, zero, zero, zero, one],
                        dim=-1).reshape(B, 3, 3)
    else:
        R = son_rep(draws * math.pi, 3)
    return torch.einsum("bnd,bdw->bnw", points, R)


class PointcloudClassificationPipeline(nn.Module):
    """canonicalize -> classify: (B, N, 3) -> (logits, info)."""

    def __init__(self, canonicalizer: nn.Module, prediction_network: nn.Module):
        super().__init__()
        self.canonicalizer = canonicalizer
        self.prediction_network = prediction_network

    def forward(self, points: Tensor, training: bool = False):
        points_c, info = self.canonicalizer(points, training=training)
        return self.prediction_network(points_c), info


def classification_metrics(logits: Tensor, labels: Tensor,
                           num_classes: int) -> Dict[str, Tensor]:
    """Accuracy, and accuracy balanced over the classes present."""
    hit = (torch.argmax(logits, dim=-1) == labels).float()
    onehot = F.one_hot(labels.long(), num_classes).float()
    per_class = torch.sum(onehot * hit[:, None], 0) / torch.clamp(
        torch.sum(onehot, 0), min=1.0)
    present = (torch.sum(onehot, 0) > 0).float()
    balanced = torch.sum(per_class * present) / torch.clamp(torch.sum(present), min=1.0)
    return {"metric/acc": torch.mean(hit), "metric/balanced_acc": balanced}
