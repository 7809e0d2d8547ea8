"""Tutorial 4: n-body dynamics with and without canonicalization.

Charged particles are simulated, and a GNN learns their future positions
twice: behind an SE(3) canonicalizer (VN-DeepSets frames) and behind the
identity. Both are then evaluated on randomly rotated copies of the data.
The canonicalized model is SE(3)-equivariant by construction: its error on
the rotated data equals its error on the data as given (within 1e-4 of
it), while the identity baseline's error moves with the orientation.

The simulator keeps 2000 / 50 = 40 frames; the target is the last, frame
39 (the JAX tutorial asks for frame 40, which JAX clamps to 39; the port
raises on an index past the last frame).

    python -m equiadapt_tpu_torch.tutorials.nbody

On the CPU: `main(device="cpu")`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from equiadapt_tpu_torch.common.base import IdentityCanonicalization
from equiadapt_tpu_torch.common.info import IdentityCanonicalizationInfo
from equiadapt_tpu_torch.common.lie import son_rep
from equiadapt_tpu_torch.data import generate_nbody_dataset
from equiadapt_tpu_torch.models import GNN
from equiadapt_tpu_torch.nbody import EuclideanGroupNBody, VNDeepSets
from equiadapt_tpu_torch.pipelines import (
    NBodyPipeline,
    create_nbody_state,
    make_nbody_train_step,
    nbody_eval_mse,
)
from equiadapt_tpu_torch.tutorials._common import fp32, seeded

Tensor = torch.Tensor


class _IdentityNBody(IdentityCanonicalization):
    """Pass-through with the n-body canonicalizer's call signature: returns
    ((loc, vel), info), as `NBodyPipeline` unpacks it."""

    def canonicalize(self, x, targets=None, *, loc=None, vel=None, training=False,
                     **kw):
        return (loc, vel), IdentityCanonicalizationInfo()


def train(canonicalizer, data: Dict[str, Tensor], seed: int, steps: int,
          device) -> Tuple[NBodyPipeline, float]:
    """A GNN (width 16, 2 layers) behind `canonicalizer`, `steps` Adam steps
    at 1e-3 on the whole dataset; returns the pipeline and the last loss."""
    with seeded(seed, device):
        pipe = NBodyPipeline(canonicalizer=canonicalizer,
                             prediction_network=GNN(hidden_dim=16, num_layers=2,
                                                    device=device))
    state = create_nbody_state(pipe, learning_rate=1e-3, weight_decay=0.0)
    step = make_nbody_train_step()
    for _ in range(steps):
        state, metrics = step(state, data)
    return pipe, metrics["loss/task"].item()


def rotated(data: Dict[str, Tensor], generator: torch.Generator) -> Dict[str, Tensor]:
    """loc, vel and loc_end turned by one random rotation per graph."""
    q = son_rep(torch.randn(data["loc"].shape[0], 3, generator=generator,
                            device=data["loc"].device), 3)
    turn = lambda v: torch.einsum("bnd,bdw->bnw", v, q)  # noqa: E731
    return {**data, "loc": turn(data["loc"]), "vel": turn(data["vel"]),
            "loc_end": turn(data["loc_end"])}


def main(device="cuda", batch: int = 64, steps: int = 30, seed: int = 0) -> Dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    data = generate_nbody_dataset(gen, batch, frame_0=30, frame_t=39, steps=2000,
                                  sample_freq=50, device=device)
    out = {}
    with fp32():
        with seeded(seed + 1, device):
            canon = EuclideanGroupNBody(canonicalization_network=VNDeepSets(
                hidden_dim=8, num_layers=2, canon_feature="pv", device=device))
        for name, canonicalizer, s in (("canon", canon, seed + 1),
                                       ("identity", _IdentityNBody(), seed + 2)):
            pipe, loss = train(canonicalizer, data, s, steps, device)
            turned = rotated(data, torch.Generator(device=device).manual_seed(seed + 3))
            out[name] = {"train_loss": loss, "mse": nbody_eval_mse(pipe, data).item(),
                         "rotated_mse": nbody_eval_mse(pipe, turned).item()}
    c, i = out["canon"], out["identity"]
    print(f"train loss      with canon: {c['train_loss']:.4f}   without: {i['train_loss']:.4f}")
    print(f"rotated-eval MSE with canon: {c['rotated_mse']:.4f}   without: {i['rotated_mse']:.4f}")
    print(f"rotation degradation: canon {c['rotated_mse'] - c['mse']:+.6f} vs identity "
          f"{i['rotated_mse'] - i['mse']:+.6f}")
    out["canon_rotation_rel"] = abs(c["rotated_mse"] - c["mse"]) / c["mse"]
    assert out["canon_rotation_rel"] < 1e-4, out
    return out


if __name__ == "__main__":
    main()
