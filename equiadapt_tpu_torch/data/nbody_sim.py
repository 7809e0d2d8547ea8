"""Charged-particle and spring n-body simulators on the device.

Counterpart of `equiadapt_tpu/data/nbody_sim.py`. The whole batch of
systems is integrated at once by a leapfrog loop over time: a Python loop
of torch ops on the batch's device (the JAX package's `lax.scan` of
`lax.scan`s), about ten kernel launches a leap.

The arithmetic follows the JAX function step for step: the half step
vel = vel0 + dt F(loc0) first, then each leap loc += dt vel and
vel += dt F(loc), a frame recorded after every `sample_freq` leaps. Forces:
F_i = strength sum_j e_ij (x_i - x_j) / max(|x_i - x_j|^2, 1e-12)^1.5 with
the diagonal masked to 0 (springs: F_i = -strength sum_j e_ij (x_i - x_j)),
each component clipped at +-0.1 / dt; dt = 1e-3.

The initial draws come from a `torch.Generator` on the device the data is
made on, so they differ from `jax.random`'s; the integrator is the same
function of the initial state.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

Tensor = torch.Tensor

__all__ = ["simulate_charged", "simulate_springs", "generate_nbody_dataset"]

_DT = 1e-3
_MAX_F = 0.1 / _DT


def _pair_forces_charged(loc: Tensor, edges: Tensor, strength: float) -> Tensor:
    """loc: (B, n, 3), edges: (B, n, n) charge products -> (B, n, 3)."""
    diff = loc[:, :, None, :] - loc[:, None, :, :]  # x_i - x_j
    d2 = torch.sum(diff * diff, dim=-1)
    n = loc.shape[1]
    eye = torch.eye(n, dtype=torch.bool, device=loc.device)
    inv_d3 = torch.where(eye[None], 0.0, 1.0 / torch.clamp(d2, min=1e-12) ** 1.5)
    f = strength * edges * inv_d3
    force = torch.sum(f[..., None] * diff, dim=2)
    return torch.clamp(force, -_MAX_F, _MAX_F)


def _pair_forces_springs(loc: Tensor, edges: Tensor, strength: float) -> Tensor:
    diff = loc[:, :, None, :] - loc[:, None, :, :]
    force = -strength * torch.sum(edges[..., None] * diff, dim=2)
    return torch.clamp(force, -_MAX_F, _MAX_F)


def _simulate(loc0: Tensor, vel0: Tensor, edges: Tensor, steps: int,
              sample_freq: int, kind: str, strength: float) -> Tuple[Tensor, Tensor]:
    """Leapfrog from (loc0, vel0): (locs, vels), each (B, steps //
    sample_freq, n, 3)."""
    force = _pair_forces_charged if kind == "charged" else _pair_forces_springs
    T = steps // sample_freq
    locs = loc0.new_empty((loc0.shape[0], T) + tuple(loc0.shape[1:]))
    vels = torch.empty_like(locs)
    loc = loc0
    vel = vel0 + _DT * force(loc0, edges, strength)
    for t in range(T):
        for _ in range(sample_freq):
            loc = loc + _DT * vel
            vel = vel + _DT * force(loc, edges, strength)
        locs[:, t] = loc
        vels[:, t] = vel
    return locs, vels


def _unit_velocities(generator: torch.Generator, batch: int, n_balls: int,
                     vel_norm: float, device) -> Tensor:
    vel0 = torch.randn((batch, n_balls, 3), generator=generator, device=device)
    return vel0 * vel_norm / torch.linalg.vector_norm(vel0, dim=-1, keepdim=True)


def simulate_charged(
    generator: torch.Generator,
    batch: int,
    n_balls: int = 5,
    steps: int = 5000,
    sample_freq: int = 100,
    loc_std: float = 1.0,
    vel_norm: float = 0.5,
    strength: float = 1.0,
    device="cuda",
) -> Dict[str, Tensor]:
    """Batch of charged-particle trajectories: loc / vel (B, T, n, 3),
    charges (B, n, 1) in {-1, 1}, edges (B, n, n) their products.
    `generator` lies on `device`."""
    scale = loc_std * (n_balls / 5.0) ** (1 / 3)
    loc0 = torch.randn((batch, n_balls, 3), generator=generator, device=device) * scale
    vel0 = _unit_velocities(generator, batch, n_balls, vel_norm, device)
    charges = (2 * torch.randint(0, 2, (batch, n_balls, 1), generator=generator,
                                 device=device) - 1).float()
    edges = charges[..., 0][:, :, None] * charges[..., 0][:, None, :]
    locs, vels = _simulate(loc0, vel0, edges, steps, sample_freq, "charged", strength)
    return {"loc": locs, "vel": vels, "charges": charges, "edges": edges}


def simulate_springs(
    generator: torch.Generator,
    batch: int,
    n_balls: int = 5,
    steps: int = 5000,
    sample_freq: int = 100,
    loc_std: float = 0.5,
    vel_norm: float = 0.5,
    strength: float = 0.1,
    spring_prob: Tuple[float, float, float] = (0.5, 0.0, 0.5),
    device="cuda",
) -> Dict[str, Tensor]:
    """Batch of spring-system trajectories: springs of strength 0, 0.5 or 1
    drawn with `spring_prob`, as an upper triangle mirrored below the
    diagonal; charges are 0."""
    loc0 = torch.randn((batch, n_balls, 3), generator=generator, device=device) * loc_std
    vel0 = _unit_velocities(generator, batch, n_balls, vel_norm, device)
    probs = torch.tensor(spring_prob, device=device)
    pick = torch.multinomial(probs, batch * n_balls * n_balls, replacement=True,
                             generator=generator)
    values = torch.tensor([0.0, 0.5, 1.0], device=device)
    springs = values[pick].reshape(batch, n_balls, n_balls)
    edges = torch.triu(springs) + torch.triu(springs, 1).transpose(-1, -2)
    edges = edges * (1 - torch.eye(n_balls, device=device))
    locs, vels = _simulate(loc0, vel0, edges, steps, sample_freq, "springs", strength)
    charges = torch.zeros((batch, n_balls, 1), device=device)
    return {"loc": locs, "vel": vels, "charges": charges, "edges": edges}


def generate_nbody_dataset(
    generator: torch.Generator,
    num_samples: int,
    n_balls: int = 5,
    frame_0: int = 30,
    frame_t: int = 40,
    steps: int = 5000,
    sample_freq: int = 100,
    device="cuda",
) -> Dict[str, Tensor]:
    """(loc, vel, charges, loc_end) training pairs of charged systems: the
    state at frame `frame_0` and the positions at frame `frame_t`."""
    traj = simulate_charged(generator, num_samples, n_balls, steps, sample_freq,
                            device=device)
    return {
        "loc": traj["loc"][:, frame_0],
        "vel": traj["vel"][:, frame_0],
        "charges": traj["charges"],
        "loc_end": traj["loc"][:, frame_t],
    }
