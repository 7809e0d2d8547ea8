"""Data: the n-body simulators."""

from equiadapt_tpu_torch.data.nbody_sim import (
    generate_nbody_dataset,
    simulate_charged,
    simulate_springs,
)

__all__ = ["generate_nbody_dataset", "simulate_charged", "simulate_springs"]
