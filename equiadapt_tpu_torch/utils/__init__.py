"""Utilities: weights carried across from the JAX package."""

from equiadapt_tpu_torch.utils.jax_weights import load_flax_variables

__all__ = ["load_flax_variables"]
