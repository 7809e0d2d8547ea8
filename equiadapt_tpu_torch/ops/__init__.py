"""Warps, group actions and the hand-written kernels (`ops.kernels`)."""
