"""Hand-written CUDA kernels with their plain PyTorch versions.

`select_warp`: the steered rotate-select (K1) and the fused
rotate-select-roll (K2), from `csrc/select_warp.cu`.
"""
