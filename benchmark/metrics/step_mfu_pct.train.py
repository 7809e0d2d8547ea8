"""The whole train step's share of the card's bf16 peak, in percent: the
reference's matmul and convolution FLOPs (counted on meta tensors at the
cell's shapes, `harness/work.py`) of the iterations in the traced window,
over the window's seconds."""

from benchmark.harness.readings import mfu


def read(record):
    return mfu(record, "train")
