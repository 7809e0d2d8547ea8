"""The whole segmentation step's share of the card's bf16 peak, in percent:
the reference's matmul and convolution FLOPs of a batch (the C4 GCNN and
SAM ViT-B with its decoder, counted on meta tensors at the cell's shapes
with the element fixed, `harness/segment.count_work`) times the batches
completed in the traced window, over the window's seconds."""

from benchmark.harness.readings import mfu


def read(record):
    return mfu(record, "segment")
