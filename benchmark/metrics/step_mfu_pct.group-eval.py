"""The whole group evaluation's share of the card's bf16 peak, in percent:
the reference's convolution and matrix FLOPs of the orbit's 256 images (the
C8 canonicalizer and ResNet-50, `harness/work.serve_flops`) times the
batches completed in the traced window, over the window's seconds."""

from benchmark.harness.readings import mfu


def read(record):
    return mfu(record, "group-eval")
