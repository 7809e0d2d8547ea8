"""The whole detection step's share of the card's bf16 peak, in percent: the
reference's convolution and matrix FLOPs of a batch (the C4 GCNN, and per
image ResNet-50-FPN at 800 px, the RPN head, the box head on 1,000 regions
and the mask head on 100, counted on meta tensors,
`harness/detect_work.count_flops`) times the batches completed in the
traced window, over the window's seconds."""

from benchmark.harness.readings import mfu


def read(record):
    return mfu(record, "detect")
