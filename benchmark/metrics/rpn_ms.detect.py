"""Mean device milliseconds a call of the region proposal network
(`maskrcnn/rpn`: the head on P2-P6, the top 1,000 anchors a level decoded
and clipped, the NMS of each image and level, the first 1,000 kept), between
the span's two CUDA events, in the program's traced head."""

from benchmark.harness.spans import span_figure


def read(record):
    return span_figure(record, "detect", "maskrcnn/rpn", "device_ms")
