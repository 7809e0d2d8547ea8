"""Mean device milliseconds a call of NMS (`maskrcnn/nms`: the stable sort of
each segment, the IoU bitmask and the greedy scan of `csrc/nms.cu`; two
calls a batch, the RPN's segments of an image and level and the final
ones of an image and class), between the span's two CUDA events."""

from benchmark.harness.spans import span_figure


def read(record):
    return span_figure(record, "detect", "maskrcnn/nms", "device_ms")
