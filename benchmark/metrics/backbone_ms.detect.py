"""Mean device milliseconds a call of Mask R-CNN's backbone
(`maskrcnn/backbone`: the transform to 800 px, ResNet-50's C2-C5 and the
FPN's P2-P6), between the span's two CUDA events, in the program's traced
head."""

from benchmark.harness.spans import span_figure


def read(record):
    return span_figure(record, "detect", "maskrcnn/backbone", "device_ms")
