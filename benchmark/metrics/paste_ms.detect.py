"""Mean device milliseconds a call of the mask paste (`maskrcnn/paste`: the
100 masks an image of 28 x 28 put into their boxes of the 1024 px frame,
fp32), between the span's two CUDA events, in the program's traced head."""

from benchmark.harness.spans import span_figure


def read(record):
    return span_figure(record, "detect", "maskrcnn/paste", "device_ms")
