"""Mean device milliseconds a call of the orbit's making (`group/orbit`: the
batch of 64 turned by the four quarter turns into 256 images, K4), between
the span's two CUDA events, in the program's traced head."""

from benchmark.harness.spans import span_figure


def read(record):
    return span_figure(record, "group-eval", "group/orbit", "device_ms")
