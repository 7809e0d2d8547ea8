"""Mean device milliseconds a call of SAM's mask decoder (`sam/decoder`: the
two-way transformer, the output upscaling, the hypernetwork and IoU heads),
between the span's two CUDA events, in the program's traced head."""

from benchmark.harness.spans import span_figure


def read(record):
    return span_figure(record, "segment", "sam/decoder", "device_ms")
