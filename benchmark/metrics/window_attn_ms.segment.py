"""Mean device milliseconds a call of a windowed block's attention
(`sam/attn/window`: from the partition into 14 x 14 windows to the
unpartition), between the span's two CUDA events, in the program's traced
head."""

from benchmark.harness.spans import span_figure


def read(record):
    return span_figure(record, "segment", "sam/attn/window", "device_ms")
