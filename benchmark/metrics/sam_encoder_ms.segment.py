"""Mean device milliseconds a call of SAM's image encoder (`sam/encoder`:
the patch embedding, the twelve blocks, the neck), between the span's two
CUDA events, in the program's traced head."""

from benchmark.harness.spans import span_figure


def read(record):
    return span_figure(record, "segment", "sam/encoder", "device_ms")
