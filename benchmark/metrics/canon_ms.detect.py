"""Mean device milliseconds a call of the canonicalizer (`canon`: the cast,
crop and resize, the C4 GCNN, the selection, the quarter turn of the 1024 px
images), between the span's two CUDA events, in the program's traced head."""

from benchmark.harness.spans import span_figure


def read(record):
    return span_figure(record, "detect", "canon", "device_ms")
