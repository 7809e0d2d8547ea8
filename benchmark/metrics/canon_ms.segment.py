"""Mean device milliseconds a call of the canonicalizer (`canon`: the cast,
crop and resize, the C4 GCNN, the selection, the warp of the image and the
boxes), between the span's two CUDA events, in the program's traced head."""

from benchmark.harness.spans import span_figure


def read(record):
    return span_figure(record, "segment", "canon", "device_ms")
