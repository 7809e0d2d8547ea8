"""Mean device milliseconds a served batch inside the program's
`canon/invert` span: the detections' pasted masks (B, 100, 1024, 1024) fp32
turned back to the input frame by K1a (the select kernel with one source),
between the span's two CUDA events."""

from benchmark.harness.spans import span_figure


def read(record):
    return span_figure(record, "detect", "canon/invert", "device_ms")
