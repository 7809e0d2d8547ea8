"""Mean device milliseconds a call inside the program's `canon/warp` span:
the reflection blend, the residual sources and the select kernel K3 on the
orbit's 256 images at 224 px, between the span's two CUDA events."""

from benchmark.harness.spans import span_figure


def read(record):
    return span_figure(record, "group-eval", "canon/warp", "device_ms")
