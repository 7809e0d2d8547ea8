"""Mean device milliseconds per served batch inside the program's
`canon/warp` span: the reflection blend, the residual sources and the
select kernel K3 (C8), or K5 and K6 (SO(2)), between the span's two CUDA
events."""

from benchmark.harness.spans import span_figure


def read(record):
    return span_figure(record, "serve", "canon/warp", "device_ms")
