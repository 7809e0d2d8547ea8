"""Mean device milliseconds a served batch inside the program's
`canon/warp` span: the quarter turn of the 1024 px bf16 images by the
select kernel K3, between the span's two CUDA events."""

from benchmark.harness.spans import span_figure


def read(record):
    return span_figure(record, "detect", "canon/warp", "device_ms")
