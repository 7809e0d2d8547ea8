"""Mean device milliseconds per train step inside the program's
`train/backward` span (the backward pass and the gradients' sync)."""

from benchmark.harness.spans import span_figure


def read(record):
    return span_figure(record, "train", "train/backward", "device_ms")
