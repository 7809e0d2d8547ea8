"""Mean host milliseconds per train step inside the program's
`train/step` span, from entry to return: how long the host takes to issue
a step."""

from benchmark.harness.spans import span_figure


def read(record):
    return span_figure(record, "train", "train/step", "host_ms")
