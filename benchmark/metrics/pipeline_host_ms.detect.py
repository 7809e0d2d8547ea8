"""Mean host milliseconds a served batch inside the program's `pipeline`
span (`ImageSegmentationPipeline.detect`, from entry to return): how long
the host takes to issue a batch."""

from benchmark.harness.spans import span_figure


def read(record):
    return span_figure(record, "detect", "pipeline", "host_ms")
