"""Mean host milliseconds a served batch inside the program's `pipeline`
span (`ImageSegmentationPipeline.serve`, from entry to return): how long
the host takes to issue a batch."""

from benchmark.harness.spans import span_figure


def read(record):
    return span_figure(record, "segment", "pipeline", "host_ms")
