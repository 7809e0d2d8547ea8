"""Mean host milliseconds per served batch inside the program's
`pipeline` span (`ImageClassifierPipeline.forward`, from entry to
return): how long the host takes to issue a batch."""

from benchmark.harness.spans import span_figure


def read(record):
    return span_figure(record, "serve", "pipeline", "host_ms")
