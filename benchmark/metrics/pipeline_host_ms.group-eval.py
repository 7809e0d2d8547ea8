"""Mean host milliseconds a call inside the program's `pipeline` span
(`ImageClassifierPipeline.forward` on the orbit, from entry to return; the
orbit's making, `group/orbit`, comes before it): how long the host takes
to issue the canonicalizer and the network."""

from benchmark.harness.spans import span_figure


def read(record):
    return span_figure(record, "group-eval", "pipeline", "host_ms")
