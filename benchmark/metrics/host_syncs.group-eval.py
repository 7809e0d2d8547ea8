"""Host syncs per orbit inside the program's `pipeline` span and the spans
nested in it (`ImageClassifierPipeline.forward` on the 256 orbit images),
counted by torch.cuda's sync debug mode."""

from benchmark.harness.spans import span_figure


def read(record):
    return span_figure(record, "group-eval", "pipeline", "syncs")
