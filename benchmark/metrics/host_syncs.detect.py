"""Host syncs per served batch inside the program's `pipeline` span and the
spans nested in it (`ImageSegmentationPipeline.detect`: the canonicalizer,
Mask R-CNN, the paste, the invert of the masks), counted by torch.cuda's
sync debug mode."""

from benchmark.harness.spans import span_figure


def read(record):
    return span_figure(record, "detect", "pipeline", "syncs")
