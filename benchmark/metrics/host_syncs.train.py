"""Host syncs per train step inside the program's `train/step` span
and the spans nested in it (torch.cuda's sync debug mode)."""

from benchmark.harness.spans import span_figure


def read(record):
    return span_figure(record, "train", "train/step", "syncs")
