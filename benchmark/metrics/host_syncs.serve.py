"""Host syncs per served batch inside the program's `pipeline` span
and the spans nested in it (a synchronizing CUDA operation, such as a
pageable copy to the device, counted by torch.cuda's sync debug mode)."""

from benchmark.harness.spans import span_figure


def read(record):
    return span_figure(record, "serve", "pipeline", "syncs")
