"""Mean device milliseconds per train step inside the program's
`train/optimizer` span (`TrainState.apply_gradients`: AdamW on both
parameter groups)."""

from benchmark.harness.spans import span_figure


def read(record):
    return span_figure(record, "train", "train/optimizer", "device_ms")
