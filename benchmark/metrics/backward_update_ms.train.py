"""Mean milliseconds per train step outside the pipeline's forward: the
span around each `train_step` call less the span of the pipeline's
forward inside it (loss, backward, gradient handling, AdamW)."""

import statistics


def read(record):
    spans = record.get("spans_ms", {})
    step, fwd = spans.get("train_step"), spans.get("pipeline")
    if record.get("mode") != "train" or not step or not fwd:
        return None
    return statistics.fmean(step) - statistics.fmean(fwd)
