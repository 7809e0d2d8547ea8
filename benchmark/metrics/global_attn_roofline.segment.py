"""A global block's attention against the card's bf16 peak, in percent:
the reference's FLOPs of one global-attention call of the batch (the two
score products and the two relative-position einsums, counted on meta
tensors by `harness/segment.count_work`, whatever kernel computes them)
over the mean device seconds a call of the program's `sam/attn/global`
span, at 989.4 TFLOP/s."""

from benchmark.harness.spans import span_figure


def read(record):
    work = record.get("work", {})
    ms = span_figure(record, "segment", "sam/attn/global", "device_ms")
    if ms is None or ms <= 0 or not work.get("global_attn_flops"):
        return None
    return 100.0 * work["global_attn_flops"] / (ms / 1e3) / record["peaks"]["bf16_flops"]
