"""Mean device milliseconds a call of a global block's attention
(`sam/attn/global`: qkv, the (B, heads, 4096, 4096) scores, the decomposed
relative-position bias added in place, the softmax, the product with v, the
projection), between the span's two CUDA events, in the program's traced
head."""

from benchmark.harness.spans import span_figure


def read(record):
    return span_figure(record, "segment", "sam/attn/global", "device_ms")
