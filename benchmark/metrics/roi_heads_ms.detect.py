"""Mean device milliseconds a call of the RoI heads (`maskrcnn/roi_heads`:
both RoIAligns, the box head and predictor, the post-processing with the
class-wise NMS, the mask head), between the span's two CUDA events, in the
program's traced head."""

from benchmark.harness.spans import span_figure


def read(record):
    return span_figure(record, "detect", "maskrcnn/roi_heads", "device_ms")
