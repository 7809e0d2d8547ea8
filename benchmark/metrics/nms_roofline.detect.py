"""NMS's bitmask pass against the card's fp32 rate, in percent: the pairs of
valid boxes within a segment that the traced window's NMS calls compared
(the program's `maskrcnn/nms_pairs` counter, from the valid candidates of
each segment, `maskrcnn/nms_candidates`), each an IoU of
`detect_work.NMS_PAIR_FLOPS` operations, at 67 TFLOP/s, over the device
seconds of every call of the program's `maskrcnn/nms` span (the sort and
the greedy scan included)."""

from benchmark.harness.spans import span_figure


def read(record):
    pairs = record.get("counters", {}).get("maskrcnn/nms_pairs")
    ms = span_figure(record, "detect", "maskrcnn/nms", "device_ms")
    calls = span_figure(record, "detect", "maskrcnn/nms", "calls")
    work = record.get("work", {})
    if not pairs or ms is None or ms <= 0 or not calls or not work.get("nms_pair_flops"):
        return None
    seconds = ms * calls / 1e3
    return 100.0 * pairs * work["nms_pair_flops"] / seconds / record["peaks"]["fp32_flops"]
