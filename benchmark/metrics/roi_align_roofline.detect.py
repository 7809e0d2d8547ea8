"""RoIAlign against the HBM roofline, in percent: its byte floor a launch
(every distinct map pixel the samples' taps name, read once, and every
output written once, bf16; the mean of a batch's box and mask launches over
the traced batches' own regions, `harness/detect_work.roi_align_bytes`) at
3.35 TB/s, over the mean device seconds a call of the program's
`maskrcnn/roi_align` span."""

from benchmark.harness.spans import span_figure


def read(record):
    work = record.get("work", {})
    ms = span_figure(record, "detect", "maskrcnn/roi_align", "device_ms")
    if ms is None or ms <= 0 or not work.get("roi_align_bytes"):
        return None
    return 100.0 * work["roi_align_bytes"] / record["peaks"]["hbm_bytes"] / (ms / 1e3)
