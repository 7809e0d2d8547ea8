"""Arithmetic shared by the per-layer readers of `benchmark/metrics/`: a
step's share of the bf16 peak (the reference's FLOPs per batch or step times
those completed in the traced window, over the window's seconds and the
card's bf16 dense peak) and the device's idle share of the traced window."""


def mfu(record, mode):
    tr, work = record.get("trace"), record.get("work", {})
    if record.get("mode") != mode or not tr or not work.get("flops_per_iter"):
        return None
    if tr.get("window_s", 0) <= 0 or tr.get("iterations", 0) <= 0:
        return None
    rate = work["flops_per_iter"] * tr["iterations"] / tr["window_s"]
    return 100.0 * rate / record["peaks"]["bf16_flops"]


def idle(record, mode):
    tr = record.get("trace")
    if record.get("mode") != mode or not tr or tr.get("window_s", 0) <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
