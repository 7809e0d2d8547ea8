"""The canonicalizer's data movement against the HBM roofline, in percent.

The floor is the input batch read once, the resized crop written once and
the canonical batch written once, at the configuration's dtypes
(`harness/work.canon_bytes`), over the card's 3.35 TB/s. The time is the
canonicalizer's span less its energy network's span (crop and resize,
selection, warp), as a mean per batch. The same bytes count whatever
implements the warp."""

import statistics


def read(record):
    spans = record.get("spans_ms", {})
    canon, net = spans.get("canonicalizer"), spans.get("canonicalization_network")
    work = record.get("work", {})
    if record.get("mode") != "serve" or not canon or not net or "canon_bytes" not in work:
        return None
    ms = statistics.fmean(canon) - statistics.fmean(net)
    if ms <= 0:
        return None
    floor_s = work["canon_bytes"] / record["peaks"]["hbm_bytes"]
    return 100.0 * floor_s / (ms / 1e3)
