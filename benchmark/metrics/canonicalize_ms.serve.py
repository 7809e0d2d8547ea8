"""Mean milliseconds per served batch inside `pipeline.canonicalizer`
(crop and resize, energy network, selection, warp), from the span of the
harness's hooks around that module."""

import statistics


def read(record):
    spans = record.get("spans_ms", {}).get("canonicalizer")
    if record.get("mode") != "serve" or not spans:
        return None
    return statistics.fmean(spans)
