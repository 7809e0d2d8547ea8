"""Mean milliseconds per served batch inside `pipeline.prediction_network`
(ResNet-50), from the span of the harness's hooks around that module."""

import statistics


def read(record):
    spans = record.get("spans_ms", {}).get("prediction_network")
    if record.get("mode") != "serve" or not spans:
        return None
    return statistics.fmean(spans)
