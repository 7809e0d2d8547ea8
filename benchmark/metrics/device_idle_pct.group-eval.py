"""The share of the traced window of the group evaluation in which no device
operation ran, in percent."""

from benchmark.harness.readings import idle


def read(record):
    return idle(record, "group-eval")
