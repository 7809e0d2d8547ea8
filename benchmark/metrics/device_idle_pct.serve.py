"""The share of the traced window in which no operation ran on the
device, in percent: 100 less the union of the device's kernel, copy and
set intervals over the window's host-clock length."""

from benchmark.harness.readings import idle


def read(record):
    return idle(record, "serve")
