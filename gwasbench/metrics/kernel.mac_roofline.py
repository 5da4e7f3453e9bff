"""K2's share of its roofline over the traced window, in %: the sum of each launch's bound (gwasbench/rooflines/mac_dense.py) over the device seconds of K2's events."""

from gwasbench import readers


def read(run):
    return readers.roofline(run, "mac_dense")
