"""K1's share of its roofline over the traced window, in %: the sum of each launch's bound (gwasbench/rooflines/ntt.py) over the device seconds of K1's events."""

from gwasbench import readers


def read(run):
    return readers.roofline(run, "ntt")
