"""Seconds a round trip in the SS square root and inverse (span ss_sqrt, mpc/mpc.py over ops/ring.py and the native ring)."""

from gwasbench import readers


def read(run):
    return readers.span_per_unit(run, "ss_sqrt")
