"""Seconds a std-inverse round trip: the window's seconds over its whole round trips; host clock."""

from gwasbench import readers


def read(run):
    return readers.seconds_per_unit(run)
