"""Seconds a round trip converting HE -> SS and SS -> HE (spans he2ss and ss2he, mpc/ss_he.py)."""

from gwasbench import readers


def read(run):
    return readers.span_per_unit(run, "he2ss", "ss2he")
