"""Seconds a call in the association driver's std-inverse step (span std_inv, gwas/assoc.py)."""

from gwasbench import readers


def read(run):
    return readers.span_per_unit(run, "std_inv")
