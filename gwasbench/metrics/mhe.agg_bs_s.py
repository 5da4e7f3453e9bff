"""Seconds a call aggregating and refreshing the products (span assoc_agg_bs, mpc/mhe.py's collectives)."""

from gwasbench import readers


def read(run):
    return readers.span_per_unit(run, "assoc_agg_bs")
