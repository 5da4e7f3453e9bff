"""Seconds a call the hub waits for the prefetch thread's host encode (span assoc_encode_wait, gwas/assoc.py)."""

from gwasbench import readers


def read(run):
    return readers.span_per_unit(run, "assoc_encode_wait")
