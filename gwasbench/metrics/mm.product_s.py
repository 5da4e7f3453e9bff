"""Seconds a call in the block products (span assoc_mm, gwas/matmult.py)."""

from gwasbench import readers


def read(run):
    return readers.span_per_unit(run, "assoc_mm")
