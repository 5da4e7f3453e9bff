"""Seconds a call computing the covariate basis (span combined_q: gwas/qrfact.py's cholqr2)."""

from gwasbench import readers


def read(run):
    return readers.span_per_unit(run, "combined_q")
