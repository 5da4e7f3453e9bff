"""Input SNPs whose statistics were produced and collectively decrypted, over the summed wall seconds of the window's association calls; host clock."""

from gwasbench import readers


def read(run):
    return readers.rate(run)
