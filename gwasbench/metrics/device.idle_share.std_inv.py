"""The card's idle share of the traced window of std-inverse round trips, in % (torch.profiler over every thread)."""

from gwasbench import readers


def read(run):
    return readers.idle_share(run)
