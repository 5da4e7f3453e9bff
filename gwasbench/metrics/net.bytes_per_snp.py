"""The hub's Network bytes, sent plus received, in the window over the input
SNPs (parallel/transport.py's counters; a count that repeats exactly)."""


def read(run):
    units = run["units"]
    if not units:
        return None
    return sum(u["net_bytes"] for u in units) / (len(units) * run["work"])
