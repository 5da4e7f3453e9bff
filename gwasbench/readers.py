"""Shared arithmetic of the metric readers (gwasbench/metrics/*.py).  A
reader gets the run's record: "units" (each unit of the window: "s" its
wall seconds, "spans" the hub's span seconds, "net_bytes" the hub's
Network bytes sent and received), "work" (per unit), "setup_s", "trace"
(trace.summarize's summary, or None), "launches" (each roofline kernel's
recorded launches), "peaks" and "root"."""

from __future__ import annotations

from . import trace


def rate(run: dict) -> float | None:
    """All the units' work over all their seconds."""
    secs = sum(u["s"] for u in run["units"])
    return len(run["units"]) * run["work"] / secs if secs > 0 else None


def seconds_per_unit(run: dict) -> float | None:
    n = len(run["units"])
    return sum(u["s"] for u in run["units"]) / n if n else None


def span_per_unit(run: dict, *names: str) -> float | None:
    """The named spans' seconds a unit (summed over the names), None where no
    unit has any of them."""
    units = run["units"]
    if not units or not any(n in u["spans"] for u in units for n in names):
        return None
    return sum(u["spans"].get(n, 0.0) for u in units for n in names) / len(units)


def idle_share(run: dict) -> float | None:
    """1 - device busy seconds / traced window seconds, in %."""
    s = run["trace"]
    if not s or s["busy_s"] <= 0 or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def roofline(run: dict, kernel: str) -> float | None:
    if not run["trace"] or not run["launches"]:
        return None
    return trace.roofline_share(run["root"], kernel, run["launches"].get(kernel, []),
                                run["trace"], run["peaks"])
