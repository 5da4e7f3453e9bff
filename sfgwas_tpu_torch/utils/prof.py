"""Opt-in wall-clock attribution for protocol hot spots.

Enable with SFGWAS_PROF=1: `span("name")` contexts accumulate per-thread
wall time; dump() prints totals, events() lists each span as it ended (in
order, so a caller can split the totals per iteration).  Zero overhead when
disabled.

Device work runs asynchronously, so a span measures the host's enqueue time
unless SYNC is set to a function that waits for the device (for example
torch.cuda.synchronize): it is then called on entry and exit of each span,
and the span's time includes the device work launched inside it."""

from __future__ import annotations

import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

ENABLED = bool(os.environ.get("SFGWAS_PROF"))
SYNC = None
_local = threading.local()


def _acc():
    d = getattr(_local, "d", None)
    if d is None:
        d = _local.d = defaultdict(lambda: [0.0, 0])
        _local.log = []
    return d


@contextmanager
def _span(name: str):
    d = _acc()
    if SYNC is not None:
        SYNC()
    t0 = time.time()
    try:
        yield
    finally:
        if SYNC is not None:
            SYNC()
        dt = time.time() - t0
        e = d[name]
        e[0] += dt
        e[1] += 1
        _local.log.append((name, dt))


def span(name: str):
    return _span(name) if ENABLED else nullcontext()


def totals() -> dict:
    """{span name: (seconds, count)} accumulated by this thread."""
    return {k: (v[0], v[1]) for k, v in _acc().items()}


def events() -> list:
    """[(span name, seconds)] of this thread, in the order the spans ended."""
    _acc()
    return list(_local.log)


def dump(tag: str = ""):
    if not ENABLED:
        return
    d = _acc()
    items = sorted(d.items(), key=lambda kv: -kv[1][0])
    print(
        f"[prof {tag}] "
        + "  ".join(f"{k}={v[0]:.1f}s/{v[1]}" for k, v in items[:12]),
        flush=True,
    )


def reset():
    if ENABLED:
        _acc().clear()
        _local.log.clear()
