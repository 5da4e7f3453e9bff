"""Process-memory watchdog honoring the `memory_limit` config field
(counterpart of sfgwas_tpu/utils/watchdog.py).

The Go sfgwas installs raulk/go-watchdog's heap-driven GC watermark policy
(sfgwas.go:64) so a party process stays under `memory_limit` bytes.  Here a
daemon thread samples RSS; above the soft watermark it forces a
gc.collect() (dropping unreachable ciphertext and key tensors promptly),
and above the hard limit it logs loudly so operators see the breach before
the OOM killer does.
"""

from __future__ import annotations

import gc
import os
import threading
import time

from .log import log


def _rss_bytes() -> int:
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


class MemoryWatchdog:
    """Daemon sampling thread; start() is a no-op if limit_bytes <= 0."""

    def __init__(self, limit_bytes: int, interval_s: float = 5.0):
        self.limit = int(limit_bytes)
        self.interval = interval_s
        self._stop = threading.Event()
        self._thread = None
        self.peak = 0

    def start(self):
        if self.limit <= 0 or self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def _run(self):
        soft = int(self.limit * 0.85)
        warned = 0.0
        while not self._stop.wait(self.interval):
            rss = _rss_bytes()
            self.peak = max(self.peak, rss)
            if rss > soft:
                gc.collect()
                rss = _rss_bytes()
            if rss > self.limit and time.time() - warned > 60:
                warned = time.time()
                log(
                    f"[watchdog] RSS {rss / 1e9:.1f} GB exceeds memory_limit "
                    f"{self.limit / 1e9:.1f} GB"
                )
