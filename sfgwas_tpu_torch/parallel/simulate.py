"""Single-host multi-party simulation (counterpart of
sfgwas_tpu/parallel/simulate.py).

Parties run as threads over an in-process queue mesh (LocalCluster); the
same protocol code runs unchanged over another transport.  On a card the
threads share it, each on the default stream.
"""

from __future__ import annotations

import threading
import traceback
from typing import Callable, List, Optional

from ..mpc.prg import Random
from .transport import LocalCluster, Network


def run_network_parties(
    nparty: int, fn: Callable[[Network], object], hub_pid: int = 1, timeout: float = 1800.0
) -> List[object]:
    """Run fn(net) on every party (0 = dealer) in threads, each with its
    own Network and PRG table (net.rand); returns the results indexed by
    pid.  Re-raises the first party exception; raises TimeoutError if a
    party is still running after `timeout` seconds."""
    cluster = LocalCluster(nparty)
    results: List[object] = [None] * nparty
    errors: List[Optional[BaseException]] = [None] * nparty

    def work(pid: int):
        try:
            net = Network(cluster.transport(pid), pid, nparty, hub_pid, Random(pid, nparty))
            results[pid] = fn(net)
        except BaseException as e:  # noqa: BLE001 - reported and re-raised by the caller
            traceback.print_exc()
            errors[pid] = e

    threads = [threading.Thread(target=work, args=(p,), daemon=True) for p in range(nparty)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    for e in errors:
        if e is not None:
            raise e
    alive = [p for p, t in enumerate(threads) if t.is_alive()]
    if alive:
        raise TimeoutError(f"parties {alive} still running after {timeout} s")
    return results
