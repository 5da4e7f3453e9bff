"""Single-host multi-party simulation (counterpart of
sfgwas_tpu/parallel/simulate.py).

Parties run as threads over an in-process queue mesh (LocalCluster); the
same protocol code runs unchanged over another transport.  On a card the
threads share it, each on the default stream.  run_parties gives each party
an MPC engine (the secret-sharing protocols) over its Network.
"""

from __future__ import annotations

import threading
import traceback
from typing import Callable, List, Optional

import numpy as np

from ..mpc.mpc import MPC
from ..mpc.prg import Random
from ..ops import ring as R
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


def run_parties(
    nparty: int,
    fn: Callable[[MPC], object],
    ring: R.Ring = R.LElem256,
    data_bits: int = 60,
    frac_bits: int = 30,
    boolean_shares: bool = True,
    hub_pid: int = 1,
    div_sqrt_max_len: int = 1_000_000,
    timeout: float = 1800.0,
) -> List[object]:
    """Run fn(mpc) on every party (0 = dealer) in threads; returns the
    results indexed by pid.  The defaults are config/configGlobal.toml's:
    the 256-bit field, 60 data bits, 30 fraction bits, boolean shares and
    div_sqrt_max_len 1e6."""
    return run_network_parties(
        nparty,
        lambda net: fn(MPC(net, ring, data_bits, frac_bits, boolean_shares, div_sqrt_max_len)),
        hub_pid,
        timeout,
    )


def make_shares(mpc: MPC, vals, ring=None):
    """Deterministic (non-secret) sharing of known values, for tests and
    checks: all parties derive the same 'random' shares from the global
    PRG; party 1 holds the correcting share; the dealer holds zeros."""
    ring = ring or mpc.ring
    vals = list(vals)
    n = len(vals)
    with mpc.rand.using(-1) as g:
        others = [ring.rand(g, (n,)) for _ in range(max(0, mpc.nparty - 2))]
    if mpc.pid == 0:
        return ring.zeros((n,))
    if mpc.pid == 1:
        out = ring.from_ints(vals) if hasattr(ring, "from_ints") else np.asarray(vals, np.int32)
        for s in others:
            out = ring.sub(out, s)
        return out
    return others[mpc.pid - 2]


def reveal_ints(mpc: MPC, shares, ring=None):
    """Reveal and decode to python ints at the data parties (None at the
    dealer)."""
    ring = ring or mpc.ring
    rev = mpc.reveal_sym(shares, ring)
    if mpc.pid == 0:
        return None
    if hasattr(ring, "to_ints"):
        return ring.to_ints(rev)
    return np.asarray(rev)
