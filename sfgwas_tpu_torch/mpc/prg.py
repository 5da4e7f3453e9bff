"""Correlated randomness: pairwise counter-based PRGs (counterpart of
sfgwas_tpu/mpc/prg.py, which it copies: the same keys give the same streams
in both packages, so parties of either share their correlated randomness).

The PRG table of the original Go sfgwas (mpc/random.go:14-142): one
generator per party pair (keyed from shared key files), one global
generator shared by everyone, and one local generator.
The ``switch/restore`` discipline lets the dealer (party 0) and each data
party derive identical mask tensors with zero communication -- the mechanism
behind the one-round Beaver partition (mpc/beavermult.go:25-46).

Implementation: numpy Philox (counter-based) streams.  Both ends of a pair
hold the same key and advance their counters in lockstep, exactly like the
reference's buffered ChaCha20 streams.  Keys are derived from the shared key
files in ``shared_keys_path`` when provided (same file layout as the
reference: shared_key_<a>_<b>.bin, shared_key_global.bin), else from the
party pair itself (insecure fallback, mirroring mpc/random.go:36).
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Optional

import numpy as np

GLOBAL_PRG = -1


def _key_from_bytes(data: bytes) -> np.ndarray:
    h = hashlib.sha256(data).digest()
    return np.frombuffer(h[:16], dtype=np.uint64).copy()


class Random:
    """PRG table with switch/restore discipline (mpc/random.go:82-91)."""

    def __init__(self, pid: int, nparty: int, shared_keys_path: Optional[str] = None):
        self.pid = pid
        self.table: Dict[int, np.random.Generator] = {}

        def load_key(name: str, fallback: bytes) -> bytes:
            if shared_keys_path:
                path = os.path.join(shared_keys_path, name)
                with open(path, "rb") as f:
                    return f.read()
            return fallback

        gkey = load_key("shared_key_global.bin", b"global")
        self.table[GLOBAL_PRG] = np.random.Generator(
            np.random.Philox(key=_key_from_bytes(gkey))
        )
        for other in range(nparty):
            if other == pid:
                continue
            a, b = min(pid, other), max(pid, other)
            pkey = load_key(f"shared_key_{a}_{b}.bin", f"pair{a}_{b}".encode())
            self.table[other] = np.random.Generator(
                np.random.Philox(key=_key_from_bytes(pkey))
            )
        # Local PRG: unique per party (need not be shared)
        self.table[pid] = np.random.Generator(
            np.random.Philox(key=_key_from_bytes(os.urandom(16)))
        )
        self._cur = pid
        self._stack = []

    # -- stream selection ---------------------------------------------------

    def switch(self, other_pid: int):
        self._stack.append(self._cur)
        self._cur = other_pid

    def restore(self):
        self._cur = self._stack.pop() if self._stack else self.pid

    def cur(self) -> np.random.Generator:
        return self.table[self._cur]

    class _Switched:
        def __init__(self, rand, other):
            self.rand, self.other = rand, other

        def __enter__(self):
            self.rand.switch(self.other)
            return self.rand.cur()

        def __exit__(self, *a):
            self.rand.restore()

    def using(self, other_pid: int) -> "_Switched":
        """Context manager: `with rand.using(0) as g: g.integers(...)`."""
        return Random._Switched(self, other_pid)

    # -- draws (shapes must match on both ends, like the reference) ---------

    def rand_elem(self, ring):
        return ring.rand(self.cur(), ())

    def rand_vec(self, ring, n: int):
        return ring.rand(self.cur(), (n,))

    def rand_mat(self, ring, r: int, c: int):
        return ring.rand(self.cur(), (r, c))

    def rand_vec_bits(self, ring, n: int, nbits: int):
        return ring.rand_bits(self.cur(), (n,), nbits)

    def rand_mat_bits(self, ring, r: int, c: int, nbits: int):
        return ring.rand_bits(self.cur(), (r, c), nbits)

    def rand_int(self, n: int) -> int:
        """Uniform in [0, n) -- used by the PCA sketch (gwas/pca.go:130)."""
        return int(self.cur().integers(0, n))

    def rand_bytes(self, n: int) -> bytes:
        return self.cur().bytes(n)

    def fork(self, stream_id: int) -> "Random":
        """Derive an independent table for a parallel protocol thread,
        mirroring InitializeParallelPRG (mpc/netconnect.go:157-172).
        Both ends must fork in the same order."""
        child = Random.__new__(Random)
        child.pid = self.pid
        child._cur = self.pid
        child._stack = []
        child.table = {}
        for k, gen in self.table.items():
            seed = gen.bytes(16)  # advances parent stream deterministically
            child.table[k] = np.random.Generator(
                np.random.Philox(key=_key_from_bytes(seed + bytes([stream_id % 256])))
            )
        return child
