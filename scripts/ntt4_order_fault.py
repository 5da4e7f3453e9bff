#!/usr/bin/env python3
"""The reference's four-step NTT with one prime row at PN14QP438, on the CPU.

    JAX_PLATFORMS=cpu python scripts/ntt4_order_fault.py

sfgwas_tpu/ops/ntt4.py::Ntt4Plan recovers its output order pi by matching
values against the butterfly, with one row on that row alone; at n = 2^14
and q ~ 2^25 the values collide.  For each row set this prints the distinct
entries of the reference's pi (of n), and on one fresh input the
coefficients where its forward and its inverse differ from the butterfly
(the reference's own, which the port's K1 and its plain version equal bit
for bit)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sfgwas_tpu.crypto.params import get_params  # noqa: E402
from sfgwas_tpu.ops import ntt4 as RN  # noqa: E402
from sfgwas_tpu.ops import rns as RR  # noqa: E402


def main():
    p = get_params("PN14QP438")
    b = p.basis
    for rows in [(p.sp_row,), (0,), (3,), (0, 1)]:
        plan = RN.get_plan(b, rows)
        rng = np.random.default_rng(7)
        x = np.stack([rng.integers(0, b.primes[r], b.n) for r in rows]).astype(np.uint32)
        ref = np.asarray(RR._ntt_butterfly(jnp.asarray(x), b, rows))
        fwd = np.asarray(RN.ntt4(jnp.asarray(x), b, rows))
        back = np.asarray(RN.ntt4(jnp.asarray(ref), b, rows, inverse=True))
        print(f"rows {rows}: reference pi {len(set(np.asarray(plan.pi).tolist()))} distinct of "
              f"{b.n}, forward off at {int((fwd != ref).sum())}, inverse off at "
              f"{int((back != x).sum())}")


if __name__ == "__main__":
    main()
