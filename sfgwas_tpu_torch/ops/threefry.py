"""Threefry-2x32 as jax.random computes it, in plain Python/torch.

The reference draws its common reference polynomials and bootstrap masks
with jax.random (sfgwas_tpu/crypto/ckks.py::device_uniform_b,
sfgwas_tpu/mpc/mhe.py::_bs_share_kernel).  Parties of both packages must
draw the same bits, so this module reproduces jax's stream exactly, for jax
with `jax_threefry_partitionable` on (the default of jax 0.9):

* PRNGKey(s) for a 32-bit s is the key (0, s);
* fold_in(key, d) is threefry2x32(key, (0, d));
* bits(key, shape) of uint32 numbers the flattened shape with a 64-bit
  counter c and returns y0 ^ y1 of threefry2x32(key, (c >> 32, c & mask)).

The same hash is the device function csrc/threefry.cuh, which the kernels
K4 (csrc/crp.cu) and K5 (csrc/bs_share.cu) use; the functions here are their
plain versions.  Values are Python ints or int64 tensors holding uint32
words.
"""

from __future__ import annotations

from typing import Tuple

import torch

MASK = 0xFFFFFFFF
PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """The 20-round Threefry-2x32 hash of the counter pair (x0, x1) under
    the key (k0, k1), as jax's threefry2x32_p; returns (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    return threefry2x32(key[0], key[1], 0, int(data) & MASK)


def derive_key(seed_lo: int, seed_hi: int, idx: int) -> Tuple[int, int]:
    """fold_in(fold_in(PRNGKey(seed_lo), seed_hi), idx): the key both
    reference draws use."""
    return fold_in(fold_in((0, int(seed_lo) & MASK), seed_hi), idx)


def bits(key: Tuple[int, int], start: int, count: int, device) -> torch.Tensor:
    """Words start .. start+count-1 of jax.random.bits(key, shape, uint32)
    over the flattened shape, as an int64 tensor [count] on `device`."""
    c = torch.arange(start, start + count, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key[0], key[1], c >> 32, c & MASK)
    return y0 ^ y1
