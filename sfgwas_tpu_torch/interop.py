"""Carry state of the JAX package across into the port.

The functions take the reference's state as numpy arrays (uint32 residues,
as np.asarray gives them from the reference's objects) and build the port's
objects on a given context's device.  Nothing here imports jax: the caller
converts.  This is the port's counterpart of loading a model's weights.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .crypto import ckks as C
from .gwas.matmult import DiagBlock
from .mpc.mhe import CryptoParams


def crypto_params(
    ctx: C.CkksContext,
    sk: np.ndarray,
    pk: Tuple[np.ndarray, np.ndarray],
    rot_keys: Dict[int, Tuple[np.ndarray, np.ndarray]],
    enc_rng: np.random.Generator = None,
    rlk: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> CryptoParams:
    """SecretKey.s (a party's shard, for a collective bundle), PublicKey
    (p0, p1), rotation keys {g: (d0, d1)} and the relinearisation key
    (d0, d1), if any -> a CryptoParams."""
    return CryptoParams(
        ctx,
        C.SecretKey(ctx.to_dev(sk)),
        C.PublicKey(ctx.to_dev(pk[0]), ctx.to_dev(pk[1])),
        None if rlk is None else C.KSwitchKey(ctx.to_dev(rlk[0]), ctx.to_dev(rlk[1])),
        {int(g): C.KSwitchKey(ctx.to_dev(d0), ctx.to_dev(d1)) for g, (d0, d1) in rot_keys.items()},
        enc_rng,
    )


def bundle_arrays(cps) -> dict:
    """A key bundle on the host (the reference's CryptoParams, or the
    port's on the CPU) as numpy arrays: the keyword arguments of
    crypto_params but the context."""
    a = np.asarray
    return dict(
        sk=a(cps.sk.s), pk=(a(cps.pk.p0), a(cps.pk.p1)),
        rot_keys={g: (a(k.d0), a(k.d1)) for g, k in cps.rot_keys.items()},
        rlk=None if cps.rlk is None else (a(cps.rlk.d0), a(cps.rlk.d1)),
    )


def ciphertext(
    ctx: C.CkksContext, c0: np.ndarray, c1: np.ndarray, nmod: int, scale: float
) -> C.Ciphertext:
    return C.Ciphertext(ctx.to_dev(c0), ctx.to_dev(c1), int(nmod), float(scale))


def cipher_matrix(
    ctx: C.CkksContext,
    cols: Sequence[Sequence[Tuple[np.ndarray, np.ndarray, int, float]]],
) -> List[List[C.Ciphertext]]:
    """A cipher matrix given as columns of (c0, c1, nmod, scale) -> the
    port's list of columns of ciphertexts (a None entry, a party's
    placeholder, stays None)."""
    return [[None if ct is None else ciphertext(ctx, *ct) for ct in col] for col in cols]


def cipher_matrix_arrays(cm) -> List[List[Optional[Tuple[np.ndarray, np.ndarray, int, float]]]]:
    """A cipher matrix on the host (the reference's, or the port's on the
    CPU) as columns of (c0, c1, nmod, scale), the argument of
    cipher_matrix."""
    def arr(x):
        a = np.asarray(x)
        return a.view(np.uint32) if a.dtype == np.int32 else a

    return [
        [None if ct is None else (arr(ct.c0), arr(ct.c1), int(ct.nmod), float(ct.scale))
         for ct in col]
        for col in cm
    ]


def diag_cache(
    ctx: C.CkksContext,
    blocks: Sequence[Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray, int]]],
) -> List[List[DiagBlock]]:
    """A preprocessed diagonal cache given per block as (giants, babies,
    polys [K, nmod, N], d) -> the port's DiagBlocks."""
    return [
        [DiagBlock(g, b, ctx.to_dev(p), int(d)) for g, b, p, d in row]
        for row in blocks
    ]
