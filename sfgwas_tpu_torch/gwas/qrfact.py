"""Distributed QR factorization over encrypted, row-partitioned matrices
(counterpart of sfgwas_tpu/gwas/qrfact.py): the CholeskyQR2 covariate basis
(net_cholqr_enc) and the method dispatch (net_qr).

The column-by-column Householder path (net_dqr_enc, its party-0 side and
net_dqr_plain), which runs only when a config sets qr_method =
"householder", is not ported yet: ROADMAP A9c.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..crypto import basics as B
from ..mpc import linalg, mhe, ss_he
from ..mpc.mhe import CryptoParams
from ..mpc.mpc import MPC
from ..utils import prof
from ..utils.log import log


def net_cholqr_enc(
    cps: CryptoParams,
    mpc: MPC,
    A: B.CipherMatrix,
    nrows_all: List[int],
    passes: int = 2,
) -> B.CipherMatrix:
    """CholeskyQR2 orthonormalization of the row-partitioned encrypted
    matrix A (A[c] a CipherVector of this party's rows of column c).
    Returns Q scaled by sqrt(N), upper-triangularly related to A (the first
    j output columns span the first j input columns), trailing slots
    masked.  Party 0 passes [None] * ncols and gets [None] * ncols back.

    Per pass: G = A^T A / N by batched HE inner products (one aggregation
    round for all k(k+1)/2 entries), HE->SS, the factorization in secret
    shares (mpc/linalg.py chol_whiten), SS->HE of the whitener entries in one
    packed ciphertext, and Q = A W as batched scalar products.  The second
    pass takes the orthogonality error from kappa^2 eps down to eps."""
    pid = mpc.pid
    ring = mpc.ring
    slots = cps.slots if pid > 0 else 0
    ncols = len(A)
    tot_n = sum(nrows_all[1:])
    inv_n = 1.0 / tot_n
    qr_band = min(cps.ctx.nq, cps.rot_nmod + 2) if cps else 0
    pairs = [(i, j) for i in range(ncols) for j in range(i, ncols)]

    # clamp the inputs down into the band first (level drops are lossless):
    # a top-level ciphertext would push the refresh target to nq, where the
    # bootstrap has no scale-reset headroom; columns already below the band
    # stay put and the in-band refresh raises them
    if pid > 0:
        A = [[cps.ctx.drop_to(ct, min(qr_band, ct.nmod)) for ct in col] for col in A]

    for p in range(passes):
        log(f"pid{pid} cholQR pass {p + 1}/{passes} ({ncols} cols)")
        if pid > 0:
            with prof.span("cholqr_gram"):
                A = mhe.bootstrap_mat_all(mpc.net, cps, A, target_nmod=qr_band)
                nct_g = (ncols * ncols - 1) // slots + 1
                # one batched relinearising product for all k(k+1)/2 pairs,
                # one shared rotation ladder, one mask-scatter per output
                prods = None
                for t in range(len(A[0])):
                    row = B.cmult_pairs(
                        cps, [A[i][t] for (i, j) in pairs], [A[j][t] for (i, j) in pairs]
                    )
                    prods = row if prods is None else [
                        cps.ctx.add(a_, b_) for a_, b_ in zip(prods, row)
                    ]
                sums = B.rotate_and_add_many(cps, prods, slots)
                slot_lists = [
                    [i * ncols + j] if i == j else [i * ncols + j, j * ncols + i]
                    for (i, j) in pairs
                ]
                zloc = B.mask_scatter_sum(
                    cps, sums, slot_lists, nct_g, value=inv_n, cache_key=("cholqr_gram", ncols)
                )
                z = mhe.aggregate_cvec(mpc.net, cps, zloc)
                z = mhe.bootstrap_vec(mpc.net, cps, z, -1)
        else:
            z = None

        zss = ss_he.cvec_to_ss(mpc, cps, z, -1, ncols * ncols)
        G = zss.reshape(ncols, ncols, ring.nlimb)
        with prof.span("cholqr_ss"):
            W = linalg.chol_whiten(mpc, G)

        # SS->HE: one packed ciphertext carries all k(k+1)/2 whitener
        # entries; a batched one-hot multiply and a shared rotation ladder
        # replicate each entry across the slots
        if pid > 0:
            ent = np.stack([np.asarray(W[i, j]) for (i, j) in pairs])[None]
        else:
            ent = ring.zeros((1, len(pairs)))
        w_cm = ss_he.ss_to_cmat(mpc, cps, ent)

        if pid > 0:
            with prof.span("cholqr_recombine"):
                # drift compensation: column scales differ by a few permille
                # when the band sits at the top (no bootstrap reset); s_ref /
                # s_i folds into pair (i, j)'s expanded whitener entry so
                # every product lands on s_ref exactly
                s_ref = max(A[i][0].scale for i in range(ncols))
                w_list = []
                for tcid, wct in enumerate(w_cm[0]):
                    lo = tcid * slots
                    n_here = min(slots, len(pairs) - lo)
                    w_list.extend(
                        B.expand_slots_many(
                            cps, wct, list(range(n_here)),
                            cache_key=("cholqr_w", len(pairs), tcid),
                            value_scales=[
                                s_ref / A[pairs[lo + e][0]][0].scale for e in range(n_here)
                            ],
                        )
                    )
                # cmult_pairs aligns levels down (the expanded w sits one
                # mask level below A; A is refreshed again next pass)
                w_ct = {pr: w_list[e] for e, pr in enumerate(pairs)}
                newA = [[None] * len(A[0]) for _ in range(ncols)]
                for t in range(len(A[0])):
                    col = B.cmult_pairs(
                        cps, [A[i][t] for (i, j) in pairs], [w_ct[(i, j)] for (i, j) in pairs]
                    )
                    out_scale = col[0].scale * s_ref / A[pairs[0][0]][t].scale
                    summed = B.add_group_mod(
                        cps, col, [j for (i, j) in pairs], ncols, out_scale=out_scale
                    )
                    for j in range(ncols):
                        newA[j][t] = summed[j]
                A = newA

    if pid == 0:
        return [None] * ncols
    A = mhe.bootstrap_mat_all(mpc.net, cps, A, target_nmod=qr_band)
    nrows = nrows_all[pid]
    params = cps.ctx.params
    for i in range(len(A)):
        for j2 in range(len(A[i])):
            nk = slots if j2 < len(A[i]) - 1 else ((nrows - 1) % slots) + 1
            # retarget every column to exactly the scale of a freshly encoded
            # chain (Delta^2 / top pair): downstream code mixes Q with fresh
            # columns (the combined basis' ones column)
            ct = A[i][j2]
            tgt = (
                params.scale ** 2
                / cps.ctx.basis.primes[ct.nmod - 1]
                / cps.ctx.basis.primes[ct.nmod - 2]
            )
            A[i][j2] = B.mask_trunc(cps, ct, nk, target_scale=tgt)
    return A


def net_qr(
    cps: CryptoParams,
    mpc: MPC,
    A: B.CipherMatrix,
    nrows_all: List[int],
    method: str = "cholqr2",
) -> B.CipherMatrix:
    """QR method dispatch: 'cholqr2' (the default, net_cholqr_enc with two
    passes) or 'cholqr3' (three).  'householder' is the reference's
    net_dqr_enc, which the port does not have yet."""
    if method == "householder":
        raise NotImplementedError(
            "qr_method 'householder' (net_dqr_enc) is not ported yet (ROADMAP A9c); "
            "use the default 'cholqr2'"
        )
    if method == "cholqr3":
        return net_cholqr_enc(cps, mpc, A, nrows_all, passes=3)
    assert method == "cholqr2", f"unknown qr_method {method!r}"
    return net_cholqr_enc(cps, mpc, A, nrows_all, passes=2)
