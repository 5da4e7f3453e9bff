"""Secret-shared linear algebra (counterpart of sfgwas_tpu/mpc/linalg.py):
the Cholesky whitener of a shared Gram matrix that the CholeskyQR of the
covariate basis runs, with the helpers it calls.  Matrices are digit arrays
[r, c, nlimb]; the routines run on small (k x k) matrices, so the round
count dominates.
"""

from __future__ import annotations

import numpy as np

from ..ops import ring as R
from .mpc import MPC


def ss_mult_vec_scalar(mpc: MPC, d, scalar):
    """Vector times secret scalar (SSMultElemVecScalar, mpc/ss.go:28-36)."""
    dr, dm = mpc.beaver_partition(d)
    sr, sm = mpc.beaver_partition(scalar)
    out = mpc.beaver_mult_elem(dr, dm, sr[None], sm[None])
    return mpc.beaver_reconstruct(out)


def chol_whiten(mpc: MPC, G):
    """Upper-triangular whitener of a shared symmetric PD Gram matrix:
    returns W [n, n, L] with W^T G W = I.

    A redesign of the Go sfgwas' per-column Householder orthogonalization
    (gwas/qrfact.go:47-316): the caller computes G = A^T A (cheap, batched,
    in HE), this routine factors it entirely in secret shares, and A W then
    orthonormalizes A with two collective rounds instead of ~6 per column.

    Numerics: G is first rescaled to correlation form (D^{-1/2} G D^{-1/2},
    one BATCHED inverse-sqrt for the whole diagonal), which removes the
    column-scale disparities that dominate ill-conditioning of covariate
    blocks; then a fixed-point Cholesky G_hat = L L^T and a triangular
    inverse M = L^{-1} by forward substitution (no divisions: the pivot
    inverse 1/d_i falls out of sqrt_and_sqrt_inverse).  W = D^{-1/2} M^T is
    upper triangular, so span(first j columns of A W) = span(first j
    columns of A) -- the property compute_combined_q's ones-column
    replacement relies on (gwas/assoc.go:104-120)."""
    ring = mpc.ring
    kb, fb = mpc.data_bits, mpc.frac_bits
    n = G.shape[0]
    dg = np.arange(n)

    # correlation form: one batched sqrt over the diagonal
    _, dinv = mpc.sqrt_and_sqrt_inverse(G[dg, dg], mpc.boolean_shares)
    dr, dm = mpc.beaver_partition(dinv)
    gr, gm = mpc.beaver_partition(G)
    t1 = mpc.beaver_reconstruct(
        mpc.beaver_mult_elem(gr, gm, dr[:, None], dm[:, None])
    )
    t1 = mpc.trunc(t1, kb, fb)
    t1r, t1m = mpc.beaver_partition(t1)
    Gh = mpc.beaver_reconstruct(
        mpc.beaver_mult_elem(t1r, t1m, dr[None, :], dm[None, :])
    )
    Gh = mpc.trunc(Gh, kb, fb)

    Lm = ring.zeros((n, n))  # Cholesky factor of Gh (lower)
    M = ring.zeros((n, n))  # L^{-1} (lower), built by forward substitution
    for i in range(n):
        if i > 0:
            pr, pm = mpc.beaver_partition(Lm[i, :i])
            sq = mpc.beaver_reconstruct(mpc.beaver_mult_elem(pr, pm, pr, pm))
            sq = mpc.trunc(sq, kb, fb)
            s = ring.sub(Gh[i, i][None], ring.sum(sq, axis=0)[None])
        else:
            s = Gh[i, i][None]
        _, pinv = mpc.sqrt_and_sqrt_inverse(s, False)  # [1, L]
        # d_i itself is never needed: L[i,i] enters later columns only
        # through products with 1/d_i-scaled terms; store d_i = s * pinv
        d = mpc.ss_mult_elem(s, pinv)
        d = mpc.trunc(d, kb, fb)
        Lm = R.aset(Lm, (i, i), d[0])
        M = R.aset(M, (i, i), pinv[0])
        if i + 1 < n:
            if i > 0:
                br, bm = mpc.beaver_partition(Lm[i + 1 :, :i])
                rr, rm = mpc.beaver_partition(Lm[i, :i])
                prod = mpc.beaver_reconstruct(
                    mpc.beaver_mult_elem(br, bm, rr[None], rm[None])
                )
                prod = mpc.trunc(prod, kb, fb)
                c = ring.sub(Gh[i + 1 :, i], ring.sum(prod, axis=1))
            else:
                c = Gh[i + 1 :, i]
            col = ss_mult_vec_scalar(mpc, c, pinv[0])
            col = mpc.trunc(col, kb, fb)
            Lm = R.aset(Lm, (slice(i + 1, None), i), col)
        if i > 0:
            # M[i, :i] = -1/d_i * (L[i, :i] @ M[:i, :i])
            rr, rm = mpc.beaver_partition(Lm[i, :i])
            sr2, sm2 = mpc.beaver_partition(M[:i, :i])
            prod = mpc.beaver_reconstruct(
                mpc.beaver_mult_elem(sr2, sm2, rr[:, None], rm[:, None])
            )
            prod = mpc.trunc(prod, kb, fb)
            v = ring.sum(prod, axis=0)  # [i, L]
            v = ss_mult_vec_scalar(mpc, v, pinv[0])
            v = mpc.trunc(v, kb, fb)
            M = R.aset(M, (i, slice(None, i)), ring.neg(v))

    # W = D^{-1/2} M^T (rows of M^T scaled by dinv)
    mtr, mtm = mpc.beaver_partition(np.swapaxes(M, 0, 1))
    W = mpc.beaver_reconstruct(
        mpc.beaver_mult_elem(mtr, mtm, dr[:, None], dm[:, None])
    )
    return mpc.trunc(W, kb, fb)
