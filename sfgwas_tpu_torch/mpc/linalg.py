"""Secret-shared linear algebra (counterpart of sfgwas_tpu/mpc/linalg.py):
the Householder vector, the square QR, the symmetric tridiagonalisation,
the shifted-QR eigendecomposition and the oblivious row sort that PCA runs
on its kp x kp Gram matrix (the Go sfgwas's mpc/mpc.go:2276-2636), the
Cholesky whitener of a shared Gram matrix that the CholeskyQR of the
covariate basis runs, and the matrix inverses over the eigensolver
(mpc/mpc.go:2795-2888) that the logistic path's Newton steps run.  Matrices are digit arrays [r, c, nlimb]; the
routines run on small (k x k) matrices, so the round count dominates, and
they keep the Go sfgwas's structure (its field comparison path inside the
eigensolver, mpc/mpc.go:2310, 2804, included).
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


def _bc(ring, const_digits, shape):
    return np.broadcast_to(np.asarray(const_digits), tuple(shape) + (ring.nlimb,))


def unit_scale(mpc: MPC, x):
    """x times a secret power of two, x' = 2^j x / 2^t with ||x'|| in
    [1/2, 1), for every x whose squared norm the Householder's square root
    takes (||x||^2 < 2^(kb - fb)); x' = 0 for x = 0.

    The Householder vector v(x) is invariant under x -> a x for a > 0, but
    the Go sfgwas forms it from ||x||^2 truncated to fb fraction bits: near
    ||x||^2 ~ 2^-fb only a few bits of it are left, vnorm_inv is then wrong
    and P = I - 2 v v^T is not orthogonal (a near-scalar matrix's
    eigensolver reflects such near-zero columns; ROADMAP C).  The sum of
    squares is exact before its truncation (2 fb fraction bits), so its
    even-power-of-two normaliser 4^j, with 4^j sum in [2^(2h-2), 2^(2h)),
    h = ceil((kb + fb) / 2), brings 2^j x to norm [2^(h-1), 2^h) in units
    of 2^-fb, and a truncation by h - fb bits to [1/2, 1).  The cost is one
    Beaver round, a reshare, the normaliser, one multiply and one
    truncation."""
    kb, fb = mpc.data_bits, mpc.frac_bits
    half = (kb + fb + 1) // 2
    xr, xm = mpc.beaver_partition(x)
    z = mpc.ring.sum(mpc.beaver_mult_elem(xr, xm, xr, xm), axis=0)[None]
    z = mpc.beaver_reconstruct(z)  # sum of squares at 2 fb fraction bits, untruncated
    _, root = mpc.normalizer_even_exp(z, 2 * half, mpc.boolean_shares)
    x = ss_mult_vec_scalar(mpc, x, root[0])
    return mpc.trunc(x, kb, half - fb) if half > fb else x


def householder(mpc: MPC, x):
    """Householder vector of a shared vector (mpc/mpc.go:2276-2324), of x
    brought to unit scale first (unit_scale: the Go sfgwas, and
    sfgwas_tpu/mpc/linalg.py:32-67, form it from x as it is, and lose P's
    orthogonality at ||x|| ~ 2^(-fb/2))."""
    x = unit_scale(mpc, x)
    ring = mpc.ring
    kb, fb = mpc.data_bits, mpc.frac_bits
    is_binary = mpc.boolean_shares

    xr, xm = mpc.beaver_partition(x)
    z = mpc.beaver_mult_elem(xr, xm, xr, xm)
    xdot = ring.sum(z, axis=0)[None]  # [1, L]
    xdot = mpc.beaver_reconstruct(xdot)
    xdot = mpc.trunc(xdot, kb, fb)

    xnorm, _ = mpc.sqrt_and_sqrt_inverse(xdot, is_binary)

    x1sign = mpc.is_positive(x[0:1], is_binary)
    x1sign = ring.mul_int(x1sign, 2)
    if mpc.pid == mpc.hub_pid:
        x1sign = ring.sub(x1sign, _bc(ring, ring.const_np(1), (1,)))

    shift = mpc.ss_mult_elem(xnorm, x1sign)  # [1, L]

    sr, sm = mpc.beaver_partition(shift)
    dot_shift = mpc.beaver_mult_elem(xr[0:1], xm[0:1], sr, sm)
    dot_shift = mpc.beaver_reconstruct(dot_shift)
    dot_shift = mpc.trunc(dot_shift, kb, fb)

    vdot = ring.mul_int(ring.add(xdot, dot_shift), 2)

    _, vnorm_inv = mpc.sqrt_and_sqrt_inverse(vdot, False)

    invr, invm = mpc.beaver_partition(vnorm_inv)
    vr = R.aset(xr, 0, ring.add(xr[0], sr[0]))
    vm = R.aset(xm, 0, ring.add(xm[0], sm[0]))
    v = mpc.beaver_mult_elem(vr, vm, invr, invm)
    v = mpc.beaver_reconstruct(v)
    return mpc.trunc(v, kb, fb)


def qr_fact_square(mpc: MPC, A):
    """QR of a square shared matrix by repeated Householder reflections of
    its rows (mpc/mpc.go:2326-2409): returns (Q, R) with A = R Q, R lower
    triangular."""
    ring = mpc.ring
    kb, fb = mpc.data_bits, mpc.frac_bits
    pid = mpc.pid
    n = A.shape[0]
    one = ring.const_np(1 << fb)

    R_ = ring.zeros((n, n))
    Q = None
    Ap = A

    for i in range(n - 1):
        v = householder(mpc, Ap[0])[None]  # [1, m]
        vt = np.swapaxes(v, 0, 1)  # [m, 1]

        P = mpc.ss_mult_mat(vt, v)
        P = mpc.trunc(P, kb, fb)
        if pid > 0:
            P = ring.mul_int(P, -2)
            if pid == mpc.hub_pid:
                m = P.shape[0]
                diag = np.arange(m)
                P = R.aset(P, (diag, diag), ring.add(P[diag, diag], _bc(ring, one, (m,))))

        if i == 0:
            Q = P
            B = mpc.ss_mult_mat(Ap, P)
            B = mpc.trunc(B, kb, fb)
        else:
            Qsub = Q[i:] if pid > 0 else ring.zeros((n - i, n))
            r0 = mpc.ss_mult_mat(P, Qsub)
            r1 = mpc.ss_mult_mat(Ap, P)
            r0 = mpc.trunc(r0, kb, fb)
            r1 = mpc.trunc(r1, kb, fb)
            if pid > 0:
                Q = R.aset(Q, slice(i, None), r0)
            B = r1

        if pid > 0:
            R_ = R.aset(R_, (slice(i, n), i), B[: n - i, 0])
            if i == n - 2:
                R_ = R.aset(R_, (n - 1, n - 1), B[1, 1])

        Ap = B[1:, 1:] if pid > 0 else ring.zeros((n - i - 1, n - i - 1))
    return Q, R_


def tridiag(mpc: MPC, A):
    """Symmetric tridiagonalisation (mpc/mpc.go:2411-2513): returns (T, Q)."""
    ring = mpc.ring
    kb, fb = mpc.data_bits, mpc.frac_bits
    pid = mpc.pid
    n = A.shape[0]
    one = ring.const_np(1 << fb)

    T = ring.zeros((n, n))
    Q = ring.zeros((n, n))
    if pid == mpc.hub_pid:
        diag = np.arange(n)
        Q = R.aset(Q, (diag, diag), _bc(ring, one, (n,)))

    Ap = A
    for i in range(n - 2):
        m = Ap.shape[0]
        x = Ap[0, 1:] if pid > 0 else ring.zeros((m - 1,))

        v = householder(mpc, x)[None]  # [1, m-1]
        vt = np.swapaxes(v, 0, 1)
        vv = mpc.ss_mult_mat(vt, v)
        vv = mpc.trunc(vv, kb, fb)

        P = ring.zeros((m, m))
        if pid > 0:
            body = ring.mul_int(vv, -2)
            if pid == mpc.hub_pid:
                dg = np.arange(m - 1)
                body = R.aset(body, (dg, dg), ring.add(body[dg, dg], _bc(ring, one, (m - 1,))))
                P = R.aset(P, (0, 0), one)
            P = R.aset(P, (slice(1, None), slice(1, None)), body)

        PAp = mpc.ss_mult_mat(P, Ap)
        PAp = mpc.trunc(PAp, kb, fb)
        B = mpc.ss_mult_mat(PAp, P)
        B = mpc.trunc(B, kb, fb)

        Qsub = Q[:, i:] if pid > 0 else ring.zeros((n, n - i))
        Qsub = mpc.ss_mult_mat(Qsub, P)
        Qsub = mpc.trunc(Qsub, kb, fb)
        if pid > 0:
            Q = R.aset(Q, (slice(None), slice(i, None)), Qsub)

        if pid > 0:
            T = R.aset(T, (i, i), B[0, 0])
            T = R.aset(T, (i + 1, i), B[1, 0])
            T = R.aset(T, (i, i + 1), B[0, 1])
            if i == n - 3:
                T = R.aset(T, (i + 1, i + 1), B[1, 1])
                T = R.aset(T, (i + 1, i + 2), B[1, 2])
                T = R.aset(T, (i + 2, i + 1), B[2, 1])
                T = R.aset(T, (i + 2, i + 2), B[2, 2])

        Ap = B[1:, 1:] if pid > 0 else ring.zeros((m - 1, m - 1))
    return T, Q


def eigen_decomp(mpc: MPC, A, iter_per_eval: int = 5):
    """Shifted-QR eigendecomposition with deflation (mpc/mpc.go:2554-2636).
    Returns (V [n, n], L [n]): the rows of V are eigenvectors."""
    ring = mpc.ring
    kb, fb = mpc.data_bits, mpc.frac_bits
    pid = mpc.pid
    n = A.shape[0]
    Lout = ring.zeros((n,))

    Ap, Q = tridiag(mpc, A)
    V = np.swapaxes(Q, 0, 1) if pid != 0 else ring.zeros((n, n))

    for i in range(n - 1, 0, -1):
        for _ in range(iter_per_eval):
            shift = Ap[i, i]
            if pid > 0:
                diag = np.arange(Ap.shape[0])
                Ap = R.aset(Ap, (diag, diag), ring.sub(Ap[diag, diag], shift[None]))

            Qi, Ri = qr_fact_square(mpc, Ap)
            Ap = mpc.ss_mult_mat(Qi, Ri)
            Ap = mpc.trunc(Ap, kb, fb)

            if pid > 0:
                diag = np.arange(Ap.shape[0])
                Ap = R.aset(Ap, (diag, diag), ring.add(Ap[diag, diag], shift[None]))

            Vsub = V[: i + 1] if pid > 0 else ring.zeros((i + 1, n))
            Vsub = mpc.ss_mult_mat(Qi, Vsub)
            Vsub = mpc.trunc(Vsub, kb, fb)
            if pid > 0:
                V = R.aset(V, slice(None, i + 1), Vsub)

        Lout = R.aset(Lout, i, Ap[i, i])
        if i == 1:
            Lout = R.aset(Lout, 0, Ap[0, 0])
        Ap = Ap[:i, :i]
    return V, Lout


def swap(mpc: MPC, v1, v2, is_flip):
    """Oblivious swap (mpc/mpc.go:2515-2532)."""
    ring = mpc.ring
    d = ring.sub(v2, v1)
    m = ss_mult_vec_scalar(mpc, d, is_flip)
    return ring.add(v1, m), ring.sub(v2, m)


def sort_rows_descend(mpc: MPC, A, w):
    """Oblivious bubble sort of the rows of A by w, descending
    (mpc/mpc.go:2534-2552)."""
    ring = mpc.ring
    n = A.shape[0]
    for i in range(n - 1):
        for j in range(n - 1, i, -1):
            diff = ring.sub(w[j], w[j - 1])[None]
            is_flip = mpc.is_positive(diff, mpc.boolean_shares)[0]
            a_j, a_jm1 = swap(mpc, A[j], A[j - 1], is_flip)
            A = R.aset(R.aset(A, j, a_j), j - 1, a_jm1)
            w_j, w_jm1 = swap(mpc, w[j][None], w[j - 1][None], is_flip)
            w = R.aset(R.aset(w, j, w_j[0]), j - 1, w_jm1[0])
    return A, w


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


def _scale_rows(mpc: MPC, M, d, d_first: bool):
    """diag(d) M: row i of the shared matrix times the shared d[i].  The
    two Beaver partitions draw shared randomness, so their order is the
    reference's at each caller (d_first: d's partition before M's)."""
    if d_first:
        dr, dm = mpc.beaver_partition(d)
        mr, mm = mpc.beaver_partition(M)
    else:
        mr, mm = mpc.beaver_partition(M)
        dr, dm = mpc.beaver_partition(d)
    out = mpc.beaver_reconstruct(mpc.beaver_mult_elem(mr, mm, dr[:, None], dm[:, None]))
    return mpc.trunc(out, mpc.data_bits, mpc.frac_bits)


def matrix_inverse_sqrt_svd(mpc: MPC, A):
    """B with B^T B = (A + A^T)^{-1} (mpc/mpc.go:2864-2888)."""
    Ut, S = eigen_decomp(mpc, mpc.ring.add(A, np.swapaxes(A, 0, 1)))
    _, s_sqrt_inv = mpc.sqrt_and_sqrt_inverse(S, False)
    return _scale_rows(mpc, Ut, s_sqrt_inv, d_first=True)


def matrix_inverse_sym_pos(mpc: MPC, A):
    """(A^{-1}, A^{-1/2}) of a symmetric positive definite A
    (mpc/mpc.go:2839-2862)."""
    kb, fb = mpc.data_bits, mpc.frac_bits
    Vt, L = eigen_decomp(mpc, A)
    _, l_inv_sqrt = mpc.sqrt_and_sqrt_inverse(L, False)
    a_inv_sqrt = _scale_rows(mpc, Vt, l_inv_sqrt, d_first=False)
    a_inv = mpc.trunc(mpc.ss_mult_mat(np.swapaxes(a_inv_sqrt, 0, 1), a_inv_sqrt), kb, fb)
    return a_inv, a_inv_sqrt


def matrix_inverse_svd(mpc: MPC, A):
    """The inverse of a square invertible shared matrix through the
    eigendecomposition of its Gram matrix (MatrixInverseSVD,
    mpc/mpc.go:2795-2838): A^{-1} = (A^T A)^{-1} A^T, with (A^T A)^{-1} =
    W^T W for W = diag(1/sqrt(lambda)) V (no secure division)."""
    kb, fb = mpc.data_bits, mpc.frac_bits
    G = mpc.trunc(mpc.ss_mult_mat(np.swapaxes(A, 0, 1), A), kb, fb)
    Vt, L = eigen_decomp(mpc, G)
    _, l_inv_sqrt = mpc.sqrt_and_sqrt_inverse(L, False)
    W = _scale_rows(mpc, Vt, l_inv_sqrt, d_first=True)
    g_inv = mpc.trunc(mpc.ss_mult_mat(np.swapaxes(W, 0, 1), W), kb, fb)
    return mpc.trunc(mpc.ss_mult_mat(g_inv, np.swapaxes(A, 0, 1)), kb, fb)
