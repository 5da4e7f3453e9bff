"""Association tests (counterpart of sfgwas_tpu/gwas/assoc.py; the Go
sfgwas's gwas/assoc.go): the combined covariate basis (compute_combined_q),
the linear statistics with their standard-deviation inverse
(get_association_stats, compute_std_inv), and the logistic path: Newton
iterations on the covariates alone (lr_newton_cov_only over
compute_grad_and_inv_hessian) and the per-SNP score test (gwy_score_test).

The linear statistic of a SNP is stdinvx * stdinvy * sxy, with y~ the
phenotype projected off the covariate basis Q: one concatenated product
[Q | y~] x G per genotype block gives Q^T G and sxy; the variances go
through the SS domain for their inverse square roots.

The logistic path evaluates the sigmoid as a Chebyshev polynomial in HE
(crypto/basics.py::evaluate_chebyshev_bsgs), forms Z^T W Z in HE and
inverts it in the SS domain (mpc/linalg.py::matrix_inverse_sqrt_svd, the
dealer's only part); the score test streams one genotype block at a time.
Party 1's stages run under prof spans: lr_epoch (lr_sigmoid, lr_hess_he,
lr_inv_ss, lr_step inside), score_prep, score_block (score_encode,
score_mm, score_ss inside).
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from ..crypto import basics as B
from ..mpc import mhe, ss_he
from ..mpc.mhe import CryptoParams
from ..mpc.mpc import MPC
from ..ops import ring as R
from ..utils import prof
from ..utils.log import log
from . import filestream as fs
from . import matmult as MM
from . import utilities as U
from .qc import hub_consensus
from .qrfact import net_qr


def compute_combined_q(
    mpc: MPC,
    cps: CryptoParams,
    cov,  # local covariates [n_local, ncov] (float); at party 0 the count ncov
    Qpc: Optional[B.CipherMatrix],
    nrows_all: List[int],
    cov_all_ones: bool,
    qr_method: str = "cholqr2",
) -> Tuple[B.CipherMatrix, int]:
    """The QR of [all-ones | covariates | PCs] with the first column then
    replaced by the normalized all-ones vector (computeCombinedQV2 of the Go
    sfgwas, gwas/assoc.go:69-126).  Returns (Q, ncols); every ciphertext
    of Q sits at one (level, scale)."""
    pid = mpc.pid
    slots = cps.slots if cps else 0

    if pid > 0:
        cols = [] if cov_all_ones else [np.ones(nrows_all[pid])]
        cols += [cov[:, j] for j in range(cov.shape[1])]
        comb = [B.encrypt_float_vector(cps, c) for c in cols]
        if Qpc:
            comb = comb + list(Qpc)
        ncols = len(comb)
    else:
        ncols = int(cov) + (0 if cov_all_ones else 1) + (len(Qpc) if Qpc else 0)
        comb = [None] * ncols

    Q = net_qr(cps, mpc, comb, nrows_all, method=qr_method)

    if pid > 0:
        # the first column becomes the normalized all-ones vector
        ones = B.cadd_const(cps, B.czeros(cps, len(Q[0])), 1.0)
        nloc = nrows_all[pid]
        Q[0] = [
            B.mask_trunc(cps, ones[i], slots if i < len(Q[0]) - 1 else nloc - (len(Q[0]) - 1) * slots)
            for i in range(len(Q[0]))
        ]
        Q, _ = B.flatten_levels(cps, Q)
        # the fresh ones column rides another rescale chain than the QR
        # outputs: flatten aligns levels, not scales; the band-targeted
        # refresh is a hard scale reset, so every later product chain over
        # Q's columns adds at exactly equal scales
        qr_band = min(cps.ctx.nq, cps.rot_nmod + 2)
        Q = mhe.bootstrap_mat_all(mpc.net, cps, Q, target_nmod=qr_band)
    return Q, ncols


def get_association_stats(
    mpc: MPC,
    cps: CryptoParams,
    geno_blocks,  # the local int8 blocks (arrays or fs.LazyBlock); None at party 0
    pheno: Optional[np.ndarray],
    cov,  # local covariates [n_local, ncov]; at party 0 the count ncov
    Qpc: Optional[B.CipherMatrix],
    nrows_all: List[int],
    cov_all_ones: bool = False,
    cache_prefix: Optional[str] = None,
    use_cached_combined_q: bool = False,
    qr_method: str = "cholqr2",
    num_blocks_parallel: int = 1,
    debug: bool = False,
):
    """Linear association statistics (GetAssociationStats of the Go sfgwas,
    gwas/assoc.go:443-884).  Returns (stats CipherVector, SNP filter) at the
    data parties, (None, None) at party 0.

    With cache_prefix, the combined basis and each block's local product
    (before the aggregate) are cached as ciphertext files; they are read
    back only under a key bundle restored from a key cache
    (cps.keys_from_cache), the basis only with use_cached_combined_q and
    when every data party has it."""
    pid = mpc.pid
    slots = cps.slots if cps else 0
    tot_n = sum(nrows_all[1:])
    inv_n = 1.0 / tot_n
    sqrt_inv_n = math.sqrt(inv_n)

    # ciphertext caches decrypt only under the key bundle that wrote them
    ct_cache_ok = bool(cps and cps.keys_from_cache)
    # cache names carry the combined basis' column count, so a run with
    # another covariate basis misses
    ncov_n = cov.shape[1] if pid > 0 else int(cov)
    qexp = ncov_n + (0 if cov_all_ones else 1) + (len(Qpc) if Qpc else 0)
    qcomb_cache = f"{cache_prefix}_Qcomb.q{qexp}.npz" if cache_prefix else None
    want = bool(
        use_cached_combined_q and ct_cache_ok and qcomb_cache is not None
        and os.path.exists(qcomb_cache)
    )
    # the basis' dealer rounds involve party 0: every party takes one branch
    with prof.span("combined_q"):
        if hub_consensus(mpc, want):
            Q = U.load_cipher_matrix(cps, qcomb_cache) if pid > 0 else None
        else:
            Q, _ = compute_combined_q(
                mpc, cps, cov, Qpc, nrows_all, cov_all_ones, qr_method=qr_method
            )
            if pid > 0 and qcomb_cache:
                U.save_cipher_matrix(cps, Q, qcomb_cache)

    num_blocks = len(geno_blocks) if pid > 0 else 0
    if pid == mpc.hub_pid:
        mpc.net.send_int(num_blocks, 0)
    elif pid == 0:
        num_blocks = mpc.net.recv_int(mpc.hub_pid)

    if pid > 0:
        with prof.span("assoc_ynew"):
            # y~ = (I - Q Q^T) y
            y_pt = B.encode_float_vector(cps, pheno.reshape(-1))

            def mmplainfn(cp, a, Bm, j):
                return B.cpmult(cp, a, Bm[j])

            ynew = MM.dc_matmul_aat_b(cps, mpc, Q, [y_pt], nrows_all, 1, mmplainfn)
            ynew0 = B.cmult_const(cps, ynew[0], inv_n, rescale=True)
            # refreshed two primes below the top, where the refresh resets
            # the scale exactly: the cpadd below adds y at exactly the
            # projection's scale
            ynew0 = mhe.bootstrap_mat_all(mpc.net, cps, [ynew0], target_nmod=cps.ctx.nq - 2)[0]
            ynew0 = [cps.ctx.mul_const_int(ct, -1) for ct in ynew0]
            ynew0 = B.cpadd(cps, ynew0, y_pt)
        if debug and cache_prefix:
            # y~ is row-partitioned: each party's slice
            for p in range(1, mpc.net.nparty):
                U.save_matrix_collective(
                    mpc.net, cps, [ynew0], nrows_all[p], p,
                    f"{cache_prefix}_dbg_ynew.party{p}.txt",
                )

        # [Q | y~]: Q's first column is the normalized all-ones vector, so
        # sx = sy = 0
        concat = list(Q) + [ynew0]

        # one prefetch thread loads and encodes (host only, no draws) up to
        # num_blocks_parallel blocks ahead while the card multiplies; cache
        # hits are known up front and never prefetched
        nb = len(geno_blocks)
        nahead = max(1, int(num_blocks_parallel))
        cache_files = [
            f"{cache_prefix}_assoc_q{qexp}_{b}.npz" if cache_prefix else None for b in range(nb)
        ]
        hit = [cf is not None and ct_cache_ok and os.path.exists(cf) for cf in cache_files]

        def host_prep(b):
            G = fs.load_block(geno_blocks[b])
            pre = MM.preprocess_matrix_host(cps, G)
            dsum = G.astype(np.float64).sum(axis=0)
            dsq = (G.astype(np.float64) ** 2).sum(axis=0)
            return pre, dsum, dsq, G.shape[1]

        pool = ThreadPoolExecutor(1, thread_name_prefix="assoc-prefetch")
        futures = {}
        next_pf = 0

        def schedule(depth):
            nonlocal next_pf
            while len(futures) < depth and next_pf < nb:
                if not hit[next_pf]:
                    futures[next_pf] = pool.submit(host_prep, next_pf)
                next_pf += 1

        schedule(nahead)
        p_ = cps.ctx.basis.primes
        sxx_blocks, sxy_blocks, filters = [], [], []
        for b, blk in enumerate(geno_blocks):
            log(f"pid{pid} assoc block {b + 1}/{nb}")
            with prof.span("assoc_block"):
                cache_file = cache_files[b]
                if hit[b]:
                    # a hit replaces only local compute: the aggregate,
                    # bootstrap and encrypt pattern below is the same
                    with np.load(cache_file) as z:
                        dsum, dsq = z["dsum"], z["dsq"]
                    out = U.load_cipher_matrix(cps, cache_file)
                    msnp = blk.shape[1]
                else:
                    with prof.span("assoc_encode_wait"):
                        pre, dsum, dsq, msnp = futures.pop(b).result()
                    schedule(nahead)
                    with prof.span("assoc_mm"):
                        out, _, _ = MM.mat_mult_stream(cps, concat, None, host_pre=pre)
                    del pre
                    if cache_file:
                        U.save_cipher_matrix(cps, out, cache_file,
                                             extra={"dsum": dsum, "dsq": dsq})
                with prof.span("assoc_agg_bs"):
                    out = mhe.aggregate_cmat(mpc.net, cps, out)
                    out = mhe.bootstrap_mat(mpc.net, cps, out, -1)

            with prof.span("assoc_sxx"):
                nq_cols = len(Q)
                # Q^T G / sqrt(n) without the all-ones column, whose part
                # the dosage sums carry
                Bmat = [
                    B.cmult_const(cps, out[i + 1], sqrt_inv_n, rescale=True)
                    for i in range(nq_cols - 1)
                ]
                sxy_blocks.append(out[nq_cols])

                sx2 = mhe.aggregate_cvec(mpc.net, cps, B.encrypt_float_vector(cps, dsum))
                sx2 = B.cmult_const(cps, sx2, sqrt_inv_n, rescale=True)
                # dsq is encoded at exactly the squared terms' scale (s^2 over
                # the top prime pair): every party derives the same s_tt, so
                # the subtractions and the aggregate add at equal scales
                terms = Bmat + [sx2]

                def _sq_scale(t):
                    return t.scale * t.scale / p_[t.nmod - 1] / p_[t.nmod - 2]

                s_tt = _sq_scale(terms[0][0])
                sxx = B.encrypt_float_vector(cps, dsq, scale=s_tt)
                if pid == mpc.hub_pid:
                    for term_vec in terms:
                        tt = B.cmult(cps, term_vec, term_vec)
                        if abs(tt[0].scale / s_tt - 1) > 1e-9:
                            # an off-chain term: exact retarget to s_tt
                            tt = [B.mask_trunc(cps, t, cps.slots, target_scale=s_tt) for t in tt]
                        nm = min(sxx[0].nmod, tt[0].nmod)
                        sxx = [
                            cps.ctx.sub(cps.ctx.drop_to(a_, nm), cps.ctx.drop_to(b_, nm))
                            for a_, b_ in zip(sxx, tt)
                        ]
                sxx = mhe.aggregate_cvec(mpc.net, cps, sxx)
                sxx_blocks.append(sxx)

            nct = 1 + (msnp - 1) // slots
            fl = np.zeros(nct * slots, dtype=bool)
            fl[:msnp] = True
            filters.append(fl)
        pool.shutdown(wait=False)

        sxy = [ct for blk in sxy_blocks for ct in blk]
        varx = [ct for blk in sxx_blocks for ct in blk]
        out_filter = np.concatenate(filters)
        nsnps = int(out_filter.sum())
        num_ctx = len(varx)
        if pid == mpc.hub_pid:
            mpc.net.send_int(num_ctx, 0)
            mpc.net.send_int(nsnps, 0)

        if debug and cache_prefix:
            # aggregated quantities: the same at every data party
            U.save_matrix_collective(mpc.net, cps, [sxy], nsnps, -1,
                                     f"{cache_prefix}_dbg_sxy.txt")
            U.save_matrix_collective(mpc.net, cps, [varx], nsnps, -1,
                                     f"{cache_prefix}_dbg_varx.txt")

        with prof.span("assoc_syy"):
            # vary = syy (sy = 0 with the all-ones column in Q)
            ysq = B.cmult(cps, ynew0, ynew0)
            syy = mhe.aggregate_ct(mpc.net, cps, B.inner_sum_all(cps, ysq))
            vary = mhe.collective_bootstrap(mpc.net, cps, syy, -1)
    else:
        num_ctx = mpc.net.recv_int(mpc.hub_pid)
        nsnps = mpc.net.recv_int(mpc.hub_pid)
        varx = [None] * num_ctx
        vary = None
        sxy = None
        out_filter = None

    mpc.assert_sync()
    with prof.span("std_inv"):
        stdinvx, stdinvy = compute_std_inv(mpc, cps, varx, vary, nsnps, out_filter)

    if pid > 0:
        if debug and cache_prefix:
            U.save_matrix_collective(mpc.net, cps, [stdinvx], nsnps, -1,
                                     f"{cache_prefix}_dbg_stdinvx.txt")
        stats = B.cmult(cps, sxy, stdinvx)
        stats = B.cmult_scalar(cps, stats, stdinvy)
        return stats, out_filter
    return None, None


def compute_std_inv(mpc: MPC, cps: CryptoParams, varx, vary, nsnps: int, filt):
    """varx, vary -> their inverse square roots through the SS domain
    (computeStdInv of the Go sfgwas, gwas/assoc.go:887-953): the kept
    SNPs' variances and the phenotype's go through one
    sqrt_and_sqrt_inverse; returns (stdinvx CipherVector, stdinvy
    ciphertext with every slot holding the value) at the data parties."""
    ring = mpc.ring
    pid = mpc.pid
    slots = cps.slots if cps else 1
    varx_ss = ss_he.cvec_to_ss(mpc, cps, varx, -1, slots * len(varx))
    vary_ss = ss_he.ciphertext_to_ss(mpc, cps, vary, -1, 1)

    n_all = varx_ss.shape[0]
    var_ss = ring.zeros((nsnps + 1,))
    if pid > 0:
        idx = np.where(filt)[0][:nsnps]
        var_ss = R.aset(var_ss, slice(None, nsnps), np.asarray(varx_ss)[idx])
    var_ss = R.aset(var_ss, nsnps, np.asarray(vary_ss)[0])

    stdinv_ss = mpc.sqrt_and_sqrt_inverse(var_ss)[1]

    stdinvx_ss = ring.zeros((n_all,))
    if pid > 0:
        stdinvx_ss = R.aset(stdinvx_ss, idx, np.asarray(stdinv_ss)[:nsnps])

    stdinvx_cv = ss_he.ss_to_cmat(mpc, cps, stdinvx_ss[None])
    stdinvy_ct = ss_he.ss_to_ciphertext(mpc, cps, stdinv_ss[nsnps : nsnps + 1][None])
    if pid > 0:
        stdinvy_ct = B.rotate_and_add(cps, stdinvy_ct, cps.slots)
        return stdinvx_cv[0], stdinvy_ct
    return None, None


# ---------------------------------------------------------------------------
# Logistic regression (the Go sfgwas's gwas/assoc.go:955-1476)


def _sigmoid_coeffs(a: float, b: float, degree: int):
    return B.chebyshev_coeffs(lambda x: 1.0 / (1.0 + math.exp(-x)), a, b, degree)


def _sub_low(ctx, X, Y):
    """X - Y, ciphertext by ciphertext, at the lower level of the two."""
    nm = min(X[0].nmod, Y[0].nmod)
    return [ctx.sub(ctx.drop_to(a, nm), ctx.drop_to(b, nm)) for a, b in zip(X, Y)]


def _inverse_ss(mpc: MPC, cps: CryptoParams, ztwz, ncov: int):
    """Z^T W Z (ncov row-packed ciphertexts; None at the dealer) -> B^T as
    row-packed ciphertexts with B^T B = (Z^T W Z + (Z^T W Z)^T)^{-1}, through
    the SS domain; the dealer's whole part of a Newton step."""
    from ..mpc import linalg

    with prof.span("lr_inv_ss"):
        ztwz_ss = ss_he.cmat_to_ss(mpc, cps, ztwz, -1, ncov)
        b_ss = linalg.matrix_inverse_sqrt_svd(mpc, ztwz_ss)
        return ss_he.ss_to_cmat(mpc, cps, np.swapaxes(np.asarray(b_ss), 0, 1))


def compute_grad_and_inv_hessian(
    mpc: MPC,
    cps: CryptoParams,
    Cm,
    C_scaled_up,
    y: np.ndarray,
    weights,
    approx,
    nrows_all: List[int],
    skip_intercept: bool,
    compute_grad: bool,
    inverse_mat_scale: float,
):
    """One Newton step's ingredients (gwas/assoc.go:992-1171): returns
    (grad, ZTwZInv, BT, Wz, y~, w) at the data parties.  At party 0 pass the
    covariate count as Cm: the dealer takes part only in the SS inversion
    of the Hessian and returns Nones."""
    ctx = cps.ctx
    tot_n = sum(nrows_all[1:])
    if mpc.pid == 0:
        ncov = int(Cm)
        _inverse_ss(mpc, cps, [None] * ncov, ncov)
        return None, None, None, None, None, None
    n_local = len(y)
    ncov = len(Cm)

    with prof.span("lr_sigmoid"):
        # p = sigmoid(C w)
        if skip_intercept:
            cov_intercept = B.encrypt_float_vector(cps, np.zeros(n_local))
        else:
            cov_intercept = MM.cmult_mat_col_times_col_to_col(cps, Cm, weights, len(Cm[0]))
        a_lo, b_hi, degree = approx
        coeffs = _sigmoid_coeffs(a_lo, b_hi, degree)

        def _refresh_local(net, cps_, ct, _src):
            # the operand is party-local (each party's own rows): a refresh
            # inside the recurrence takes per-source turns
            return mhe.bootstrap_mat_all(net, cps_, [[ct]])[0][0]

        p_hat = B.evaluate_chebyshev_bsgs(
            mpc.net, cps, cov_intercept, coeffs, a_lo, b_hi, _refresh_local
        )
        # refreshed two primes below the top, where the refresh resets the
        # scale exactly: y adds at exactly p's scale (as the linear y~)
        p_hat = mhe.bootstrap_mat_all(mpc.net, cps, [p_hat], target_nmod=ctx.nq - 2)[0]
        y_pt = B.encode_float_vector(cps, y)
        y_tilde = B.cpadd(cps, [ctx.mul_const_int(ct, -1) for ct in p_hat], y_pt)

    with prof.span("lr_hess_he"):
        grad = None
        if compute_grad:
            grad = MM.cmult_mat_inner_prod_vector(cps, Cm, y_tilde)
            grad = mhe.aggregate_cvec(mpc.net, cps, grad)

        # w = p (1 - p)
        w_vec = _sub_low(ctx, p_hat, B.cmult(cps, p_hat, p_hat))
        w_vec = mhe.bootstrap_mat_all(mpc.net, cps, [w_vec])[0]

        # Wz = w o C_scaled_up; its consumers (Z^T W Z here, Wz B^T and
        # Wz (Z^T W Z)^{-1} in the score test) each need 2 more levels
        Wz = [B.cmult(cps, w_vec, C_scaled_up[i]) for i in range(ncov)]
        Wz = mhe.bootstrap_mat_all(mpc.net, cps, Wz)

        ZTwZ = MM.cmult_mat_inner_prod(cps, Cm, Wz)
        ZTwZ = mhe.aggregate_cmat(mpc.net, cps, ZTwZ)
        ZTwZ = mhe.bootstrap_mat(mpc.net, cps, ZTwZ, -1)
        ZTwZ = [
            B.cmult_const(cps, row, 1.0 / (tot_n / inverse_mat_scale), rescale=True)
            for row in ZTwZ
        ]

    bt_cm = _inverse_ss(mpc, cps, ZTwZ, ncov)
    with prof.span("lr_step"):
        scale_back = math.sqrt((inverse_mat_scale * 2) / math.sqrt(tot_n))
        BT = [B.cmult_const(cps, row, scale_back, rescale=True) for row in bt_cm]
        ZTwZInv = MM.cmult_mat_inner_prod(cps, BT, list(BT))
        # ZTwZInv lands at the base level: refreshed (the same at every data
        # party) for the Newton step's and the score test's products
        ZTwZInv = mhe.bootstrap_mat(mpc.net, cps, ZTwZInv, -1)
    return grad, ZTwZInv, BT, Wz, y_tilde, w_vec


def lr_newton_cov_only(mpc: MPC, cps: CryptoParams, Cm, y, epochs: int, nrows_all: List[int],
                       approx, inverse_mat_scale: float):
    """Newton iterations on the covariates alone (LrNewtonBasedCovOnly,
    gwas/assoc.go:955-990) from zero weights, the first epoch without the
    intercept term.  Cm is the combined basis scaled by 1/sqrt(n); at party
    0 pass the covariate count.  Returns the packed weights (None at 0)."""
    tot_n = sum(nrows_all[1:])
    if mpc.pid == 0:
        for i in range(epochs):
            compute_grad_and_inv_hessian(mpc, cps, Cm, None, np.zeros(0), None, approx,
                                         nrows_all, i == 0, True, inverse_mat_scale)
        return None
    C_scaled = B.cmult_const_mat(cps, Cm, math.sqrt(tot_n), rescale=True)
    weights = B.encrypt_float_vector(cps, np.zeros(cps.slots))
    for i in range(epochs):
        log(f"pid{mpc.pid} logistic epoch {i + 1}/{epochs}")
        with prof.span("lr_epoch"):
            grad, inv_hess, _, _, _, _ = compute_grad_and_inv_hessian(
                mpc, cps, Cm, C_scaled, y, weights, approx, nrows_all, i == 0, True,
                inverse_mat_scale,
            )
            with prof.span("lr_step"):
                grad = mhe.bootstrap_mat(mpc.net, cps, [grad], -1)[0]
                step = MM.cmult_mat_col_times_col_to_col(cps, inv_hess, grad, len(weights))
                weights = MM.add_vec_low(cps, weights, step[: len(weights)])
                weights = mhe.bootstrap_mat_all(mpc.net, cps, [weights])[0]
    return weights


def gwy_score_test(mpc: MPC, cps: CryptoParams, Cm, geno_blocks, y, weights, approx,
                   nrows_all: List[int], inverse_mat_scale: float):
    """The per-SNP logistic score test (gWY, gwas/assoc.go:1174-1476):
    t = g~^T y~ / sqrt(g^T W g - correction), one genotype block resident
    at a time.  Returns (statistics CipherVector, SNP filter) at the data
    parties, (None, None) at party 0 (pass the covariate count as Cm)."""
    ctx = cps.ctx
    slots = cps.slots if cps else 1
    tot_n = sum(nrows_all[1:])
    pid = mpc.pid

    with prof.span("score_prep"):
        if pid > 0:
            C_scaled = B.cmult_const_mat(cps, Cm, math.sqrt(tot_n), rescale=True)
            _, ZTwZInv, BT, Wz, y_tilde, w_vec = compute_grad_and_inv_hessian(
                mpc, cps, Cm, C_scaled, y, weights, approx, nrows_all, False, False,
                inverse_mat_scale,
            )
            ncov = len(Cm)
            WzZTwZInv = MM.cmult_mat_col_times_row_to_col(cps, Wz, ZTwZInv, ncov)
            WzZTwZInv = mhe.bootstrap_mat_all(mpc.net, cps, WzZTwZInv)
            WzBT = MM.cmult_mat_col_times_row_to_col(cps, Wz, BT, ncov)
            WzBT = mhe.bootstrap_mat_all(mpc.net, cps, WzBT)

            # o = Wz (Z^T W Z)^{-1} Z^T y~
            y_tilde = mhe.bootstrap_mat_all(mpc.net, cps, [y_tilde])[0]
            ZTy = MM.cmult_mat_inner_prod_vector(cps, C_scaled, y_tilde)
            ZTy = mhe.aggregate_cvec(mpc.net, cps, ZTy)
            ZTy = mhe.bootstrap_mat(mpc.net, cps, [ZTy], -1)[0]
            o_vec = MM.cmult_mat_col_times_col_to_col(cps, WzZTwZInv, ZTy, len(Wz[0]))
            o_vec = B.cmult_const(cps, o_vec, 1.0 / tot_n, rescale=True)
            o_vec = mhe.bootstrap_mat_all(mpc.net, cps, [o_vec])[0]
        else:
            compute_grad_and_inv_hessian(mpc, cps, Cm, None, np.zeros(0), None, approx,
                                         nrows_all, False, False, inverse_mat_scale)

    results, out_filt = [], []
    nblocks = len(geno_blocks) if pid > 0 else mpc.net.recv_int(mpc.hub_pid)
    if pid == mpc.hub_pid:
        mpc.net.send_int(nblocks, 0)
    for blk in range(nblocks):
        with prof.span("score_block"):
            if pid > 0:
                log(f"pid{pid} score test block {blk + 1}/{nblocks}")
                with prof.span("score_encode"):
                    G = fs.load_block(geno_blocks[blk])
                    msnp = G.shape[1]
                    nsnp_ct = 1 + (msnp - 1) // slots
                    if pid == mpc.hub_pid:
                        mpc.net.send_int(msnp, 0)
                    # one diagonal encoding serves the three unsquared
                    # products of the block (g^T WzBT, g^T y~, g^T o)
                    g_cache = MM.preprocess_matrix(cps, G, MM.mm_nmod(cps))
                with prof.span("score_mm"):
                    # the b part: (g^T W z B^T)^2 summed over the covariates
                    ztwbt_g = MM.mat_mult_cached(cps, WzBT, g_cache)
                    ztwbt_g = mhe.aggregate_cmat(mpc.net, cps, ztwbt_g)
                    ztwbt_g = mhe.bootstrap_mat(mpc.net, cps, ztwbt_g, -1)
                    gTW2g = None
                    for row in ztwbt_g:
                        gTW2g = MM.add_vec_low(cps, gTW2g, B.cmult(cps, row, row))
                    gTW2g = B.cmult_const(cps, gTW2g, 1.0 / tot_n, rescale=True)

                    # the x part: g^T W g over the squared genotypes
                    gTWg, _, _ = MM.mat_mult_stream(cps, [w_vec], G, square=True)
                    gTWg = mhe.aggregate_cmat(mpc.net, cps, gTWg)
                    denom = _sub_low(ctx, gTWg[0], gTW2g)
                    denom = mhe.bootstrap_mat(mpc.net, cps, [denom], -1)[0]

                    # the numerator: g^T y~ - g^T o
                    gTy = MM.mat_mult_cached(cps, [y_tilde], g_cache)
                    gTo = MM.mat_mult_cached(cps, [o_vec], g_cache)
                    MM.release_plan(g_cache)
                    del g_cache, G
                    numer = _sub_low(ctx, gTy[0], gTo[0])
                    numer = mhe.aggregate_cvec(mpc.net, cps, numer)
                    numer = mhe.bootstrap_mat(mpc.net, cps, [numer], -1)[0]
            else:
                msnp = mpc.net.recv_int(mpc.hub_pid)
                nsnp_ct = 1 + (msnp - 1) // slots
                denom = [None] * nsnp_ct
                numer = [None] * nsnp_ct

            with prof.span("score_ss"):
                numer_ss = ss_he.cvec_to_ss(mpc, cps, numer, -1, slots * nsnp_ct)
                denom_ss = ss_he.cvec_to_ss(mpc, cps, denom, -1, slots * nsnp_ct)
                _, inv_sqrt = mpc.sqrt_and_sqrt_inverse(denom_ss, True)
                t_stat = mpc.trunc(mpc.ss_mult_elem(numer_ss, inv_sqrt))
                out = ss_he.ss_to_cmat(mpc, cps, t_stat[None])
            if pid > 0:
                results.extend(out[0])
                fl = np.zeros(nsnp_ct * slots, bool)
                fl[:msnp] = True
                out_filt.append(fl)
    if pid > 0:
        return results, np.concatenate(out_filt)
    return None, None
