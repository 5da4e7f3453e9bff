"""Phase 2: distributed PCA, a randomised sketch refined by power iteration
(counterpart of sfgwas_tpu/gwas/pca.py; the Go sfgwas's gwas/pca.go:49-495):

* the count-sketch of each party's individuals into kp buckets with random
  signs, drawn from the party's private PRG, aggregated across parties in
  HE;
* the mean, variance and inverse std of each SNP in secret shares, with
  the near-zero variance guard, converted to HE;
* the lazily normalised power iterations Q <- QR(Q X^T X) through the BSGS
  matmult caches of X and X^T (device-resident, or host-streamed when
  their encoded diagonals would exceed the device budget), with the same
  1/sqrt(n) and 1/sqrt(m) rescalings;
* the Gram matrix Q Q^T from encrypted inner products, its
  eigendecomposition and the oblivious sort in secret shares, and the PC
  subspace V Q.

Stages run under prof spans named pca_*; a power iteration's spans carry
its index (pca_iter<it>_qxt, _agg, _bootstrap, _qx, _qr).
"""

from __future__ import annotations

import math
import os
from typing import List, Optional

import numpy as np

from ..crypto import basics as B
from ..mpc import linalg, mhe, ss_he
from ..mpc.mhe import CryptoParams
from ..mpc.mpc import MPC
from ..ops import ring as R
from ..utils import prof
from ..utils.log import log
from . import matmult as MM
from . import utilities as U
from .qrfact import net_qr

# both diagonal caches stay on the device while their encoded polys fit
# this many bytes; above it they stay on the host and stream (PN14 at
# example scale: ~10k LD-pruned SNPs need ~10 GB)
DEVICE_CACHE_BYTES = 6 << 30


def device_cache_bytes(cps: CryptoParams, n_rows: int, n_cols: int) -> int:
    """Bytes of the device-resident diagonal cache of an n_rows x n_cols
    matrix at the matmult band."""
    S = cps.slots
    nmod = MM.mm_nmod(cps)
    tot = 0
    for bi in range(0, n_rows, S):
        r = min(S, n_rows - bi)
        for bj in range(0, n_cols, S):
            c = min(S, n_cols - bj)
            tot += min(r + (c - 1 if c > 1 else 0), S) * nmod * cps.ctx.n * 4
    return tot


def gram_scale(mpc: MPC, n: int, m: int, kp: int) -> float:
    """The public power of two c by which the Gram matrix Z = Q Q^T / n
    enters the eigensolver, as Z / c.

    The SS eigensolver computes in fixed point, |value| < 2^(data_bits -
    frac_bits - 1), and a Householder step squares and sums a row of the
    shifted matrix: 16 kp lambda^2 must stay below that.  The largest
    eigenvalue of Z is at most sigma_1^4 / (n m) <= n m (Q Q^T = n I after
    the QR, sigma_1 of the standardised n x m genotypes, whose squared
    Frobenius norm is n m).  At the example's n = 2000, m = 10,000 the top
    eigenvalue is ~1.8e4 and the unscaled solve overflows (the JAX package
    runs it unscaled); scaling by a positive constant changes neither the
    eigenvectors nor their order.  c = 1 while n m is within range, so small
    studies run exactly as the JAX package does."""
    safe = math.sqrt(2.0 ** (mpc.data_bits - mpc.frac_bits - 1) / (16 * kp))
    c = 1.0
    while n * m / c > safe:
        c *= 2
    return c


def _resume_agreed(mpc: MPC, have_dump: bool) -> bool:
    """Whether every party resumes from the power-iteration dumps: only
    when every data party has its own.  The dealer never has one (the
    decrypted dumps are written at the data parties), so each data party
    sends the hub its answer and the hub sends every other party the
    verdict; the JAX package lets each party decide alone, and its dealer
    then runs the fresh path while the data parties resume."""
    net, hub = mpc.net, mpc.hub_pid
    if mpc.pid == hub:
        ok = have_dump
        for p in range(1, mpc.nparty):
            if p != hub:
                ok = bool(net.recv_int(p)) and ok
        for p in range(mpc.nparty):
            if p != hub:
                net.send_int(int(ok), p)
        return ok
    if mpc.pid > 0:
        net.send_int(int(have_dump), hub)
    return bool(net.recv_int(hub))


def distributed_pca(
    mpc: MPC,
    cps: CryptoParams,
    X: Optional[np.ndarray],  # local individuals x PCA SNPs (int8); None at pid 0
    nsnp: int,
    nrows_all: List[int],
    npc: int,
    num_oversample: int,
    num_power_iters: int,
    cache_prefix: Optional[str] = None,
    restart_iter: int = 0,
    skip_power_iter: bool = False,
    debug: bool = False,
    iter_per_eigenval: int = 5,
    qr_method: str = "cholqr2",
    device_budget: int = DEVICE_CACHE_BYTES,
    group_bytes: int = MM.STREAM_GROUP_BYTES,
    disk_cache: bool = False,
) -> B.CipherMatrix:
    """The top npc principal components of the pooled, standardised X as
    an npc-row CipherMatrix over each data party's individuals ([None] *
    npc at the dealer).  device_budget is the bytes of encoded diagonals
    the two caches may hold on the device together; group_bytes bounds a
    streamed MAC launch; disk_cache writes a device-resident cache to
    cache_prefix_x.npz / _xt.npz.  restart_iter / skip_power_iter resume
    from the decrypted QmulB_<it>.txt dumps that debug writes."""
    ring = mpc.ring
    pid = mpc.pid
    fb, kb = mpc.frac_bits, mpc.data_bits
    slots = cps.slots if cps else 0
    kp = npc + num_oversample
    tot_ind = sum(nrows_all[1:])
    nind = X.shape[0] if X is not None else 0
    inv_sqrt_m = 1.0 / math.sqrt(nsnp)
    inv_sqrt_n = 1.0 / math.sqrt(tot_ind)

    # the diagonal caches of X (ind x snp) and X^T (snp x ind)
    x_cache = xt_cache = None
    if pid > 0:
        with prof.span("pca_encode"):
            need = 2 * device_cache_bytes(cps, X.shape[0], X.shape[1])
            host_res = need > device_budget
            if host_res:
                log(f"pid{pid} pca: diag caches host-streamed ({need / 1e9:.1f} GB of "
                    f"device polys > {device_budget / 1e9:.1f} GB budget)")
            x_cache = MM.preprocess_matrix(
                cps, X, cache_file=f"{cache_prefix}_x.npz" if cache_prefix else None,
                host_resident=host_res, disk_cache=disk_cache,
            )
            xt_cache = MM.preprocess_matrix(
                cps, np.ascontiguousarray(X.T),
                cache_file=f"{cache_prefix}_xt.npz" if cache_prefix else None,
                host_resident=host_res, disk_cache=disk_cache,
            )

    # ---- the sketch and the first and second moments (gwas/pca.go:122-191)
    Q = None
    bucket_count = np.zeros(kp, dtype=np.int64)
    xsum = np.zeros(nsnp, dtype=np.int64)
    x2sum = np.zeros(nsnp, dtype=np.int64)
    if pid > 0:
        with prof.span("pca_sketch"):
            g = mpc.rand.table[mpc.pid]  # the local (private) PRG, gwas/pca.go:130
            bucket = g.integers(0, kp, size=nind)
            sgn = g.integers(0, 2, size=nind) * 2 - 1
            pos_count = np.zeros(kp, dtype=np.int64)
            local_sketch = np.zeros((kp, nsnp))
            Xf = X.astype(np.float64)
            for b in range(kp):
                sel = bucket == b
                bucket_count[b] = sel.sum()
                pos_count[b] = (sgn[sel] > 0).sum()
                if sel.any():
                    local_sketch[b] = (sgn[sel][:, None] * Xf[sel]).sum(axis=0)
            xsum = X.astype(np.int64).sum(axis=0)
            x2sum = (X.astype(np.int64) ** 2).sum(axis=0)

            Qloc = B.encrypt_float_matrix(cps, local_sketch)
            Q = mhe.aggregate_cmat(mpc.net, cps, Qloc)
            bucket_count = mhe.aggregate_int_vec(mpc.net, bucket_count)
            pos_count = mhe.aggregate_int_vec(mpc.net, pos_count)

    # mean / var / stdinv in SS (the local sums are shares)
    with prof.span("pca_moments"):
        inv_n = 1.0 / tot_ind
        if pid > 0:
            sx = ring.from_i32(np.asarray(xsum, np.int32))
            sx2_counts = ring.from_i32(np.asarray(x2sum, np.int32))
            scale_c = ring.const_np(int(round(inv_n * (1 << (2 * fb)))))
            sx = ring.mul(sx, np.broadcast_to(scale_c, sx.shape))
            sx2 = ring.mul(sx2_counts, np.broadcast_to(scale_c, sx2_counts.shape))
        else:
            sx = ring.zeros((nsnp,))
            sx2 = ring.zeros((nsnp,))

        x_mean_ss = mpc.trunc(sx, kb, fb)
        x_mean_sq = mpc.ss_square_elem(x_mean_ss)
        sx2 = ring.sub(sx2, x_mean_sq)
        x_var_ss = mpc.trunc(sx2, kb, fb)

        # near-zero variance -> 1.0 (gwas/pca.go:213-216)
        zero_thres = ring.const_np(max(1, int(round(1e-8 * (1 << fb)))))
        zero_filt = mpc.flip_bit(mpc.not_less_than_public(x_var_ss, zero_thres))
        one_fb = ring.const_np(1 << fb)
        x_var_ss = ring.add(
            x_var_ss, ring.mul(zero_filt, np.broadcast_to(one_fb, zero_filt.shape))
        )

        _, x_stdinv_ss = mpc.sqrt_and_sqrt_inverse(x_var_ss)

        padded = slots * (1 + (nsnp - 1) // slots) if pid > 0 else nsnp
        stats = ring.zeros((3, padded))
        if pid > 0:
            stats = R.aset(stats, (0, slice(None, nsnp)), x_stdinv_ss)
            stats = R.aset(stats, (1, slice(None, nsnp)), x_mean_ss)
            stats = R.aset(stats, (2, slice(None, nsnp)), x_var_ss)
        out_cm = ss_he.ss_to_cmat(mpc, cps, stats)
        x_stdinv = x_mean = None
        if pid > 0:
            x_stdinv, x_mean = out_cm[0], out_cm[1]

    # ---- the initial Q scaling (gwas/pca.go:248-284)
    if pid > 0:
        with prof.span("pca_qscale"):
            ctx = cps.ctx
            for b in range(kp):
                inv_cnt = 1.0 / math.sqrt(max(bucket_count[b], 1))
                mean_weight = int(2 * pos_count[b] - bucket_count[b])
                mw = B.cmult_const(cps, x_mean, -float(mean_weight), rescale=True)
                Q[b] = [
                    ctx.add(ctx.drop_to(q, min(q.nmod, m.nmod)), ctx.drop_to(m, min(q.nmod, m.nmod)))
                    for q, m in zip(Q[b], mw)
                ]
                Q[b] = B.cmult_const(cps, Q[b], inv_cnt, rescale=True)
                Q[b] = B.cmult(cps, Q[b], x_stdinv)
            Q = mhe.bootstrap_mat(mpc.net, cps, Q, -1)

    # restart_pca_from_iter / skip_power_iter (gwas/pca.go:244-331, 382-394):
    # the per-iteration decrypted dumps are the resume artifacts (the Go
    # sfgwas's QmulB_%d.txt, written only with debug)
    def _iter_cache(it):
        return f"{cache_prefix}_QmulB_{it}.txt" if cache_prefix else None

    it_start = 0
    if skip_power_iter or restart_iter > 0:
        it = num_power_iters - 1 if skip_power_iter else restart_iter
        f = _iter_cache(it)
        if _resume_agreed(mpc, bool(f) and os.path.exists(f)):
            if pid > 0:
                mat = U.load_matrix_float(f)
                Qloc = [B.encrypt_float_vector(cps, row) for row in mat]
            else:
                Qloc = [None] * kp
            if it == num_power_iters - 1:
                Q = Qloc
            else:
                with prof.span("pca_restart_qr"):
                    Q = net_qr(cps, mpc, Qloc, nrows_all, method=qr_method)
            it_start = it + 1
        else:
            restart_iter = 0

    if it_start == 0:
        # the initial projection to individual space, then a QR
        with prof.span("pca_init_qx"):
            if pid > 0:
                Qloc = MM.qx_lazy_norm_stream(cps, mpc, Q, xt_cache, x_mean, x_stdinv, nind,
                                              post_scale=inv_sqrt_m, group_bytes=group_bytes)
            else:
                Qloc = [None] * kp
        with prof.span("pca_init_qr"):
            Q = net_qr(cps, mpc, Qloc, nrows_all, method=qr_method)

    # ---- the power iterations (gwas/pca.go:339-371)
    for it in range(it_start, num_power_iters):
        # lockstep barrier (gwas/pca.go:121 AssertSync): the dealer's part
        # of an iteration only sends, so without it the dealer races ahead
        mpc.assert_sync()
        log(f"pid{pid} PCA power iter {it + 1}/{num_power_iters}")
        tag = f"pca_iter{it}"
        if pid > 0:
            with prof.span(f"{tag}_qxt"):
                Qs = MM.qxt_lazy_norm_stream(cps, mpc, Q, x_cache, x_mean, x_stdinv,
                                             post_scale=inv_sqrt_n, group_bytes=group_bytes)
            with prof.span(f"{tag}_agg"):
                Qsnp = mhe.aggregate_cmat(mpc.net, cps, Qs)
            with prof.span(f"{tag}_bootstrap"):
                Qsnp = mhe.bootstrap_mat(mpc.net, cps, Qsnp, -1)
            with prof.span(f"{tag}_qx"):
                Qloc = MM.qx_lazy_norm_stream(cps, mpc, Qsnp, xt_cache, x_mean, x_stdinv, nind,
                                              post_scale=inv_sqrt_m, group_bytes=group_bytes)
        else:
            Qloc = [None] * kp
        if debug and pid > 0 and cache_prefix:
            for p in range(1, mpc.nparty):
                U.save_matrix_collective(mpc.net, cps, Qloc, nrows_all[p], p, _iter_cache(it))
        if it == num_power_iters - 1:
            Q = Qloc
        else:
            with prof.span(f"{tag}_qr"):
                Q = net_qr(cps, mpc, Qloc, nrows_all, method=qr_method)

    # ---- the Gram matrix Z = Q Q^T (gwas/pca.go:399-442)
    with prof.span("pca_gram"):
        if pid > 0:
            ctx = cps.ctx
            nct = ((kp * kp) - 1) // slots + 1
            # one batched relin-mult for all kp(kp+1)/2 pairs, one shared
            # rotation ladder and one mask-scatter per packed output
            gpairs = [(i, j) for i in range(kp) for j in range(i, kp)]
            prods = None
            for t in range(len(Q[0])):
                row = B.cmult_pairs(cps, [Q[i][t] for (i, j) in gpairs],
                                    [Q[j][t] for (i, j) in gpairs])
                prods = row if prods is None else [ctx.add(a, b) for a, b in zip(prods, row)]
            sums = B.rotate_and_add_many(cps, prods, slots)
            slot_lists = [[i * kp + j] if i == j else [i * kp + j, j * kp + i]
                          for (i, j) in gpairs]
            zloc = B.mask_scatter_sum(cps, sums, slot_lists, nct,
                                      value=inv_n / gram_scale(mpc, tot_ind, nsnp, kp),
                                      cache_key=("pca_gram", kp))
            z = mhe.aggregate_cvec(mpc.net, cps, zloc)
            z = mhe.bootstrap_vec(mpc.net, cps, z, -1)
        else:
            z = None
        zss = ss_he.cvec_to_ss(mpc, cps, z, -1, kp * kp)
        zmat = zss.reshape(kp, kp, ring.nlimb)

    # ---- the eigendecomposition in SS (gwas/pca.go:444-461)
    with prof.span("pca_eigen"):
        V, L = linalg.eigen_decomp(mpc, zmat, iter_per_eval=iter_per_eigenval)
    with prof.span("pca_sort"):
        V, L = linalg.sort_rows_descend(mpc, V, L)
    V = V[:npc]

    # ---- the PC subspace: Qpc[r] = sum_c V[r, c] * Q[c] (gwas/pca.go:467-489)
    with prof.span("pca_subspace"):
        v_cm = ss_he.ss_to_cmat(mpc, cps, V)
        if pid == 0:
            return [None] * npc
        n_ct_ind = len(Q[0])
        s_ref = max(Q[c][0].scale for c in range(kp))
        Qpc = []
        for r in range(npc):
            # one one-hot multiply and a shared rotation ladder expand all kp
            # eigenvector entries (each column's scale drift folded into its
            # one-hot value); one pairwise mult and segment sum per ciphertext
            elems = []
            for tcid, vct in enumerate(v_cm[r]):
                lo = tcid * slots
                n_here = min(slots, kp - lo)
                elems.extend(B.expand_slots_many(
                    cps, vct, list(range(n_here)), cache_key=("pca_v", kp, tcid),
                    value_scales=[s_ref / Q[lo + c][0].scale for c in range(n_here)],
                ))
            row = []
            for t in range(n_ct_ind):
                col = B.cmult_pairs(cps, [Q[c][t] for c in range(kp)], elems)
                out_scale = col[0].scale * s_ref / Q[0][t].scale
                row.append(B.add_group_mod(cps, col, [0] * kp, 1, out_scale=out_scale)[0])
            Qpc.append(row)
        return Qpc
