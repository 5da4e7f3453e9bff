"""Distributed QR factorization over encrypted, row-partitioned matrices
(counterpart of sfgwas_tpu/gwas/qrfact.py):

* net_cholqr_enc: the CholeskyQR2 covariate basis, the default;
* net_dqr_enc (NetDQRenc of the Go sfgwas, gwas/qrfact.go:47-316): the
  column-by-column Householder QR that qr_method = "householder" selects.
  The squared column norm is aggregated across parties in HE, the sqrt and
  sign arithmetic runs in secret shares, the rank-1 update is
  dc_matmul_aat_b, and the Householder vectors are kept scaled by sqrt(N);
  net_dqr_enc_party0 is the dealer's side of it;
* net_dqr_plain (NetDQRplain, gwas/qrfact.go:319-384): a local plaintext
  QR at each party, net_dqr_enc of the stacked R blocks and the
  homomorphic recombination Qloc Qp;
* net_qr: the method dispatch.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from ..crypto import basics as B
from ..crypto import ckks as C
from ..mpc import linalg, mhe, ss_he
from ..mpc.mhe import CryptoParams
from ..mpc.mpc import MPC
from ..utils import prof
from ..utils.log import log
from .matmult import dc_matmul_aat_b


def _add_aligned(ctx, a, b):
    """a + b, both dropped to the lower of their levels."""
    nm = min(a.nmod, b.nmod)
    return ctx.add(ctx.drop_to(a, nm), ctx.drop_to(b, nm))


def net_dqr_enc(
    cps: CryptoParams, mpc: MPC, A: B.CipherMatrix, nrows_all: List[int]
) -> B.CipherMatrix:
    """Householder orthonormalization of the columns of the row-partitioned
    encrypted matrix A (A[c] a CipherVector of this party's rows).  Returns
    Q scaled by sqrt(N) with its trailing slots masked.  The dealer passes
    [None] * ncols and gets [None] * ncols back: every SS and network call
    below is guarded by party, so it runs the same function."""
    ring = mpc.ring
    pid = mpc.pid
    fb, kb = mpc.frac_bits, mpc.data_bits
    slots = cps.slots
    nparty = mpc.nparty
    ncols = len(A)
    tot_n = sum(nrows_all[1:])
    sqrt_n = math.sqrt(tot_n)
    inv_n = 1.0 / tot_n
    inv_sqrt_n = 1.0 / sqrt_n
    ctx = cps.ctx

    v_list: List[B.CipherVector] = [None] * ncols

    # the whole QR lives in the working band (every column refreshes A
    # anyway); band + 2 keeps the HE->SS conversions above their headroom
    qr_band = min(ctx.nq, cps.rot_nmod + 2)
    if pid > 0:
        # clamp down into the band first, so the refresh target stays at
        # qr_band and its scale reset applies to every column.  Columns
        # already below the band (PCA's products) stay put and the refresh
        # raises them: the JAX package's drop_to(ct, qr_band) fails on them
        A = [[ctx.drop_to(ct, min(qr_band, ct.nmod)) for ct in col] for col in A]
        A = mhe.bootstrap_mat_all(mpc.net, cps, A, target_nmod=qr_band)

    for col in range(ncols):
        # the per-column totals are printed but not cleared: the caller's
        # spans of the same thread accumulate across the QR
        prof.dump(f"qr pid{pid} col{col}")
        log(f"pid{pid} DQR forward col {col+1}/{ncols}")
        ncol_curr = ncols - col
        upid, ctid, slotid = (
            B.global_to_party_index(cps, nrows_all, col, nparty) if pid > 0 else (1, 0, 0)
        )

        # z = the sum over parties of ||A[0]||^2 (one ciphertext)
        if pid > 0:
            with prof.span("qr_sqsum"):
                zloc = B.sq_sum(cps, A[0])
                uvec = B.copy_vec(A[0])
            with prof.span("qr_aggz"):
                z = mhe.aggregate_ct(mpc.net, cps, zloc)
            log(f"pid{pid} DQR col{col}: A nmod={A[0][0].nmod} z nmod={z.nmod} band={qr_band}")
        else:
            z = None

        z_ss = ss_he.ciphertext_to_ss(mpc, cps, z, -1, 1)
        z_sqrt_ss, _ = mpc.sqrt_and_sqrt_inverse(z_ss)

        ss_in = uvec[ctid] if (pid > 0 and upid == pid) else None
        x_full = ss_he.ciphertext_to_ss(mpc, cps, ss_in, upid, slots)
        x_ss = x_full[slotid : slotid + 1]

        with prof.span("qr_ispos"):
            sgn = mpc.is_positive(x_ss)
        sgn = ring.mul_int(sgn, 2)
        if pid == mpc.hub_pid:
            sgn = ring.sub(sgn, np.broadcast_to(ring.const_np(1), sgn.shape))

        alpha_ss = mpc.ss_mult_elem(z_sqrt_ss, sgn)

        apx = ring.add(alpha_ss, x_ss)
        concat = np.concatenate([np.asarray(apx), np.asarray(x_ss)], axis=0)
        concat_sq = mpc.ss_mult_elem(concat, concat)
        z_update = mpc.trunc(ring.sub(concat_sq[0:1], concat_sq[1:2]), kb, fb)

        _, z_new_sqrt_inv = mpc.sqrt_and_sqrt_inverse(ring.add(z_ss, z_update), False)
        scalar = ring.const_np(int(round(sqrt_n * (1 << fb))))
        z_new_sqrt_inv = ring.mul(z_new_sqrt_inv, np.broadcast_to(scalar, z_new_sqrt_inv.shape))
        z_new_sqrt_inv = mpc.trunc(z_new_sqrt_inv, kb, fb)

        alpha_scaled = mpc.ss_mult_elem(alpha_ss, z_new_sqrt_inv)
        alpha_scaled = mpc.trunc(alpha_scaled, kb, fb)

        with prof.span("qr_ss2he"):
            alpha_ct = ss_he.ss_to_ciphertext(mpc, cps, alpha_scaled[None])
            z_inv_ct = ss_he.ss_to_ciphertext(mpc, cps, z_new_sqrt_inv[None])
        if pid == 0:
            # the dealer has no ciphertext columns to update
            continue

        # spread the scalar in slot 0 to every slot: the sum over a
        # ciphertext with one nonzero slot is that slot's value
        alpha_ct = B.rotate_and_add(cps, alpha_ct, slots)
        z_inv_ct = B.rotate_and_add(cps, z_inv_ct, slots)

        # v = A[0] * (sqrt(N) / ||v||), plus alpha at the pivot slot
        with prof.span("qr_uvec_mul"):
            uvec = B.cmult_scalar(cps, uvec, z_inv_ct)
        if pid == upid:
            amask = B.mask(cps, alpha_ct, slotid, False)
            uvec[ctid] = _add_aligned(ctx, uvec[ctid], amask)
        # the rank-1 update needs two levels on v; the refresh is
        # unconditional because only the pivot party masked, so the
        # parties' levels differ here and a level-conditional refresh
        # would desynchronise them (the Go sfgwas refreshes around the
        # rank-1 updates too, gwas/qrfact.go:201)
        uvec = mhe.bootstrap_mat_all(mpc.net, cps, [uvec], target_nmod=qr_band)[0]
        v_list[col] = uvec

        # A <- (I - 2 v v^T / N) A, by the batched ciphertext inner products
        with prof.span("qr_dcmm"):
            vvta = dc_matmul_aat_b(cps, mpc, [uvec], A, nrows_all, ncol_curr, None,
                                   bs_target=qr_band)
        newA = []
        for c in range(len(A)):
            terms = B.cmult_const(cps, vvta[c], -2 * inv_n, rescale=True)
            newA.append([_add_aligned(ctx, a, t) for a, t in zip(A[c], terms)])
        A = mhe.bootstrap_mat_all(mpc.net, cps, newA, target_nmod=qr_band)
        # drop the first column and mask out the pivot row.  Every
        # ciphertext at every party spends the same mask level (the others
        # multiply by ones): a pivot-only mask would leave levels and scales
        # diverged across parties, and the next column's aggregation would
        # spend the band on aligning them
        A = A[1:]
        if A:
            for c in range(len(A)):
                for ti in range(len(A[c])):
                    if upid == pid and ti == ctid:
                        A[c][ti] = B.mask(cps, A[c][ti], slotid, True)
                    else:
                        A[c][ti] = B.ones_rescale(cps, A[c][ti])
            A, _ = B.flatten_levels(cps, A)

    if pid == 0:
        return [None] * ncols

    # the backward pass: Q from the Householder vectors
    nrows = nrows_all[pid]
    with prof.span("qr_backward"):
        Q: B.CipherMatrix = []
        for c in range(ncols):
            colvec = np.zeros(nrows)
            upid, ctid, slotid = B.global_to_party_index(cps, nrows_all, c, nparty)
            if upid == pid:
                colvec[ctid * slots + slotid] = sqrt_n
            Q.append(B.encrypt_float_vector(cps, colvec))

        for j in range(ncols - 1, -1, -1):
            log(f"pid{pid} DQR backward col {j+1}/{ncols}")
            upid, ctid, slotid = B.global_to_party_index(cps, nrows_all, j, nparty)
            ncol_curr = ncols - j

            def fn(cp, a, Bm, jj, upid=upid, ctid=ctid, slotid=slotid):
                if jj == 0:
                    # every party shapes a mask result (level and scale alike
                    # at every party); the parties without the pivot zero it,
                    # so the aggregate's scale bookkeeping agrees
                    m = B.mask(cp, a[ctid] if upid == pid else a[0], slotid, False)
                    if upid != pid:
                        m = C.Ciphertext(torch.zeros_like(m.c0), torch.zeros_like(m.c1),
                                         m.nmod, m.scale)
                    return [m]
                return B.cmult(cp, a, Bm[jj])

            vvtq = dc_matmul_aat_b(cps, mpc, [v_list[j]], Q[j:], nrows_all, ncol_curr, fn,
                                   bs_target=qr_band)
            for c in range(ncol_curr):
                scalar = inv_sqrt_n if c == 0 else inv_n
                terms = B.cmult_const(cps, vvtq[c], -2 * scalar, rescale=True)
                Q[j + c] = [_add_aligned(ctx, q, t) for q, t in zip(Q[j + c], terms)]
            Q[j : j + ncol_curr] = mhe.bootstrap_mat_all(mpc.net, cps, Q[j : j + ncol_curr],
                                                         target_nmod=qr_band)

    # mask the trailing slots
    for i in range(len(Q)):
        for j2 in range(len(Q[i])):
            nk = slots if j2 < len(Q[i]) - 1 else ((nrows - 1) % slots) + 1
            Q[i][j2] = B.mask_trunc(cps, Q[i][j2], nk)
    return Q


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
    passes), 'cholqr3' (three) or 'householder' (net_dqr_enc, the Go
    sfgwas's column-by-column QR)."""
    if method == "householder":
        return net_dqr_enc(cps, mpc, A, nrows_all)
    if method == "cholqr3":
        return net_cholqr_enc(cps, mpc, A, nrows_all, passes=3)
    assert method == "cholqr2", f"unknown qr_method {method!r}"
    return net_cholqr_enc(cps, mpc, A, nrows_all, passes=2)


def net_dqr_enc_party0(cps, mpc, ncols: int, nrows_all: List[int]):
    """The dealer's side of net_dqr_enc: it takes part in the aggregation
    and SS sub-protocols only."""
    return net_dqr_enc(cps, mpc, [None] * ncols, nrows_all)


def net_dqr_plain(
    cps: CryptoParams, mpc: MPC, A_local: np.ndarray, nrows_all: List[int]
) -> B.CipherMatrix:
    """The DASH-style distributed QR (NetDQRplain, gwas/qrfact.go:319-384):
    each data party factors its local plaintext block, the stacked R blocks
    go through net_dqr_enc, and Q = Qloc Qp is recombined homomorphically.
    The Go sfgwas notes it as less accurate than the fully encrypted QR
    (gwas/assoc.go:158-159).  The dealer passes None for A_local.  Unlike
    the JAX package's, it refreshes Qp before the recombination."""
    pid = mpc.pid
    slots = cps.slots if cps else 0
    ncols = A_local.shape[1] if pid > 0 else 0
    if pid == mpc.hub_pid:
        mpc.net.send_int(ncols, 0)
    elif pid == 0:
        ncols = mpc.net.recv_int(mpc.hub_pid)
    nrows_total = sum(nrows_all[1:])
    scaling = 1.0 / math.sqrt(ncols * (mpc.nparty - 1)) if ncols else 0.0

    if pid > 0:
        q_loc, r_loc = np.linalg.qr(A_local)
        q_loc = q_loc * math.sqrt(nrows_total)
        r_enc = [B.encrypt_float_vector(cps, r_loc[:, j]) for j in range(ncols)]
    else:
        r_enc = [None] * ncols

    Qp = net_dqr_enc(cps, mpc, r_enc, [0] + [ncols] * (mpc.nparty - 1))
    if pid == 0:
        return [None] * ncols

    # Qp leaves net_dqr_enc one mask below the band, and the recombination
    # spends three more levels (the pivot mask, the plaintext product, the
    # scaling): at every preset that is one more than the chain holds (the
    # JAX package's net_dqr_plain stops there on a level underflow), so Qp
    # is refreshed into the band first
    ctx = cps.ctx
    Qp = mhe.bootstrap_mat_all(mpc.net, cps, Qp, target_nmod=min(ctx.nq, cps.rot_nmod + 2))
    Q: B.CipherMatrix = []
    for c in range(ncols):
        acc = None
        for j in range(ncols):
            elem = B.mask(cps, Qp[c][j // slots], j % slots, False)
            elem = B.rotate_and_add(cps, elem, slots)
            col = [ctx.rescale(ctx.mul_plain(elem, p))
                   for p in B.encode_float_vector(cps, q_loc[:, j])]
            acc = col if acc is None else [_add_aligned(ctx, a_, b_) for a_, b_ in zip(acc, col)]
        Q.append(B.cmult_const(cps, acc, scaling, rescale=True))
    return Q
