"""Phase 1: quality control (counterpart of sfgwas_tpu/gwas/qc.py; the Go
sfgwas's gwas/qualcontrol.go).

Each party's local plaintext counts act directly as its additive share
(their sum over parties is the global count); the comparisons and divisions
then run as secure protocols on the host SS engine:

* SNP missingness: count >= (1-gmiss) * N via NotLessThanPublic;
* MAF: (2s-c)^2 <= c^2 (2maf-1)^2 via IsPositive;
* HWE: chi-square over expected genotype counts with secure Divide and
  LessThan;
* the individual missingness and heterozygosity filters are party-local.

The precomputed geno-count path (snp_filter_with_precomputed_stats) splits
the SNP axis into windows of MAX_WINDOW SNPs, each with an optional cache
file that all parties agree to use through a hub-ANDed consensus round.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..mpc.mpc import MPC
from .params import FilterParams

MAX_WINDOW = 10_000_000


def _from_counts(mpc: MPC, counts) -> np.ndarray:
    """Local nonnegative counts -> ring digits (zero for party 0)."""
    ring = mpc.ring
    arr = np.asarray(counts, dtype=np.int64)
    if mpc.pid == 0:
        return ring.zeros((len(arr),))
    return ring.from_i32(np.asarray(arr, np.int32))


def _reveal_bits(mpc: MPC, filt) -> np.ndarray:
    rev = mpc.reveal_sym(filt)
    if mpc.pid == 0:
        return np.zeros(filt.shape[0], dtype=bool)
    # revealed values are canonical 0/1 digits: nonzero test needs no
    # bignum conversion (the per-element to_ints loop dominated QC reveal)
    return np.any(np.asarray(rev) != 0, axis=-1)


def snp_miss_filter(
    mpc: MPC, local_counts, total_inds: int, gmiss_bound: float
) -> np.ndarray:
    """Secure comparison: non-missing count >= (1-gmiss)*N, revealed."""
    x = _from_counts(mpc, local_counts)
    lb = int((1 - gmiss_bound) * total_inds)
    filt = mpc.not_less_than_public(x, mpc.ring.const_np(lb))
    return _reveal_bits(mpc, filt)


def snp_maf_hwe_filters(
    mpc: MPC,
    xsum,
    xcount,
    xsum_ctrl,
    xcount_ctrl,
    geno_obs_ctrl,
    fp: FilterParams,
    combine: bool = True,
):
    """MAF + HWE filters on (local-share) count vectors; returns revealed
    keep mask (gwas/qualcontrol.go:402-579)."""
    ring = mpc.ring
    pid = mpc.pid
    fb = mpc.frac_bits
    n = len(np.asarray(xsum))

    x_sum = _from_counts(mpc, xsum)
    x_count = _from_counts(mpc, xcount)

    # MAF: (2s - c)^2 <= c^2 (2 maf - 1)^2
    if pid > 0:
        s2 = ring.sub(ring.mul_int(x_sum, 2), x_count)
    else:
        s2 = x_sum
    x_sum_sq = mpc.ss_mult_elem(s2, s2)
    x_count_sq = mpc.ss_mult_elem(x_count, x_count)
    prec = 20
    bound = ring.const_np(int(round(((2 * fp.maf_lower - 1.0) ** 2) * (1 << prec))))
    if pid > 0:
        x_count_sq = ring.mul(x_count_sq, np.broadcast_to(bound, x_count_sq.shape))
        x_sum_sq = ring.mul_int(x_sum_sq, 1 << prec)
        diff = ring.sub(x_count_sq, x_sum_sq)
    else:
        diff = x_count_sq
    maf_filt = mpc.is_positive(diff)

    # HWE chi-square over the control cohort
    a = _from_counts(mpc, xsum_ctrl)  # alpha
    b = _from_counts(mpc, xcount_ctrl)  # beta (2 * observed)
    b2 = ring.mul_int(b, 2)  # 2*beta
    bma = ring.sub(b, a)  # beta - alpha

    expected = [None] * 3
    expected[2] = mpc.ss_mult_elem(a, a)  # alpha^2
    a2 = ring.mul_int(a, 2)
    expected[1] = mpc.ss_mult_elem(a2, bma)  # 2 alpha (beta - alpha)
    expected[0] = mpc.ss_mult_elem(bma, bma)  # (beta - alpha)^2

    chi_sq = ring.zeros((n,))
    for i in range(3):
        gobs = _from_counts(mpc, np.asarray(geno_obs_ctrl)[i])
        tmp = mpc.ss_mult_elem(b2, gobs)
        tmp = ring.sub(tmp, expected[i])
        tmp = mpc.ss_mult_elem(tmp, tmp)
        div = mpc.divide(tmp, expected[i])
        chi_sq = ring.add(chi_sq, div)

    hwe_bound = ring.const_np(int(round(fp.hwe_upper * (1 << fb))))
    thresh = ring.mul(b2, np.broadcast_to(hwe_bound, b2.shape))
    hwe_filt = mpc.less_than(chi_sq, thresh)

    if combine:
        both = mpc.ss_mult_elem(maf_filt, hwe_filt)
        return _reveal_bits(mpc, both)
    return _reveal_bits(mpc, maf_filt), _reveal_bits(mpc, hwe_filt)


def individual_miss_het_filters(
    geno_blocks, num_filt_snps: int, fp: FilterParams
) -> np.ndarray:
    """Local plaintext per-sample filters (gwas/qualcontrol.go:36-81)."""
    miss = None
    het = None
    for gfs in geno_blocks:
        m, h = gfs.missing_counts()
        miss = m if miss is None else miss + m
        het = h if het is None else het + h
    miss_rate = miss / max(num_filt_snps, 1)
    het_rate = het / np.maximum(num_filt_snps - miss, 1)
    return (
        (miss_rate < fp.ind_miss)
        & (het_rate < fp.het_upper)
        & (het_rate > fp.het_lower)
    )


def hub_consensus(mpc: MPC, want: bool) -> bool:
    """All parties take the same branch where one runs MPC rounds and the
    other none (a QC window's cache, the association's basis cache): the
    hub ANDs its own and the other data parties' bits and sends the
    decision to every party; party 0's bit counts for nothing."""
    nparty = mpc.net.nparty
    if mpc.pid == mpc.hub_pid:
        bits = [int(want)] + [
            mpc.net.recv_int(p)
            for p in range(1, nparty)
            if p != mpc.hub_pid
        ]
        decision = int(all(bits))
        for p in range(nparty):
            if p != mpc.pid:
                mpc.net.send_int(decision, p)
        return bool(decision)
    if mpc.pid > 0:
        mpc.net.send_int(int(want), mpc.hub_pid)
    return bool(mpc.net.recv_int(mpc.hub_pid))


def _window_cache_tag(fp: FilterParams, ac, gc, miss, num_ind, total_inds) -> str:
    """Short content hash naming a QC window-cache file: thresholds + the
    window's geno-stats bytes + cohort sizes (an un-keyed window cache
    would survive a change of thresholds)."""
    import hashlib

    h = hashlib.blake2b(digest_size=8)
    h.update(
        repr(
            (
                fp.maf_lower, fp.hwe_upper, fp.geno_miss,
                fp.ind_miss, fp.het_lower, fp.het_upper,
                int(num_ind), int(total_inds),
            )
        ).encode()
    )
    for arr in (ac, gc, miss):
        a = np.ascontiguousarray(arr)
        h.update(a.tobytes())
    return h.hexdigest()


def snp_filter_with_precomputed_stats(
    mpc: MPC, ac, gc, miss, num_ind: int, total_inds: int, fp: FilterParams,
    cache_prefix: Optional[str] = None,
) -> np.ndarray:
    """Windowed miss -> MAF -> HWE ladder driven by the plink2 --geno-counts
    file (gwas/qualcontrol.go:86-337).  ac: [2, m], gc: [3, m], miss: [m]
    (zeros at party 0).  cache_prefix enables per-window cache files
    (gwas/qualcontrol.go:92-126): a biobank-scale scan that dies mid-way
    resumes at the first uncached window instead of from zero."""
    m = len(miss)
    if m > MAX_WINDOW:
        out = np.zeros(m, dtype=bool)
        for s in range(0, m, MAX_WINDOW):
            e = min(s + MAX_WINDOW, m)
            # window caches are keyed by the QC thresholds AND a fingerprint
            # of the window's input stats, so re-running with changed
            # FilterParams (or different data in the same cache_dir) misses
            # cleanly instead of silently returning stale filters
            wf = (
                f"{cache_prefix}_qcwin_{s}_{e}_"
                f"{_window_cache_tag(fp, ac[:, s:e], gc[:, s:e], miss[s:e], num_ind, total_inds)}.npy"
                if cache_prefix
                else None
            )
            # party 0 holds no caches; it votes yes and follows the others
            want = mpc.pid == 0 or (wf is not None and os.path.exists(wf))
            if wf is not None and hub_consensus(mpc, want):
                out[s:e] = (
                    np.load(wf) if mpc.pid > 0 else np.zeros(e - s, bool)
                )
                continue
            out[s:e] = snp_filter_with_precomputed_stats(
                mpc, ac[:, s:e], gc[:, s:e], miss[s:e], num_ind, total_inds, fp
            )
            if wf is not None and mpc.pid > 0:
                np.save(wf, out[s:e])
        return out

    miss = np.asarray(miss, np.int64)
    nonmiss = (num_ind - miss) if mpc.pid > 0 else np.zeros(m, np.int64)
    jkeep = snp_miss_filter(mpc, nonmiss, total_inds, fp.geno_miss)
    jkeep = _sync_filter(mpc, jkeep)

    idx = np.where(jkeep)[0]
    nkeep = _share_count(mpc, int(jkeep.sum()))
    if nkeep == 0:
        return jkeep
    if mpc.pid > 0:
        xsum = np.asarray(ac)[1][idx]
        xcount = 2 * (num_ind - miss[idx])
        gobs = np.asarray(gc)[:, idx]
    else:
        xsum = np.zeros(nkeep, np.int64)
        xcount = np.zeros(nkeep, np.int64)
        gobs = np.zeros((3, nkeep), np.int64)
    # the precomputed-stats path uses the full cohort for HWE
    # (gwas/qualcontrol.go:253 TODO in the reference)
    keep2 = snp_maf_hwe_filters(mpc, xsum, xcount, xsum, xcount, gobs, fp)
    out = np.zeros(m, dtype=bool)
    if mpc.pid > 0:
        out[idx] = keep2[: len(idx)]
    return out


def _share_count(mpc: MPC, local_count: int) -> int:
    """Hub shares a public count with party 0 (gwas/qualcontrol.go:169-177)."""
    if mpc.pid == mpc.hub_pid:
        mpc.net.send_int(local_count, 0)
        return local_count
    if mpc.pid == 0:
        return mpc.net.recv_int(mpc.hub_pid)
    return local_count


def _sync_filter(mpc: MPC, filt: np.ndarray) -> np.ndarray:
    """Party 0 learns the revealed filter (it needs matching shapes for the
    follow-up protocols)."""
    if mpc.pid == mpc.hub_pid:
        mpc.net.send(np.asarray(filt, np.int8), 0)
        return filt
    if mpc.pid == 0:
        got = mpc.net.recv(mpc.hub_pid)
        return np.asarray(got, bool)
    return filt
