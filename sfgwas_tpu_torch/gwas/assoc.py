"""Association tests (counterpart of sfgwas_tpu/gwas/assoc.py).  For now
only the combined covariate basis, compute_combined_q; the linear
statistics, the standard-deviation inverse and the logistic path follow
(ROADMAP A6, A9)."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..crypto import basics as B
from ..mpc import mhe
from ..mpc.mhe import CryptoParams
from ..mpc.mpc import MPC
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
