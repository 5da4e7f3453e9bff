"""The plain reference that decides `correct`: plain numpy over the inputs the
benchmark made, importing nothing of the program.

- qc_filter: the SNP filter of snp_filter_with_precomputed_stats over the
  pooled plink2 counts (frozen copy of chip_smoke.py::assoc_qc_oracle).
- assoc_stats: each kept SNP's statistic, the Pearson correlation of the
  dosages (missing read as 0) and the phenotype, both projected off [ones |
  covariates] (frozen copy of chip_smoke.py::assoc_stat_oracle; the
  caller puts the PC scores among the covariates).

data is {data party: (genotypes, phenotype, covariates)}, the parties'
rows pooled in party order.
- inv_sqrt: 1 / sqrt(v).

Everything in float64.
"""

from __future__ import annotations

import numpy as np


def _pooled(data, k: int) -> np.ndarray:
    return np.concatenate([data[pid][k] for pid in sorted(data)])


def qc_filter(data, fp) -> np.ndarray:
    """Missingness, then MAF in exact integers (the protocol's 20-bit bound)
    and the HWE chi-square in floats.  fp: (maf_lb, hwe_ub, gmiss, ...)."""
    maf_lower, hwe_upper, geno_miss = fp[:3]
    g = _pooled(data, 0)
    nonmiss = (g >= 0).sum(0)
    keep = nonmiss >= int((1 - geno_miss) * g.shape[0])
    gobs = np.stack([(g == k).sum(0) for k in range(3)]).astype(np.float64)
    s = gobs[1] + 2 * gobs[2]
    c = 2 * nonmiss
    bound = int(round(((2 * maf_lower - 1.0) ** 2) * (1 << 20)))
    maf_ok = np.array([int(ci) ** 2 * bound - (2 * int(si) - int(ci)) ** 2 * (1 << 20) > 0
                       for si, ci in zip(s, c)], dtype=bool)
    a, b = s, c.astype(np.float64)
    exp = [(b - a) ** 2, 2 * a * (b - a), a ** 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        chi = sum((2 * b * gobs[i] - exp[i]) ** 2 / exp[i] for i in range(3))
    return keep & maf_ok & (chi < 2 * b * hwe_upper)


def assoc_stats(data, keep: np.ndarray, cols: int = 2048) -> np.ndarray:
    """The kept SNPs' statistics, cols SNPs at a time."""
    y = _pooled(data, 1).astype(np.float64)
    C = _pooled(data, 2).astype(np.float64)
    Qm, _ = np.linalg.qr(np.column_stack([np.ones(len(y)), C]))
    yt = y - Qm @ (Qm.T @ y)
    ynorm = np.sqrt(yt @ yt)
    G_all = _pooled(data, 0)
    idx = np.flatnonzero(keep)
    out = []
    for c0 in range(0, len(idx), cols):
        G = G_all[:, idx[c0 : c0 + cols]].astype(np.float64)
        G[G < 0] = 0
        Gt = G - Qm @ (Qm.T @ G)
        out.append((yt @ G) / np.sqrt((Gt * Gt).sum(0)) / ynorm)
    return np.concatenate(out) if out else np.zeros(0)


def inv_sqrt(v: np.ndarray) -> np.ndarray:
    return 1 / np.sqrt(np.asarray(v, np.float64))


def abs_errors(got, want) -> dict:
    """The largest and the root-mean-square absolute difference (inf where
    the shapes differ or a value is not finite)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        return {"max": float("inf"), "rms": float("inf")}
    e = np.abs(got - want)
    return {"max": float(e.max(initial=0.0)),
            "rms": float(np.sqrt((e * e).mean())) if e.size else 0.0}
