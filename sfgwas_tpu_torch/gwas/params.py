"""Mutable GWAS dimension state (counterpart of sfgwas_tpu/gwas/params.py;
the Go sfgwas's gwas/params.go:3-108)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class FilterParams:
    maf_lower: float
    hwe_upper: float
    geno_miss: float
    ind_miss: float
    het_lower: float
    het_upper: float


@dataclass
class GWASParams:
    num_inds: List[int]
    num_snps: int
    num_covs: int
    num_pcs: int
    min_snp_dist: int

    num_filt_inds: List[int] = field(default_factory=list)
    num_filt_snps: int = 0
    num_snps_pca: int = 0
    snp_filt: Optional[np.ndarray] = None
    pop_strat: bool = False

    def __post_init__(self):
        if not self.num_filt_inds:
            self.num_filt_inds = list(self.num_inds)
        if not self.num_filt_snps:
            self.num_filt_snps = self.num_snps

    def set_filt_counts(self, inds: List[int], snps: int):
        self.num_filt_inds = list(inds)
        self.num_filt_snps = int(snps)

    def set_snp_filt(self, filt):
        self.snp_filt = None if filt is None else np.asarray(filt, bool)

    def set_num_pc(self, n: int):
        self.num_pcs = n

    def set_num_snps_pca(self, n: int):
        self.num_snps_pca = n
