"""The association call: one unit is the study's phase 3 over the
configuration's num_snps in blocks of geno_block_snps,
get_association_stats (the basis of [ones | covariates | PCs], y~, the
block products with the prefetch thread's host encode, the aggregates and
refreshes, the std-inverse) followed by the collective decrypt of its
statistics at the data parties.  QC from the plink2 counts runs once, in
set-up, and each data party encrypts its rows of the num_pcs_to_remove PC
scores there, as the PCA phase hands them on.  The warm-up unit runs the
same call on the traffic's warmup_blocks blocks.

The answers compared: each data party's revealed QC filter, against the
reference's, exactly; each unit's decrypted statistics at each data party,
against the reference's, by their largest and their root-mean-square
absolute difference.
"""

from __future__ import annotations

import os

import numpy as np

from .. import gen, reference

WORK_UNIT = "SNPs"


def blocks(cfg: dict) -> tuple:
    """(SNPs a block, blocks a unit)."""
    m_block = cfg["geno_block_snps"]
    if cfg["num_snps"] % m_block:
        raise ValueError(f"num_snps {cfg['num_snps']} is not whole blocks of {m_block}")
    return m_block, cfg["num_snps"] // m_block


def work(cfg: dict, traffic: dict) -> int:
    """Input SNPs a unit produces statistics for."""
    return cfg["num_snps"]


def filter_params(cfg: dict) -> tuple:
    """(maf_lb, hwe_ub, gmiss, imiss_ub, het_lb, het_ub), FilterParams' order."""
    return tuple(cfg[k] for k in ("maf_lb", "hwe_ub", "gmiss", "imiss_ub", "het_lb", "het_ub"))


def make_inputs(seed: int, cfg: dict, traffic: dict, rundir: str):
    """The study's data from the seed, written where the parties read it;
    returns it for the reference."""
    m_block, nblocks = blocks(cfg)
    data = gen.assoc_data(seed, cfg["num_inds"], m_block, nblocks, cfg["num_covs"])
    pcs = gen.pc_scores(seed, cfg["num_inds"], cfg["num_pcs_to_remove"])
    gen.write_assoc_inputs(rundir, data, pcs, m_block, nblocks)
    return data, pcs


class Party:
    """One party's side: QC in the constructor, then run() once a unit."""

    def __init__(self, mpc, cps, cfg: dict, traffic: dict, rundir: str, device):
        from sfgwas_tpu_torch.crypto import basics as B
        from sfgwas_tpu_torch.gwas import filestream as FS
        from sfgwas_tpu_torch.gwas.params import FilterParams
        from sfgwas_tpu_torch.gwas.qc import snp_filter_with_precomputed_stats

        self.mpc, self.cps, self.rundir = mpc, cps, rundir
        self.m_block, self.nblocks = blocks(cfg)
        self.warmup_blocks = traffic["warmup_blocks"]
        self.ncov = cfg["num_covs"]
        self.parallel, self.qr_method = cfg["assoc_num_blocks_parallel"], cfg["qr_method"]
        pid = mpc.pid
        self.nrows_all = [0] + list(cfg["num_inds"][1:])
        self.n_loc = self.nrows_all[pid]
        m = self.m_block * self.nblocks
        npc = cfg["num_pcs_to_remove"]
        if pid > 0:
            ac, gc, miss = FS.read_geno_stats_file(os.path.join(rundir, f"p{pid}_gcount.bin"), m)
            self.pheno = np.load(os.path.join(rundir, f"p{pid}_pheno.npy"))
            self.cov = np.load(os.path.join(rundir, f"p{pid}_cov.npy"))
            pcs = np.load(os.path.join(rundir, f"p{pid}_pcs.npy"))
            # PCA's output: one CipherVector a PC over the party's rows
            self.qpc = [B.encrypt_float_vector(cps, pcs[:, j]) for j in range(npc)]
        else:
            ac, gc, miss = np.zeros((2, m)), np.zeros((3, m)), np.zeros(m)
            self.qpc = [None] * npc
        self.keep = snp_filter_with_precomputed_stats(
            mpc, ac, gc, miss, self.n_loc, sum(self.nrows_all),
            FilterParams(*filter_params(cfg)))
        self.stats = []

    def _blocks(self):
        """Phase 3's view: each block's stream column-filtered by the QC
        filter, missing read as 0, read lazily by the prefetch thread."""
        from sfgwas_tpu_torch.gwas import filestream as FS

        out = []
        for b in range(self.nblocks):
            st = FS.GenoFileStream(gen.geno_path(self.rundir, self.mpc.pid, b), self.n_loc,
                                   self.m_block, replace_missing=False)
            st.update_col_filt(self.keep[b * self.m_block : (b + 1) * self.m_block])
            st.replace_missing = True
            if st.num_cols_to_keep() > 0:
                out.append(FS.LazyBlock(st))
        return out

    def run(self, index: int) -> None:
        """Unit `index`; -1 is the warm-up, whose answers are not kept."""
        from sfgwas_tpu_torch.gwas.assoc import get_association_stats
        from sfgwas_tpu_torch.mpc import mhe as PM

        mpc, cps = self.mpc, self.cps
        if mpc.pid == 0:
            get_association_stats(mpc, cps, None, None, self.ncov, self.qpc, self.nrows_all,
                                  qr_method=self.qr_method)
            return
        blocks = self._blocks()
        if index < 0:
            blocks = blocks[: self.warmup_blocks]
        stats, filt = get_association_stats(
            mpc, cps, blocks, self.pheno, self.cov, self.qpc, self.nrows_all,
            qr_method=self.qr_method, num_blocks_parallel=self.parallel)
        pts = PM.collective_decrypt_many(mpc.net, cps, stats, -1)
        if index >= 0:
            vals = np.concatenate([cps.ctx.decode(pt) for pt in pts])
            self.stats.append(vals[: len(filt)][filt])

    def finish(self) -> dict:
        """The answers: the revealed filter and each unit's statistics."""
        if self.mpc.pid == 0:
            return {}
        return {"keep": np.asarray(self.keep, bool),
                **{f"stats{i}": s for i, s in enumerate(self.stats)}}


def reference_outputs(inputs, cfg: dict, traffic: dict) -> dict:
    """What a sound program answers for one unit, by the reference: the PC
    scores join the covariates in the basis the statistics are projected
    off."""
    data, pcs = inputs
    keep = reference.qc_filter(data, filter_params(cfg))
    basis = {pid: (g, pheno, np.column_stack([cov, pcs[pid]]))
             for pid, (g, pheno, cov) in data.items()}
    return {"keep": keep, "stats0": reference.assoc_stats(basis, keep), "parties": list(data)}


def compare(want: dict, outputs: dict, unit_ids) -> dict:
    """The numbers compared, from each data party's answers (outputs[pid])
    against the reference's (want, reference_outputs): SNPs
    whose filter differs, units without statistics, and the statistics'
    largest and root-mean-square absolute difference over the units
    unit_ids at every data party."""
    keep, stats = want["keep"], want["stats0"]
    mismatch, missing, worst, sq, cnt = 0, 0, 0.0, 0.0, 0
    for pid in want["parties"]:
        out = outputs.get(pid, {})
        got_keep = out.get("keep")
        if got_keep is None or got_keep.shape != keep.shape:
            mismatch += len(keep)
        else:
            mismatch += int((got_keep != keep).sum())
        for i in unit_ids:
            got = out.get(f"stats{i}")
            if got is None:
                missing += 1
                continue
            e = reference.abs_errors(got, stats)
            worst = max(worst, e["max"])
            sq += e["rms"] ** 2 * max(1, stats.size)
            cnt += max(1, stats.size)
    return {"filter_mismatches": mismatch, "missing_answers": missing,
            "stat_max_abs_err": worst, "stat_rms_abs_err": float(np.sqrt(sq / cnt)) if cnt else 0.0}
