"""Protocol orchestration: config -> networks -> MPC + collective CKKS ->
QC -> (PCA) -> association (counterpart of sfgwas_tpu/gwas/protocol.py;
the Go sfgwas's gwas/gwas.go: ProtocolInfo, InitializeGWASProtocol,
Phase1/2/3, SyncAndTerminate).

Ported: the in-process transport and the TCP mesh, both genotype input
formats, the three QC routes (skip, cached filter, precomputed counts or the
scan), phase 2 (PCA, its cached PCs, or skip_pca) and phase 3, linear or
logistic (use_logistic), with either covariate-basis QR (qr_method), and
within-party sharding of the products (shard_matmult).
"""

from __future__ import annotations

import math
import os
import time
from typing import List

import numpy as np
import torch

from ..crypto import basics as B
from ..mpc import mhe
from ..mpc.mpc import MPC
from ..mpc.prg import Random
from ..ops import ring as R
from ..parallel.mesh import local_devices
from ..parallel.transport import Network
from ..utils.config import Config
from ..utils.log import log
from . import assoc as assoc_mod
from . import filestream as fs
from . import matmult as MM
from . import pca as pca_mod
from . import qc as qc_mod
from . import utilities as U
from .params import FilterParams, GWASParams


class ProtocolInfo:
    def __init__(self, config: Config, pid: int, transport=None, mpc_only=False, device=None):
        """device is the torch device of the key bundle and every
        ciphertext: None means the CUDA card (raises without one)."""
        self.config = config
        self.pid = pid
        nparty = config.nparty

        if transport is None:
            from ..parallel.transport import make_tcp_transport

            # one connection per (pair, MPC thread), as the Go sfgwas opens
            # them; the striped transport moves each large frame over all of
            # a pair's connections at once
            transport = make_tcp_transport(
                pid, nparty, config.servers, max(1, config.mpc_num_threads),
                config.binding_ipaddr,
            )
        rand = Random(pid, nparty, config.shared_keys_path or None)
        self.net = Network(transport, pid, nparty, config.hub_party_id, rand)

        if config.local_num_threads > 1:
            # the Go sfgwas fans SS/HE work over thread pools
            # (mpc/mpc.go:2639-2791); here that parallelism lives in the
            # vectorized SS engine and batched device kernels
            log(
                f"pid{pid} note: local_num_threads is subsumed by the "
                "vectorized SS/HE engines"
            )
        ring = R.field_for_size(config.mpc_field_size)
        self.mpc = MPC(
            self.net,
            ring,
            config.mpc_data_bits,
            config.mpc_frac_bits,
            config.mpc_boolean_shares,
            config.div_sqrt_max_len,
        )
        # within-party sharding: with shard_matmult every product's MAC goes
        # over this party's local devices (on a host with one card this
        # routes nothing); without it, a routing left by an earlier protocol
        # of this process is cleared
        kind = torch.device(device).type if device is not None else "cuda"
        MM.set_pipeline_devices(local_devices(kind) if config.shard_matmult else None)

        self.cps = None
        if not mpc_only:
            key_cache = None
            if config.use_cached_keys:
                os.makedirs(config.cache_dir, exist_ok=True)
                key_cache = os.path.join(config.cache_dir, "keys.npz")
            self.cps = mhe.collective_init(
                self.net, config.ckks_params, key_cache=key_cache, device=device
            )

        self.gwas_params = GWASParams(
            list(config.num_inds),
            config.num_snps,
            config.num_covs,
            config.num_pcs_to_remove,
            config.snp_dist_thres,
        )

        # input loading (gwas/gwas.go:225-274)
        self.geno_blocks: List[fs.GenoFileStream] = []
        self.geno_block_sizes: List[int] = []
        self.pheno = None
        self.cov = None
        self.pos = None
        if pid > 0:
            if config.geno_file_format == "pgen":
                # native .pgen decode, converted once to the int8 blocks
                # format under cache_dir and streamed from there
                from .pgen import PgenReader

                os.makedirs(config.cache_dir, exist_ok=True)
                nchrom = config.geno_num_blocks or 22
                batch = max(1, int(config.pgen_batch_nsnp or 8192))
                for i in range(nchrom):
                    r = PgenReader(f"{config.geno_binary_file_prefix}/chr{i + 1}.pgen")
                    bs = r.variant_ct
                    self.geno_block_sizes.append(bs)
                    conv = os.path.join(config.cache_dir, f"geno_pgen.{i}.bin")
                    if not os.path.exists(conv):
                        # pgen_batch_nsnp variants at a time into the
                        # sample-major block file: peak host memory stays
                        # O(samples x batch), not O(samples x chromosome)
                        mm = np.memmap(
                            conv, dtype=np.int8, mode="w+",
                            shape=(config.num_inds[pid], bs),
                        )
                        for v0 in range(0, bs, batch):
                            v1 = min(v0 + batch, bs)
                            mm[:, v0:v1] = r.read_range(v0, v1)
                        mm.flush()
                        del mm
                    self.geno_blocks.append(
                        fs.GenoFileStream(conv, config.num_inds[pid], bs, replace_missing=False)
                    )
            else:
                if config.geno_block_size_file:
                    with open(config.geno_block_size_file) as f:
                        self.geno_block_sizes = [int(x) for x in f.read().split()]
                else:
                    self.geno_block_sizes = [config.num_snps]
                for i, bs in enumerate(self.geno_block_sizes):
                    self.geno_blocks.append(
                        fs.GenoFileStream(
                            f"{config.geno_binary_file_prefix}.{i}.bin",
                            config.num_inds[pid], bs, replace_missing=False,
                        )
                    )
            if sum(self.geno_block_sizes) != config.num_snps:
                raise ValueError(
                    f"pid{pid}: the genotype blocks hold {sum(self.geno_block_sizes)} SNPs, "
                    f"num_snps is {config.num_snps}"
                )
            self.pheno = np.loadtxt(config.pheno_file).reshape(-1)
            self.cov = np.loadtxt(config.covar_file)
            if self.cov.ndim == 1:
                self.cov = self.cov[:, None]
            if config.snp_position_file:
                self.pos = np.loadtxt(config.snp_position_file, dtype=np.int64)
                if self.pos.ndim > 1:
                    self.pos = self.pos[:, -1]

        os.makedirs(config.cache_dir, exist_ok=True)
        os.makedirs(config.output_dir, exist_ok=True)

    def cache_path(self, name: str) -> str:
        return os.path.join(self.config.cache_dir, name)

    def out_path(self, name: str) -> str:
        return os.path.join(self.config.output_dir, name)

    # ------------------------------------------------------------- phase 1

    def phase1(self):
        cfg = self.config
        self.net.reset_log()
        fp = FilterParams(
            cfg.maf_lb, cfg.hwe_ub, cfg.gmiss, cfg.imiss_ub, cfg.het_lb, cfg.het_ub
        )
        gp = self.gwas_params
        if cfg.skip_qc and not cfg.use_cached_qc:
            gp.set_filt_counts(gp.num_inds, gp.num_snps)
            gp.set_snp_filt(np.ones(gp.num_snps, bool))
            return

        cache = self.cache_path("gkeep.txt")
        if cfg.use_cached_qc and os.path.exists(cache):
            # resume (use_cached_qc, gwas/qualcontrol.go:587): restore the
            # SNP filter, the individual filter and the stream state the
            # scan would have left, then exchange the filtered counts again
            # (every party has its own caches, the dealer's included)
            snp_filt = np.loadtxt(cache).astype(bool)
            n_ind = 0
            if self.pid > 0:
                self._filter_columns(snp_filt)
                n_ind = gp.num_inds[self.pid]
                ik_path = self.cache_path("ikeep.txt")
                if os.path.exists(ik_path):
                    ik = np.loadtxt(ik_path).astype(bool)
                    for b in self.geno_blocks:
                        b.update_row_filt(ik)
                    self.pheno = self.pheno[ik]
                    self.cov = self.cov[ik]
                    n_ind = int(ik.sum())
            self._exchange_filtered_counts(n_ind)
        elif cfg.use_precomputed_geno_count:
            if self.pid > 0:
                ac, gc, miss = fs.read_geno_stats_file(cfg.geno_count_file, gp.num_snps)
            else:
                ac = np.zeros((2, gp.num_snps), np.int64)
                gc = np.zeros((3, gp.num_snps), np.int64)
                miss = np.zeros(gp.num_snps, np.int64)
            snp_filt = qc_mod.snp_filter_with_precomputed_stats(
                self.mpc,
                ac,
                gc,
                miss,
                gp.num_inds[self.pid] if self.pid > 0 else 0,
                sum(gp.num_inds),
                fp,
                cache_prefix=self.cache_path("qc"),
            )
            # the revealed filter is public: every party (the dealer too)
            # caches it so a use_cached_qc resume stays in lockstep
            np.savetxt(cache, snp_filt.astype(int), fmt="%d")
            if self.pid > 0:
                # the association runs on the SNPs QC kept, as on a resume
                # from the cached filter (the JAX package's protocol leaves
                # the streams unfiltered here, so its fresh run reports
                # every SNP and its resumed run only the kept ones)
                self._filter_columns(snp_filt)
        else:
            snp_filt = self._qc_scan_path(fp)
            np.savetxt(cache, snp_filt.astype(int), fmt="%d")

        gp.set_snp_filt(snp_filt)
        n_filt = int(np.asarray(snp_filt).sum())
        n_filt = qc_mod._share_count(self.mpc, n_filt)
        gp.set_filt_counts(gp.num_filt_inds, n_filt)
        self.net.print_log()

    def _filter_columns(self, snp_filt):
        """Restrict each genotype stream to its SNPs that pass snp_filt."""
        shift = 0
        for b, bs in zip(self.geno_blocks, self.geno_block_sizes):
            b.update_col_filt(snp_filt[shift : shift + bs])
            shift += bs

    def _exchange_filtered_counts(self, n_ind: int):
        """Hub-aggregated per-party post-QC individual counts
        (gwas/qualcontrol.go:707-731)."""
        pid = self.pid
        counts_vec = self.net.aggregate(
            np.eye(self.net.nparty, dtype=np.int64)[pid] * n_ind,
            lambda a, b: np.asarray(a) + np.asarray(b),
        )
        if pid == self.mpc.hub_pid:
            self.net.send(np.asarray(counts_vec), 0)
        elif pid == 0:
            counts_vec = np.asarray(self.net.recv(self.mpc.hub_pid))
        self.gwas_params.num_filt_inds = [int(v) for v in counts_vec]

    def _qc_scan_path(self, fp: FilterParams) -> np.ndarray:
        """Scan-based QC (QualityControlProtocol, gwas/qualcontrol.go:645-792):
        miss filter -> individual filters -> MAF/HWE."""
        gp = self.gwas_params
        mpc = self.mpc
        pid = self.pid
        tot = sum(gp.num_inds)
        # per-SNP non-missing counts
        if pid > 0:
            counts = np.concatenate([b.column_stats()["xcount"] // 2 for b in self.geno_blocks])
        else:
            counts = np.zeros(gp.num_snps, np.int64)
        miss_filt = qc_mod.snp_miss_filter(mpc, counts, tot, fp.geno_miss)
        miss_filt = qc_mod._sync_filter(mpc, miss_filt)

        n_miss_keep = int(miss_filt.sum())
        if pid > 0:
            shift = 0
            for b, bs in zip(self.geno_blocks, self.geno_block_sizes):
                b.update_col_filt(miss_filt[shift : shift + bs])
                shift += bs
            ikeep = qc_mod.individual_miss_het_filters(self.geno_blocks, n_miss_keep, fp)
            for b in self.geno_blocks:
                b.update_row_filt(ikeep)
            n_ind = int(ikeep.sum())
        else:
            n_ind = 0
        self._exchange_filtered_counts(n_ind)

        # MAF + HWE on the miss-filtered, individual-filtered data
        n_keep = int(miss_filt.sum())
        if pid > 0:
            stats = None
            for b in self.geno_blocks:
                ph = self.pheno if b.row_filt is None else self.pheno[b.row_filt]
                st = b.column_stats(ph)
                if stats is None:
                    stats = {k: [v] for k, v in st.items()}
                else:
                    for k, v in st.items():
                        stats[k].append(v)
            cat = {k: np.concatenate(v, axis=-1) for k, v in stats.items()}
            mafhwe = qc_mod.snp_maf_hwe_filters(
                mpc,
                cat["xsum"],
                cat["xcount"],
                cat["xsum_ctrl"],
                cat["xcount_ctrl"],
                cat["geno_obs_ctrl"],
                fp,
            )
        else:
            z = np.zeros(n_keep, np.int64)
            mafhwe = qc_mod.snp_maf_hwe_filters(
                mpc, z, z, z, z, np.zeros((3, len(z)), np.int64), fp
            )
        mafhwe = qc_mod._sync_filter(mpc, mafhwe)
        if pid > 0:
            shift = 0
            for b in self.geno_blocks:
                m = b.num_cols_to_keep()
                b.update_col_filt(mafhwe[shift : shift + m])
                shift += m
            # filter pheno/cov
            ik = self.geno_blocks[0].row_filt
            if ik is not None:
                self.pheno = self.pheno[ik]
                self.cov = self.cov[ik]
            # intermediate filter caches (gkeep_miss/gkeep_maf_hwe/ikeep,
            # gwas/qualcontrol.go:651,685,743)
            np.savetxt(self.cache_path("gkeep_miss.txt"), np.asarray(miss_filt, int), fmt="%d")
            np.savetxt(self.cache_path("gkeep_maf_hwe.txt"), np.asarray(mafhwe, int), fmt="%d")
            if ik is not None:
                np.savetxt(self.cache_path("ikeep.txt"), ik.astype(int), fmt="%d")
        out = np.zeros(gp.num_snps, bool)
        idx = np.where(miss_filt)[0]
        out[idx[np.asarray(mafhwe[: len(idx)], bool)]] = True
        return out

    # ------------------------------------------------------------- phase 2

    def phase2(self):
        cfg = self.config
        gp = self.gwas_params
        self.net.reset_log()
        if cfg.skip_pca:
            gp.set_num_pc(0)
            return None

        pid = self.pid
        # the decrypted PCs (use_cached_pca, gwas/gwas.go:333-360); the
        # dealer holds none, and a marker file keeps it in lockstep
        pca_cache = self.cache_path("Qpc.txt" if pid > 0 else "Qpc.done")
        if cfg.use_cached_pca and os.path.exists(pca_cache):
            if pid > 0:
                mat = U.load_matrix_float(pca_cache)
                return [B.encrypt_float_vector(self.cps, row) for row in mat]
            return [None] * cfg.num_pcs_to_remove
        # LD pruning by position (snpDistanceFiltering, gwas/gwas.go:609-626)
        if pid > 0:
            keep = gp.snp_filt if gp.snp_filt is not None else np.ones(gp.num_snps, bool)
            n_pca, pca_filt = snp_distance_filtering(self.pos, keep, gp.min_snp_dist)
            if pid == self.mpc.hub_pid:
                self.net.send_int(n_pca, 0)
        else:
            n_pca = self.net.recv_int(self.mpc.hub_pid)
            pca_filt = None
        gp.set_num_snps_pca(n_pca)

        X = None
        if pid > 0:
            # the kept individuals' pruned columns, filled block by block
            # straight from the genotype files (missing calls read as 0)
            rf = self.geno_blocks[0].row_filt
            X = np.empty((self.geno_blocks[0].num_rows_to_keep(), n_pca), np.int8)
            shift = col = 0
            for b, bs in zip(self.geno_blocks, self.geno_block_sizes):
                sub_filt = pca_filt[shift : shift + bs]
                nc = int(sub_filt.sum())
                full = np.memmap(b.filename, dtype=np.int8, mode="r")[
                    : b.num_rows * b.num_cols
                ].reshape(b.num_rows, b.num_cols)
                sel = (full if rf is None else full[rf])[:, sub_filt]
                X[:, col : col + nc] = np.where(sel < 0, 0, sel)
                col += nc
                shift += bs
            assert col == n_pca, (col, n_pca)

        self.mpc.assert_sync()
        qpc = pca_mod.distributed_pca(
            self.mpc,
            self.cps,
            X,
            n_pca,
            [0] + list(gp.num_filt_inds[1:]),
            cfg.num_pcs_to_remove,
            cfg.num_oversampling,
            cfg.num_power_iters,
            cache_prefix=self.cache_path("geno_pca_diag"),
            restart_iter=cfg.restart_pca_from_iter,
            skip_power_iter=cfg.skip_power_iter,
            debug=cfg.debug,
            iter_per_eigenval=cfg.iter_per_eigenval,
            qr_method=cfg.qr_method,
        )
        if pid > 0:
            for p in range(1, self.net.nparty):
                U.save_matrix_collective(self.net, self.cps, qpc, gp.num_filt_inds[p], p,
                                         self.cache_path("Qpc.txt"))
        else:
            with open(self.cache_path("Qpc.done"), "w") as f:
                f.write("1\n")
        # end-of-phase barrier (gwas/pca.go:492): the dealer does not race
        # into phase 3 while the data parties are still in PCA
        self.mpc.assert_sync()
        self.net.print_log()
        return qpc

    # ------------------------------------------------------------- phase 3

    def phase3(self, qpc):
        cfg = self.config
        gp = self.gwas_params
        self.net.reset_log()
        pid = self.pid

        # SNP-axis streaming (gwas/matmult.go:1238-1316): lazy views, so each
        # block is read, encoded, multiplied and dropped one at a time
        blocks = None
        if pid > 0:
            # the streams were opened with replace_missing=False so QC could
            # count the -1 sentinels; association reads missing as dosage 0
            # (gwas/assoc.go:283 via filestream.go:383)
            for b in self.geno_blocks:
                b.replace_missing = True
            streams = self.geno_blocks
            if cfg.blocks_for_assoc_test:
                # association restricted to the listed block indices
                streams = [self.geno_blocks[i] for i in cfg.blocks_for_assoc_test]
            blocks = [fs.LazyBlock(b) for b in streams if b.num_cols_to_keep() > 0]

        if cfg.use_logistic:
            return self._phase3_logistic(qpc, blocks)

        stats, filt = assoc_mod.get_association_stats(
            self.mpc,
            self.cps,
            blocks,
            self.pheno,
            self.cov if pid > 0 else gp.num_covs,
            qpc,
            [0] + list(gp.num_filt_inds[1:]),
            cov_all_ones=cfg.cov_all_ones,
            cache_prefix=self.cache_path("assoc"),
            use_cached_combined_q=cfg.use_cached_combined_q,
            qr_method=cfg.qr_method,
            num_blocks_parallel=cfg.assoc_num_blocks_parallel,
            debug=cfg.debug,
        )
        return self._write_stats(stats, filt)

    def _phase3_logistic(self, qpc, blocks):
        """Logistic association: Newton on the covariates alone, then the
        per-SNP score test (the useLogistic path, gwas/assoc.go:955-1476)."""
        cfg = self.config
        gp = self.gwas_params
        pid = self.pid
        nrows_all = [0] + list(gp.num_filt_inds[1:])
        tot_n = sum(nrows_all[1:])
        approx = (cfg.A, cfg.B, cfg.degree)

        Q, ncols = assoc_mod.compute_combined_q(
            self.mpc, self.cps, self.cov if pid > 0 else gp.num_covs, qpc, nrows_all,
            cov_all_ones=cfg.cov_all_ones, qr_method=cfg.qr_method,
        )
        if pid > 0:
            # the basis' columns carry norm sqrt(n): Cm is orthonormal
            Cm = B.cmult_const_mat(self.cps, Q, 1.0 / math.sqrt(tot_n), rescale=True)
            Cm = mhe.bootstrap_mat_all(self.net, self.cps, Cm)
            y = self.pheno.reshape(-1)
        else:
            Cm, y = ncols, None

        weights = assoc_mod.lr_newton_cov_only(
            self.mpc, self.cps, Cm, y, cfg.epochs, nrows_all, approx, cfg.inverse_mat_scale
        )
        stats, filt = assoc_mod.gwy_score_test(
            self.mpc, self.cps, Cm, blocks, y, weights, approx, nrows_all, cfg.inverse_mat_scale
        )
        return self._write_stats(stats, filt)

    def _write_stats(self, stats, filt):
        """The statistics decrypted collectively at the data parties, the
        filter's SNPs written to assoc.txt."""
        if self.pid > 0:
            pts = mhe.collective_decrypt_many(self.net, self.cps, stats, -1)
            vals = [self.cps.ctx.decode(pt) for pt in pts]
            out = np.concatenate(vals)[: len(filt)][filt]
            np.savetxt(self.out_path("assoc.txt"), out, fmt="%.6e")
            self.net.print_log()
            return out
        return None

    def gwas(self):
        t0 = time.time()
        log(f"pid{self.pid} phase1 (QC) start")
        self.phase1()
        t1 = time.time()
        log(f"pid{self.pid} phase1 done in {t1-t0:.1f}s; phase2 (PCA) start")
        qpc = self.phase2()
        t2 = time.time()
        log(f"pid{self.pid} phase2 done in {t2-t1:.1f}s; phase3 (assoc) start")
        out = self.phase3(qpc)
        t3 = time.time()
        print(
            f"[pid {self.pid}] GWAS protocol finished in {t3-t0:.1f}s "
            f"(qc {t1-t0:.1f}s, pca {t2-t1:.1f}s, assoc {t3-t2:.1f}s)",
            flush=True,
        )
        return out

    def sync_and_terminate(self, close=True):
        """Ping-pong with party 0 then close (gwas/gwas.go:513-535)."""
        if self.pid == 0:
            for p in range(1, self.net.nparty):
                self.net.recv_int(p)
                self.net.send_int(0, p)
        else:
            self.net.send_int(0, 0)
            self.net.recv_int(0)
        if close:
            self.net.close()


def snp_distance_filtering(pos, snp_filt, dist_thres):
    """Greedy LD pruning by base-pair distance (gwas/gwas.go:609-626)."""
    keep = np.zeros(len(snp_filt), bool)
    prev = -(1 << 62)
    count = 0
    for i in range(len(snp_filt)):
        if snp_filt[i] and (count == 0 or pos[i] >= prev + dist_thres):
            keep[i] = True
            prev = pos[i]
            count += 1
    return count, keep
