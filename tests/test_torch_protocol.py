"""The port's protocol through its CLI (sfgwas_tpu_torch/cli.py over
gwas/protocol.py::ProtocolInfo): three parties (dealer 0, data parties 1 and 2, hub 1)
in one process with --local-sim 3 on the CPU at TEST8, on
tests/test_e2e_gwas.py's data (24 and 20 individuals, 50 SNPs in 2 blocks
with 2% missing calls, 2 covariates), linear association with skip_pca.

Each run's assoc.txt is held to the plaintext oracle within the reference
tests' bounds (tests/test_e2e_gwas.py:183-185: 2e-2, corr > 0.999): on
the scan-QC route, on the precomputed-count route and on the pgen input
branch.  A run resumed from the first run's caches (use_cached_keys,
use_cached_qc, use_cached_combined_q) restores every party's keys, runs no
block product and lands within 2e-3 of the first run
(tests/test_e2e_gwas.py:222).  The helpers here write the study's files
and config for the other test_torch_* files that drive the CLI."""

import json
import os

import numpy as np
import pytest

from sfgwas_tpu_torch import cli
from sfgwas_tpu_torch.gwas import matmult as PMM
from sfgwas_tpu_torch.mpc import mhe as PM
from test_e2e_gwas import M, N_PER, make_data, oracle_qc, oracle_stats
from test_pgen import _write_pgen

STAT_TOL, MIN_CORR, RESUME_TOL = 2e-2, 0.999, 2e-3

# tests/test_e2e_gwas.py:make_config's settings, shard_matmult off (A11)
STUDY = dict(
    num_main_parties=2, hub_party_id=1, ckks_params="TEST8", num_inds=N_PER, num_snps=M,
    num_covs=2, gmiss=0.2, maf_lb=0.05, hwe_ub=1000.0, imiss_ub=1.0, het_lb=0.0, het_ub=1.0,
    skip_pca=True, snp_dist_thres=1, shard_matmult=False,
)


def write_study(root: str) -> dict:
    """tests/test_e2e_gwas.py's make_data under root/party{1,2}, plus each
    data party's plink2 count file (gcount.bin)."""
    data = make_data(root, np.random.default_rng(99))
    for pid in (1, 2):
        g = data[pid][0]
        raw = np.zeros((6, g.shape[1]), "<u4")
        for k in range(3):
            raw[k] = (g == k).sum(0)
        raw[5] = (g < 0).sum(0)
        raw.tofile(os.path.join(root, f"party{pid}", "gcount.bin"))
    return data


def write_config(path: str, root: str, cache: str, out: str, **flags) -> str:
    """A global config for the study under root, its paths with {pid}, the
    CLI's per-party cache and output directories under cache and out."""
    p = os.path.join(root, "party{pid}")
    fields = dict(
        STUDY,
        geno_binary_file_prefix=os.path.join(p, "geno"),
        geno_block_size_file=os.path.join(p, "blocksizes.txt"),
        pheno_file=os.path.join(p, "pheno.txt"), covar_file=os.path.join(p, "cov.txt"),
        snp_position_file=os.path.join(p, "pos.txt"),
        geno_count_file=os.path.join(p, "gcount.bin"), cache_dir=cache, output_dir=out,
    )
    fields.update(flags)
    with open(path, "w") as f:
        for k, v in fields.items():
            f.write(f"{k} = {json.dumps(v)}\n")  # JSON scalars and lists are TOML
    return path


def run_cli(config: str):
    assert cli.main(["--platform", "cpu", "--local-sim", "3", "--config-global", config]) == 0


def read_run(out: str, cache: str, pid: int = 1):
    """A data party's statistics and the revealed SNP filter."""
    stats = np.loadtxt(os.path.join(out, f"party{pid}", "assoc.txt"))
    gkeep = np.loadtxt(os.path.join(cache, f"party{pid}", "gkeep.txt")).astype(bool)
    return stats, gkeep


def assert_oracle(data, out, cache):
    for pid in (1, 2):
        got, gkeep = read_run(out, cache, pid)
        want = oracle_stats(data, gkeep)
        assert got.shape == want.shape and np.isfinite(got).all()
        assert np.abs(got - want).max() < STAT_TOL
        assert np.corrcoef(got, want)[0, 1] > MIN_CORR


class _Counter:
    """Counts the calls of a module function while it is patched."""

    def __init__(self, monkeypatch, module, name):
        self.n = 0
        real = getattr(module, name)

        def counted(*a, **k):
            self.n += 1
            return real(*a, **k)

        monkeypatch.setattr(module, name, counted)


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("study"))
    return root, write_study(root)


@pytest.fixture(scope="module")
def scan_run(study):
    """A fresh run on the scan-QC route, caching its keys."""
    root, data = study
    cache, out = os.path.join(root, "cache"), os.path.join(root, "out")
    run_cli(write_config(os.path.join(root, "scan.toml"), root, cache, out,
                         use_cached_keys=True))
    return cache, out


def test_cli_scan_qc_matches_oracle(study, scan_run):
    root, data = study
    cache, out = scan_run
    assert_oracle(data, out, cache)
    for pid in (0, 1, 2):
        np.testing.assert_array_equal(read_run(out, cache, 1)[1],
                                      np.loadtxt(os.path.join(cache, f"party{pid}", "gkeep.txt")))
    np.testing.assert_array_equal(read_run(out, cache)[1], oracle_qc(data))
    # the scan's intermediate filters, and every party's key directory
    for name in ("gkeep_miss.txt", "gkeep_maf_hwe.txt", "ikeep.txt"):
        assert os.path.exists(os.path.join(cache, "party1", name))
    for pid in (0, 1, 2):
        assert os.path.exists(os.path.join(cache, f"party{pid}", "keys.npz.d", "meta.npz"))


def counts_qc_oracle(data, maf_lb, hwe_ub, gmiss):
    """Plaintext mirror of the QC from the pooled plink2 counts
    (snp_filter_with_precomputed_stats): missingness, MAF in exact
    integers (the protocol's 20-bit bound), the HWE chi-square over the
    whole cohort."""
    g = np.concatenate([data[1][0], data[2][0]])
    nonmiss = (g >= 0).sum(0)
    keep = nonmiss >= int((1 - gmiss) * len(g))
    gobs = np.stack([(g == k).sum(0) for k in range(3)]).astype(np.float64)
    s, c = gobs[1] + 2 * gobs[2], 2 * nonmiss
    bound = int(round(((2 * maf_lb - 1.0) ** 2) * (1 << 20)))
    maf_ok = np.array([int(ci) ** 2 * bound - (2 * int(si) - int(ci)) ** 2 * (1 << 20) > 0
                       for si, ci in zip(s, c)])
    b = c.astype(np.float64)
    exp = [(b - s) ** 2, 2 * s * (b - s), s ** 2]
    chi = sum((2 * b * gobs[i] - exp[i]) ** 2 / exp[i] for i in range(3))
    return keep & maf_ok & (chi < 2 * b * hwe_ub)


def test_cli_precomputed_counts_matches_oracle(study):
    """QC from the count files at a MAF bound that drops SNPs: the revealed
    filter is the plaintext one, and the statistics are those of the kept
    SNPs only (the streams are filtered as on a resume)."""
    root, data = study
    cache, out = os.path.join(root, "cache_pc"), os.path.join(root, "out_pc")
    run_cli(write_config(os.path.join(root, "pc.toml"), root, cache, out,
                         use_precomputed_geno_count=True, maf_lb=0.3))
    want = counts_qc_oracle(data, 0.3, STUDY["hwe_ub"], STUDY["gmiss"])
    assert 0 < want.sum() < M
    for pid in (1, 2):
        stats, gkeep = read_run(out, cache, pid)
        np.testing.assert_array_equal(gkeep, want)
        assert stats.shape == (want.sum(),)
    assert_oracle(data, out, cache)
    assert not os.path.exists(os.path.join(cache, "party1", "gkeep_miss.txt"))


def test_cli_resumed_run_reads_its_caches(study, scan_run, monkeypatch):
    """The same study resumed: keys, filter, basis and block products from
    the caches; no block product runs."""
    root, data = study
    cache, out = scan_run
    first = read_run(out, cache)[0]
    out2 = os.path.join(root, "out_resumed")
    mm = _Counter(monkeypatch, PMM, "mat_mult_stream")
    loads = _Counter(monkeypatch, PM, "_load_key_dir")
    run_cli(write_config(os.path.join(root, "resume.toml"), root, cache, out2,
                         use_cached_keys=True, use_cached_qc=True, use_cached_combined_q=True))
    assert mm.n == 0 and loads.n == 3
    for pid in (1, 2):
        second = read_run(out2, cache, pid)[0]
        assert second.shape == first.shape
        assert np.abs(second - first).max() < RESUME_TOL
    assert_oracle(data, out2, cache)


def test_cli_pgen_input(study, tmp_path):
    """geno_file_format = "pgen": one .pgen a chromosome (the study's two
    blocks), converted into the blocks format under the cache directory."""
    root, data = study
    for pid in (1, 2):
        g = data[pid][0]
        d = tmp_path / f"party{pid}" / "pgen"
        d.mkdir(parents=True)
        half = M // 2
        for c, blk in enumerate((g[:, :half], g[:, half:])):
            rows = np.where(blk < 0, 3, blk).T.astype(np.uint8)
            _write_pgen(str(d / f"chr{c + 1}.pgen"), rows, [0] * rows.shape[0])
    cache, out = str(tmp_path / "cache"), str(tmp_path / "out")
    run_cli(write_config(str(tmp_path / "pgen.toml"), root, cache, out, geno_file_format="pgen",
                         geno_binary_file_prefix=str(tmp_path / "party{pid}" / "pgen"),
                         geno_num_blocks=2))
    assert_oracle(data, out, cache)
    for pid in (1, 2):
        g = data[pid][0]
        conv = [np.fromfile(os.path.join(cache, f"party{pid}", f"geno_pgen.{c}.bin"), np.int8)
                for c in (0, 1)]
        np.testing.assert_array_equal(conv[0].reshape(N_PER[pid], -1), g[:, : M // 2])
        np.testing.assert_array_equal(conv[1].reshape(N_PER[pid], -1), g[:, M // 2 :])
