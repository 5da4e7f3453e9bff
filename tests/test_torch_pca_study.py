"""The port's study with PCA through its CLI (sfgwas_tpu_torch/cli.py,
--local-sim 3 on the CPU at TEST8): tests/test_e2e_gwas.py's data (24 and
20 individuals, 50 SNPs in 2 blocks with 2% missing calls, 2 covariates)
with config/configGlobal.toml's route (QC from the plink2 counts, cached
keys, PCA with cholqr2) and tests/test_e2e_gwas.py:make_config's PCA sizes
(2 PCs, 3 oversampling columns, 6 power iterations).

Held as tests/test_e2e_gwas.py:325-357 holds the reference: the statistics
correlate above 0.9 with the oracle on the exact top-2 PCs of the
standardised pooled matrix, and a run resumed from the decrypted PCs
(use_cached_pca, with the QC, basis and key caches) lies within 2e-2 of the
fresh one.  Beside that, the statistics lie within 2e-2 (corr > 0.999) of
the oracle that residualises on [1 | covariates | the run's own decrypted
PCs], and the study with qr_method = "householder" (the Householder QR
at every PCA QR and at the covariate basis) runs with PCs that span the
top two."""

import os

import numpy as np
import pytest

from sfgwas_tpu_torch.gwas import pca as PP
from test_torch_protocol import (
    STUDY, _Counter, counts_qc_oracle, read_run, run_cli, write_config, write_study,
)
from test_e2e_gwas import oracle_stats

NPC = 2
PCA = dict(skip_pca=False, use_precomputed_geno_count=True, use_cached_keys=True,
           num_pcs_to_remove=NPC, num_oversampling=3, num_power_iters=6)
STAT_TOL, MIN_CORR, EXACT_PCA_CORR, RESUME_TOL = 2e-2, 0.999, 0.9, 2e-2


@pytest.fixture(scope="module")
def fresh(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pca_study"))
    data = write_study(root)
    cache, out = os.path.join(root, "cache"), os.path.join(root, "out")
    run_cli(write_config(os.path.join(root, "pca.toml"), root, cache, out, **PCA))
    return root, data, cache, out


def _qpc(cache):
    """The data parties' decrypted PCs, stacked: [24 + 20, NPC]."""
    return np.concatenate([np.loadtxt(os.path.join(cache, f"party{p}", "Qpc.txt"),
                                      delimiter=",", ndmin=2).T for p in (1, 2)])


def test_filter_and_pcs(fresh):
    root, data, cache, out = fresh
    want = counts_qc_oracle(data, STUDY["maf_lb"], STUDY["hwe_ub"], STUDY["gmiss"])
    for pid in (1, 2):
        np.testing.assert_array_equal(read_run(out, cache, pid)[1], want)
    q = _qpc(cache)
    assert q.shape == (24 + 20, NPC) and np.isfinite(q).all()
    assert os.path.exists(os.path.join(cache, "party0", "Qpc.done"))


def test_stats_correlate_with_exact_pca_oracle(fresh):
    """tests/test_e2e_gwas.py:331-344."""
    root, data, cache, out = fresh
    for pid in (1, 2):
        got, gk = read_run(out, cache, pid)
        G = np.concatenate([data[1][0], data[2][0]], axis=0).astype(float)
        Gq = G[:, gk]
        Gs = (Gq - Gq.mean(0)) / np.maximum(Gq.std(0), 1e-9)
        _, _, vt = np.linalg.svd(Gs, full_matrices=False)
        want = oracle_stats(data, gk, pcs=Gs @ vt[:NPC].T)
        assert got.shape == want.shape
        assert np.corrcoef(got, want)[0, 1] > EXACT_PCA_CORR


def test_stats_match_oracle_on_the_runs_pcs(fresh):
    root, data, cache, out = fresh
    q = _qpc(cache)
    for pid in (1, 2):
        got, gk = read_run(out, cache, pid)
        want = oracle_stats(data, gk, pcs=q)
        assert got.shape == want.shape and np.isfinite(got).all()
        assert np.abs(got - want).max() < STAT_TOL
        assert np.corrcoef(got, want)[0, 1] > MIN_CORR


def test_resume_from_cached_pcs(fresh, monkeypatch):
    """tests/test_e2e_gwas.py:346-357: use_cached_pca (with the QC, basis
    and key caches) runs no PCA and lands within 2e-2 of the fresh run."""
    root, data, cache, out = fresh
    out2 = os.path.join(root, "out_resumed")
    pca = _Counter(monkeypatch, PP, "distributed_pca")
    run_cli(write_config(os.path.join(root, "resume.toml"), root, cache, out2, **PCA,
                         use_cached_pca=True, use_cached_qc=True, use_cached_combined_q=True))
    assert pca.n == 0
    for pid in (1, 2):
        first, second = read_run(out, cache, pid)[0], read_run(out2, cache, pid)[0]
        assert second.shape == first.shape
        assert np.abs(second - first).max() < RESUME_TOL


def test_householder_qr_is_not_ported(fresh, tmp_path):
    """Householder is ported now (the name is kept from when this test held
    that it raised): the study with qr_method = "householder", whose every
    PCA QR and covariate basis is net_dqr_enc, runs through the CLI, each of
    the top two PCs of the standardised pooled matrix lies in span(Qpc) with
    |cos| >= 0.9 (as tests/test_torch_pca.py::test_qpc_spans_top_pcs
    requires), and the statistics meet the oracle on the run's own PCs."""
    root, data, _, _ = fresh
    cache, out = str(tmp_path / "cache"), str(tmp_path / "out")
    run_cli(write_config(str(tmp_path / "hh.toml"), root, cache, out, **PCA,
                         qr_method="householder"))
    q = _qpc(cache)
    assert q.shape == (24 + 20, NPC) and np.isfinite(q).all()
    basis, _ = np.linalg.qr(q)
    for pid in (1, 2):
        got, gk = read_run(out, cache, pid)
        G = np.concatenate([data[1][0], data[2][0]], axis=0).astype(float)[:, gk]
        Gs = (G - G.mean(0)) / np.maximum(G.std(0), 1e-9)
        u, _, _ = np.linalg.svd(Gs, full_matrices=False)
        for k in range(NPC):
            assert np.linalg.norm(basis.T @ u[:, k]) >= 0.9, (pid, k)
        want = oracle_stats(data, gk, pcs=q)
        assert got.shape == want.shape and np.isfinite(got).all()
        assert np.abs(got - want).max() < STAT_TOL
        assert np.corrcoef(got, want)[0, 1] > MIN_CORR
