"""Port parity: the linear association statistics of sfgwas_tpu_torch
(gwas/assoc.py::get_association_stats) against sfgwas_tpu's at TEST8 on
the CPU, three parties of each package (dealer 0, data parties 1 and 2, hub
1) on tests/test_e2e_gwas.py's shape: 24 and 20 individuals, 50 SNPs in 2
blocks of genotype files with missing calls (read as dosage 0), 2
covariates.  Both packages run under the reference's collective keys, from
the same PRG keys and generators (the harness of tests/test_torch_assoc.py):
every output ciphertext bit-equal to the reference's, with the same level
and scale, the same SNP filter, and the decrypted statistics within 2e-2
and corr > 0.999 of the plaintext oracle.  The ciphertext caches the
reference writes (the combined basis and each block's product) are the
port's byte for byte, and the port reads the reference's under a key
bundle restored from a key cache."""

import os

import numpy as np
import pytest

from sfgwas_tpu.gwas import filestream as RF
from sfgwas_tpu_torch.gwas import filestream as PF
from test_torch_assoc import ref_keys, run, assert_same_cts, flat  # noqa: F401

N_PER = [0, 24, 20]
M = 50
NCOV = 2


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """tests/test_e2e_gwas.py's make_data: per data party, genotypes (2%
    missing), a phenotype with two planted effects and 2 covariates; the
    genotypes as two block files."""
    d = tmp_path_factory.mktemp("assoc")
    rng = np.random.default_rng(99)
    out = {}
    for pid in (1, 2):
        n = N_PER[pid]
        maf = rng.uniform(0.2, 0.5, size=M)
        g = (rng.uniform(size=(n, M)) < maf).astype(np.int8) + (
            rng.uniform(size=(n, M)) < maf).astype(np.int8)
        pheno = rng.normal(size=n) + 0.3 * g[:, 0] + 0.2 * g[:, 3]
        g[rng.uniform(size=(n, M)) < 0.02] = -1
        cov = rng.normal(size=(n, NCOV))
        half = M // 2
        files = []
        for b, blk in enumerate((g[:, :half], g[:, half:])):
            path = str(d / f"p{pid}_geno.{b}.bin")
            PF.write_geno_file(path, blk)
            files.append((path, blk.shape))
        out[pid] = (g, pheno, cov, files)
    return d, out


def oracle_stats(data):
    """tests/test_e2e_gwas.py's oracle: the Pearson statistic of each SNP
    against the phenotype, both projected off [ones | covariates]."""
    G = np.concatenate([data[1][0], data[2][0]]).astype(float)
    y = np.concatenate([data[1][1], data[2][1]])
    C = np.concatenate([data[1][2], data[2][2]])
    G[G < 0] = 0.0
    Qm, _ = np.linalg.qr(np.column_stack([np.ones(len(y)), C]))
    yt = y - Qm @ (Qm.T @ y)
    Gt = G - Qm @ (Qm.T @ G)
    return (yt @ G) / np.sqrt((Gt * Gt).sum(0)) / np.sqrt(yt @ yt)


def _stats_body(data, cache_prefix=None, use_cached_combined_q=False):
    def body(mpc, cps, m):
        pid = mpc.pid
        if pid > 0:
            g, pheno, cov, files = data[pid]
            FS = RF if m["S"].__name__.startswith("sfgwas_tpu.") else PF
            streams = [FS.GenoFileStream(path, *shape, replace_missing=True)
                       for path, shape in files]
            blocks = [FS.LazyBlock(s) for s in streams]
            prefix = f"{cache_prefix}_p{pid}" if cache_prefix else None
            stats, filt = m["A"].get_association_stats(
                mpc, cps, blocks, pheno, cov, None, N_PER, cache_prefix=prefix,
                use_cached_combined_q=use_cached_combined_q)
        else:
            stats, filt = m["A"].get_association_stats(
                mpc, cps, None, None, NCOV, None, N_PER, cache_prefix=None,
                use_cached_combined_q=use_cached_combined_q)
            return None
        pts = m["M"].collective_decrypt_many(mpc.net, cps, stats, -1)
        vals = np.concatenate([cps.ctx.decode(pt) for pt in pts])[: len(filt)][filt]
        return {"stats": flat(stats), "filt": filt, "vals": vals}

    return body


@pytest.fixture(scope="module")
def stats(ref_keys, data):
    """One run of each package, each writing its ciphertext caches (keys
    restored from a key cache, so the caches are written to be read)."""
    d, dd = data
    ref = run("ref", ref_keys, _stats_body(dd, str(d / "ref")), keys_from_cache=True)
    port = run("port", ref_keys, _stats_body(dd, str(d / "port")), keys_from_cache=True)
    return ref, port


def test_association_stats_match_reference(stats):
    ref, port = stats
    for pid in (1, 2):
        assert_same_cts(ref[pid]["stats"], port[pid]["stats"])
        np.testing.assert_array_equal(port[pid]["filt"], ref[pid]["filt"])
        assert int(port[pid]["filt"].sum()) == M


def test_association_stats_match_oracle(stats, data):
    want = oracle_stats(data[1])
    for pid in (1, 2):
        got = stats[1][pid]["vals"]
        assert got.shape == want.shape and np.isfinite(got).all()
        assert np.abs(got - want).max() < 2e-2
        assert np.corrcoef(got, want)[0, 1] > 0.999


def test_cache_files_match_reference(stats, data):
    """The basis and block-product caches of both packages: the same files,
    the same arrays (uint32 residues, float64 metadata and dosage sums)."""
    d = data[0]
    names = sorted(f[len("ref"):] for f in os.listdir(d) if f.startswith("ref_"))
    assert len(names) == 2 * 3  # per data party: the basis and 2 blocks
    for name in names:
        with np.load(d / f"ref{name}") as zr, np.load(d / f"port{name}") as zp:
            assert sorted(zr.files) == sorted(zp.files), name
            for k in zr.files:
                assert zr[k].dtype == zp[k].dtype, (name, k)
                np.testing.assert_array_equal(zp[k], zr[k])


def test_cached_run_reads_reference_caches(ref_keys, stats, data):
    """With keys_from_cache and use_cached_combined_q, both packages read
    the reference's caches (the basis and every block's product) and give
    the same ciphertexts, which decrypt to the oracle's statistics."""
    d, dd = data
    body = _stats_body(dd, str(d / "ref"), use_cached_combined_q=True)
    before = {f: os.path.getmtime(d / f) for f in os.listdir(d) if f.startswith("ref_")}
    ref = run("ref", ref_keys, body, keys_from_cache=True)
    port = run("port", ref_keys, body, keys_from_cache=True)
    after = {f: os.path.getmtime(d / f) for f in os.listdir(d) if f.startswith("ref_")}
    assert after == before  # every cache was a hit: nothing rewritten
    want = oracle_stats(dd)
    for pid in (1, 2):
        assert_same_cts(ref[pid]["stats"], port[pid]["stats"])
        got = port[pid]["vals"]
        assert np.abs(got - want).max() < 2e-2
        assert np.corrcoef(got, want)[0, 1] > 0.999
