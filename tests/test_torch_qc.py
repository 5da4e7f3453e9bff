"""Port parity: quality control (gwas/qc.py) of sfgwas_tpu_torch against
sfgwas_tpu's, three parties of each package (dealer 0, data parties 1 and
2, hub 1) on the host SS engine with the same PRG keys: the revealed SNP
filter of snp_filter_with_precomputed_stats equal to the reference's and to
a plaintext oracle of the same counts, also when MAX_WINDOW splits the SNP
axis into windows with cache files (the port reading the reference's
caches), and the party-local individual filters."""

import numpy as np
import pytest

from sfgwas_tpu.gwas import filestream as RF
from sfgwas_tpu.gwas import qc as RQC
from sfgwas_tpu.gwas.params import FilterParams as RefFilterParams
from sfgwas_tpu.parallel import simulate as RS
from sfgwas_tpu_torch.gwas import filestream as PF
from sfgwas_tpu_torch.gwas import qc as PQC
from sfgwas_tpu_torch.gwas.params import FilterParams
from sfgwas_tpu_torch.parallel import simulate as PS

M = 60
N_PER = (0, 40, 30)
# maf_lower, hwe_upper, geno_miss, ind_miss, het_lower, het_upper: the
# missingness bound drops the SNPs with many missing calls, the MAF bound
# the rare ones, the HWE bound those drawn far out of equilibrium
FP = (0.1, 10.0, 0.1, 0.5, 0.2, 0.6)


def _genotypes(pid: int):
    """Party pid's genotypes (-1 missing): MAF uniform in [0.02, 0.5], a
    few SNPs with 15% missing calls and a few out of Hardy-Weinberg
    equilibrium (no heterozygotes)."""
    rng = np.random.default_rng(20 + pid)
    n = N_PER[pid]
    maf = np.random.default_rng(19).uniform(0.02, 0.5, size=M)
    g = rng.binomial(2, maf[None, :], size=(n, M)).astype(np.int8)
    hom = np.random.default_rng(18).choice(M, 4, replace=False)
    g[:, hom] = 2 * (rng.uniform(size=(n, 4)) < 0.5)
    g[rng.uniform(size=(n, M)) < 0.01] = -1
    for j in np.random.default_rng(17).choice(M, 3, replace=False):
        g[rng.uniform(size=n) < 0.15, j] = -1
    return g


def _counts(pid: int):
    """The plink2 count layout's ac [2, m], gc [3, m], miss [m] (zeros at
    party 0)."""
    if pid == 0:
        return np.zeros((2, M), np.int64), np.zeros((3, M), np.int64), np.zeros(M, np.int64)
    g = _genotypes(pid)
    gc = np.stack([(g == k).sum(0) for k in range(3)]).astype(np.int64)
    ac = np.stack([gc[1] + 2 * gc[0], gc[1] + 2 * gc[2]])
    return ac, gc, (g < 0).sum(0).astype(np.int64)


def qc_oracle(counts, fp, total_inds: int):
    """Plaintext mirror of snp_filter_with_precomputed_stats: missingness,
    then MAF (exact integers) and HWE (chi-square in floats; the data keep
    clear of its bound) over the pooled counts."""
    maf_lower, hwe_upper, geno_miss = fp[:3]
    nonmiss = sum(N_PER[p] - counts[p][2] for p in (1, 2))
    keep = nonmiss >= int((1 - geno_miss) * total_inds)
    s = sum(counts[p][0][1] for p in (1, 2))
    c = 2 * nonmiss
    bound = int(round(((2 * maf_lower - 1.0) ** 2) * (1 << 20)))
    maf_ok = np.array([int(ci) ** 2 * bound - (2 * int(si) - int(ci)) ** 2 * (1 << 20) > 0
                       for si, ci in zip(s, c)])
    gobs = sum(counts[p][1] for p in (1, 2)).astype(np.float64)
    a, b = s.astype(np.float64), c.astype(np.float64)
    exp = [(b - a) ** 2, 2 * a * (b - a), a ** 2]
    chi = sum((2 * b * gobs[i] - exp[i]) ** 2 / exp[i] for i in range(3))
    return keep & maf_ok & (chi < 2 * b * hwe_upper)


def _qc(pkg, cache_prefix=None):
    S, QC, Fp = (RS, RQC, RefFilterParams) if pkg == "ref" else (PS, PQC, FilterParams)
    fp = Fp(*FP)

    def body(mpc):
        mpc.rand.table[mpc.pid] = np.random.Generator(np.random.Philox(key=[9, mpc.pid]))
        ac, gc, miss = _counts(mpc.pid)
        prefix = f"{cache_prefix}_p{mpc.pid}" if cache_prefix else None
        return QC.snp_filter_with_precomputed_stats(
            mpc, ac, gc, miss, N_PER[mpc.pid], sum(N_PER), fp, cache_prefix=prefix)

    return S.run_parties(3, body)


@pytest.fixture(scope="module")
def filters():
    return _qc("ref"), _qc("port")


def test_snp_filter_matches_reference_and_oracle(filters):
    ref, port = filters
    want = qc_oracle({p: _counts(p) for p in (1, 2)}, FP, sum(N_PER))
    assert 0 < want.sum() < M - 8, want.sum()  # every filter drops SNPs
    for pid in (1, 2):
        assert port[pid].dtype == bool and port[pid].shape == (M,)
        np.testing.assert_array_equal(port[pid], ref[pid])
        np.testing.assert_array_equal(port[pid], want)
    assert not port[0].any()


def test_snp_filter_windows_and_caches(monkeypatch, tmp_path, filters):
    """Windows of 25 SNPs (three, the last short): the same filter; the
    reference's window cache files, read by the port, replace every
    window's MPC."""
    for mod in (RQC, PQC):
        monkeypatch.setattr(mod, "MAX_WINDOW", 25)
    prefix = str(tmp_path / "qc")
    ref = _qc("ref", prefix)
    assert len(list(tmp_path.glob("qc_p1_qcwin_*.npy"))) == 3
    fresh = []
    real = PQC.snp_miss_filter

    def counting(mpc, *a, **k):
        fresh.append(mpc.pid)
        return real(mpc, *a, **k)

    monkeypatch.setattr(PQC, "snp_miss_filter", counting)
    cached = _qc("port", prefix)
    assert fresh == []
    uncached = _qc("port", str(tmp_path / "fresh"))
    assert sorted(set(fresh)) == [0, 1, 2] and len(fresh) == 9
    for pid in (1, 2):
        for got in (ref[pid], cached[pid], uncached[pid]):
            np.testing.assert_array_equal(got, filters[1][pid])


def test_individual_miss_het_filters(tmp_path):
    # individual missingness 0.1 and heterozygosity in (0.25, 0.45): three
    # individuals lose a fifth of their calls
    ifp = FP[:3] + (0.1, 0.25, 0.45)
    fp, rfp = FilterParams(*ifp), RefFilterParams(*ifp)
    g = _genotypes(1)
    g[:3, : M // 5] = -1
    half = M // 2
    streams = {}
    for i, blk in enumerate((g[:, :half], g[:, half:])):
        path = str(tmp_path / f"geno.{i}.bin")
        PF.write_geno_file(path, blk)
        streams.setdefault("ref", []).append(
            RF.GenoFileStream(path, blk.shape[0], blk.shape[1], replace_missing=False))
        streams.setdefault("port", []).append(
            PF.GenoFileStream(path, blk.shape[0], blk.shape[1], replace_missing=False))
    got = PQC.individual_miss_het_filters(streams["port"], M, fp)
    want = RQC.individual_miss_het_filters(streams["ref"], M, rfp)
    np.testing.assert_array_equal(got, want)
    miss = (g < 0).sum(1)
    het = (g == 1).sum(1) / np.maximum(M - miss, 1)
    np.testing.assert_array_equal(
        got, (miss / M < ifp[3]) & (het < ifp[5]) & (het > ifp[4]))
    assert 0 < got.sum() < len(got)
