"""Port parity: distributed PCA of sfgwas_tpu_torch (gwas/pca.py::
distributed_pca) against sfgwas_tpu's at TEST8 on the CPU, three parties of
each package (dealer 0, data parties 1 and 2, hub 1) under the reference's
collective keys, from the same PRG keys, local generators (the sketch's
bucket and sign draws come from mpc.rand.table[pid]) and encryption
generators (the harness of tests/test_torch_assoc.py).

2 PCs with 2 oversampling columns (kp 4), 2 power iterations, cholqr2, 2
shifted-QR iterations an eigenvalue, 12
and 8 individuals over 140 SNPs (two 128-slot blocks of X^T): every
ciphertext of the port's Qpc, with host-streamed diagonal caches split into
many MAC launches, must be bit-equal to the reference's (device-resident
caches), with the same level and scale.  The decrypted QmulB_<it>.txt dumps and
Qpc.txt of the two packages must be equal, and the restart branch
(restart_pca_from_iter, which runs a QR on the dump before the remaining
iterations) bit-equal from the reference's dumps.  The decrypted PCs span
the top two PCs of the standardised pooled matrix, whose population
structure gives them a clear eigengap."""

import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest

from sfgwas_tpu.gwas import pca as RP
from sfgwas_tpu.gwas import utilities as RU
from sfgwas_tpu_torch.gwas import pca as PP
from sfgwas_tpu_torch.gwas import utilities as PU
from test_torch_assoc import ref_keys, run, assert_same_cts, flat  # noqa: F401

from test_torch_householder_band import ref_householder_repaired  # noqa: F401

# the port's Householder brings x to unit scale first (ROADMAP C): the JAX
# package's runs with the same repair here
pytestmark = pytest.mark.usefixtures("ref_householder_repaired")

# n m = 2800 keeps the Gram unscaled (gram_scale 1 at kp 4), as the JAX package runs it
NROWS = [0, 12, 8]
NSNP = 140
NPC, NOVER, NITER = 2, 2, 2
EIG_ITERS = 2  # iter_per_eigenval (test_torch_linalg.py runs the default 5)
MOD = {"ref": (RP, RU), "port": (PP, PU)}


def structured_genotypes(rng, n: int, m: int, npop: int = 3, fst: float = 0.1):
    """n x m int8 dosages of npop subpopulations with Balding-Nichols allele
    frequencies at F_ST = fst; returns (genotypes, subpopulation labels)."""
    p = rng.uniform(0.1, 0.5, size=m)
    a = p * (1 - fst) / fst
    b = (1 - p) * (1 - fst) / fst
    freqs = rng.beta(a, b, size=(npop, m))
    lab = rng.integers(0, npop, size=n)
    f = freqs[lab]
    g = (rng.uniform(size=(n, m)) < f).astype(np.int8) + (rng.uniform(size=(n, m)) < f)
    return g.astype(np.int8), lab


def genotypes():
    g, _ = structured_genotypes(np.random.default_rng(31), sum(NROWS), NSNP, fst=0.2)
    return g


def _split(pid):
    return slice(0, NROWS[1]) if pid == 1 else slice(NROWS[1], sum(NROWS))


def pca_body(root: str, tag: str, niter: int = NITER, **kw):
    """distributed_pca at every party, each with its own cache prefix under
    root/tag; each data party decrypts and saves its rows of Qpc."""
    g = genotypes()

    def body(mpc, cps, m):
        P, U = MOD["port" if m["S"].__name__.startswith("sfgwas_tpu_torch") else "ref"]
        pid = mpc.pid
        d = os.path.join(root, tag)
        os.makedirs(d, exist_ok=True)
        X = g[_split(pid)] if pid > 0 else None
        qpc = P.distributed_pca(mpc, cps, X, NSNP, NROWS, NPC, NOVER, niter,
                                cache_prefix=os.path.join(d, f"p{pid}_pca"),
                                iter_per_eigenval=EIG_ITERS, **kw)
        if pid == 0:
            assert qpc == [None] * NPC
            return None
        for p in (1, 2):
            U.save_matrix_collective(mpc.net, cps, qpc, NROWS[p], p,
                                     os.path.join(d, f"p{pid}_Qpc.txt"))
        return flat(qpc)

    return body


@pytest.fixture(scope="module")
def runs(ref_keys, tmp_path_factory):
    """The fresh runs, with the per-iteration dumps, of the reference
    (device-resident caches: its budget of 6 GiB) and of the port with a
    budget of 0 bytes, so that its caches are host-streamed, in 64 KiB MAC
    launch groups.  (The port's device-resident path is held to the
    reference by tests/test_torch_pca_stream.py and the CLI study.)"""
    root = str(tmp_path_factory.mktemp("pca"))
    out = {"root": root}
    out["ref"] = run("ref", ref_keys, pca_body(root, "ref", debug=True))
    out["port"] = run("port", ref_keys, pca_body(root, "port", debug=True, device_budget=0,
                                                 group_bytes=64 << 10))
    return out


def test_qpc_ciphertexts_match_reference(runs):
    for pid in (1, 2):
        assert len(runs["ref"][pid]) == NPC * 1
        assert_same_cts(runs["ref"][pid], runs["port"][pid])


def test_port_caches_took_the_host_streamed_path(runs):
    """The port's caches were spilled beside its cache prefix (X: one block
    row of two blocks; X^T: two block rows of one), the reference's not;
    the Gram went unscaled."""
    root = runs["root"]
    assert PP.gram_scale(SimpleNamespace(data_bits=60, frac_bits=30), sum(NROWS), NSNP,
                         NPC + NOVER) == 1
    for pid in (1, 2):
        for name in ("x.npz.w0_0", "x.npz.w0_128", "xt.npz.w0_0", "xt.npz.w128_0"):
            assert os.path.exists(os.path.join(root, "port", f"p{pid}_pca_{name}.meta.npz"))
            assert not os.path.exists(os.path.join(root, "ref", f"p{pid}_pca_{name}.meta.npz"))


def test_decrypted_dumps_and_qpc_files_equal(runs):
    root = runs["root"]
    for pid in (1, 2):
        names = [f"p{pid}_Qpc.txt"] + [f"p{pid}_pca_QmulB_{it}.txt" for it in range(NITER)]
        for name in names:
            with open(os.path.join(root, "ref", name)) as f:
                want = f.read()
            with open(os.path.join(root, "port", name)) as f:
                assert f.read() == want, name


def test_qpc_spans_top_pcs(runs):
    """Each of the top two PCs of the standardised pooled matrix lies in
    span(Qpc) with |cos| >= 0.9 (TEST8's 3-level chain, 2 iterations)."""
    root = runs["root"]
    g = genotypes().astype(float)
    gs = (g - g.mean(0)) / np.maximum(g.std(0), 1e-9)
    u, sv, _ = np.linalg.svd(gs, full_matrices=False)
    assert sv[1] / sv[2] > 1.2, sv[:4]
    q = np.concatenate([PU.load_matrix_float(os.path.join(root, "port", f"p{p}_Qpc.txt")).T
                        for p in (1, 2)])
    assert np.isfinite(q).all() and q.shape == (sum(NROWS), NPC)
    basis, _ = np.linalg.qr(q)
    for k in range(2):
        cos = np.linalg.norm(basis.T @ u[:, k])
        assert cos >= 0.9, (k, cos)


def test_restart_from_reference_dumps(runs, ref_keys, tmp_path):
    """restart_pca_from_iter = 1 of 3 iterations: both packages read the
    reference's QmulB_1 dump, run a QR on it and the last iteration; the
    Qpc ciphertexts are bit-equal.  The reference's dealer resumes only if
    a dump file exists under its own prefix (it never writes one), so its
    run gets an empty one; the port's dealer follows the data parties."""
    got = {}
    for pkg in ("ref", "port"):
        d = tmp_path / pkg
        shutil.copytree(os.path.join(runs["root"], "ref"), d)
        if pkg == "ref":
            (d / "p0_pca_QmulB_1.txt").write_text("")
        got[pkg] = run(pkg, ref_keys, pca_body(str(tmp_path), pkg, niter=3, restart_iter=1))
    for pid in (1, 2):
        assert_same_cts(got["ref"][pid], got["port"][pid])
        # the restart read the dump: its result differs from the fresh run's
        assert any(not np.array_equal(a[0], b[0]) for a, b in zip(got["port"][pid],
                                                                  runs["port"][pid]))
