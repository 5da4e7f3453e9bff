"""The PCA Gram's range in the SS eigensolver: the JAX package's fault at
the example's scale and the port's repair (gwas/pca.py::gram_scale).

distributed_pca hands the eigensolver Z = Q Q^T / n, whose top eigenvalue
is sigma_1^4 / (n m) for the standardised n x m genotypes: ~1.8e4 at the
example's n = 2000, m = 10,000 (chip_smoke.py phase 12).  The fixed-point
eigensolver (60 data bits, 30 fraction bits) overflows there: its revealed
eigenvalues are ~1e59 and the PCs noise.  The port divides Z by a public
power of two (the eigenvectors and their order do not change) whenever n m
could put the top eigenvalue out of range, and leaves it as it is
otherwise, so that small studies stay bit-equal to the JAX package.

- The rule: 1 at the parity tests' sizes, 2^14 at the example's.
- The eigensolver of both packages (bit-equal shares) on a 4 x 4 Gram with
  eigenvalues of the example's size and on the same Gram divided by the
  rule's c: the top two eigenvalues within 3e-2 relative, their
  eigenvectors numpy's, the others within 3e-2 of the top.  Both run the
  Householder at unit scale (mpc/linalg.py::unit_scale, ROADMAP C), which
  keeps its square roots in range at the unscaled Gram too; the JAX
  package's own Householder gives garbage there (the fault, which needs no
  preset to show: its vector's squared norm leaves the square root's 60
  data bits).
- The port's distributed_pca at TEST8 with 2 x 100 individuals over 300
  SNPs of two separated subpopulations (n m = 60,000, so the Gram enters
  the eigensolver divided by 32): its PCs span the top PC at |cos| >=
  0.9.  (TEST8's data cannot reach the example's eigenvalues: they are at
  most n m.)"""

from types import SimpleNamespace

import numpy as np
import pytest

from sfgwas_tpu_torch.gwas import pca as PP
from test_torch_assoc import ref_keys, run  # noqa: F401
from sfgwas_tpu.mpc import linalg as RL
from test_torch_householder_band import REF_HOUSEHOLDER, ref_householder_repaired  # noqa: F401
from test_torch_mpc import REF, _both, fxp, tofloat
from test_torch_pca import structured_genotypes

# the port's Householder brings x to unit scale first (ROADMAP C): the JAX
# package's runs with the same repair here
pytestmark = pytest.mark.usefixtures("ref_householder_repaired")

SS = SimpleNamespace(data_bits=60, frac_bits=30)


def test_gram_scale_rule():
    assert PP.gram_scale(SS, 20, 140, 4) == 1  # tests/test_torch_pca.py
    assert PP.gram_scale(SS, 44, 48, 5) == 1  # tests/test_torch_pca_study.py
    assert PP.gram_scale(SS, 2000, 10_000, 15) == 2 ** 14  # the example, phase 12
    assert PP.gram_scale(SS, 200, 300, 4) == 2 ** 5


LAM = np.array([17640.0, 9000.0, 650.0, 100.0])  # the example's size (phase 12)


def _gram():
    U = np.linalg.qr(np.random.default_rng(3).normal(size=(4, 4)))[0]
    return U, U @ np.diag(LAM) @ U.T


@pytest.mark.parametrize("c", [1.0, float(PP.gram_scale(SS, 2000, 10_000, 4))])
def test_eigensolver_range(c, monkeypatch):
    U, Z = _gram()
    A = Z / c

    def case(mpc, M):
        sh = M.S.make_shares(mpc, [fxp(v) for v in A.reshape(-1)]).reshape(4, 4, -1)
        V, L = M.linalg.eigen_decomp(mpc, sh)
        V, L = M.linalg.sort_rows_descend(mpc, V, L)
        return V, L, M.S.reveal_ints(mpc, L), M.S.reveal_ints(mpc, V.reshape(16, -1))

    res = _both(case)[1]
    L = np.array([tofloat(v) for v in res[2]]) * c
    V = np.array([tofloat(v) for v in res[3]]).reshape(4, 4)
    assert np.allclose(L[:2], LAM[:2], rtol=3e-2), L
    assert np.allclose(L, LAM, atol=3e-2 * LAM[0]), L
    for k in range(2):
        assert abs(V[k] @ U[:, k]) > 0.99, k
    if c == 1:  # the JAX package's own Householder overflows there
        monkeypatch.setattr(RL, "householder", REF_HOUSEHOLDER)

        def ref(mpc):
            mpc.rand.table[mpc.pid] = np.random.Generator(np.random.Philox(key=[7, mpc.pid]))
            return case(mpc, REF)

        L = np.array([tofloat(v) for v in REF.S.run_parties(3, ref)[1][2]])
        assert np.abs(L).max() > 1e20, L


NROWS = [0, 100, 100]
NSNP = 300


def _genotypes():
    g, _ = structured_genotypes(np.random.default_rng(8), sum(NROWS), NSNP, npop=2, fst=0.3)
    return g


def _pca_body(mpc, cps, m):
    g = _genotypes()
    pid = mpc.pid
    X = g[: NROWS[1]] if pid == 1 else g[NROWS[1]:] if pid == 2 else None
    qpc = PP.distributed_pca(mpc, cps, X, NSNP, NROWS, 2, 2, 2, iter_per_eigenval=2)
    if pid == 0:
        return None
    # every data party's rows, decrypted collectively
    out = []
    for p in (1, 2):
        cts = [ct for row in qpc for ct in row] if pid == p else [None] * 2
        pts = m["M"].collective_decrypt_many(mpc.net, cps, cts, p)
        out.append(np.stack([np.asarray(cps.ctx.decode(pt))[: NROWS[p]] for pt in pts]).T)
    return np.concatenate(out)


def test_port_pcs_span_the_top_pc_with_a_scaled_gram(ref_keys):
    assert PP.gram_scale(SS, sum(NROWS), NSNP, 4) == 32
    g = _genotypes().astype(float)
    gs = (g - g.mean(0)) / np.maximum(g.std(0), 1e-9)
    u = np.linalg.svd(gs, full_matrices=False)[0]
    port = run("port", ref_keys, _pca_body)
    for pid in (1, 2):
        q = port[pid]
        assert q.shape == (sum(NROWS), 2) and np.isfinite(q).all()
        assert np.linalg.norm(np.linalg.qr(q)[0].T @ u[:, 0]) >= 0.9

