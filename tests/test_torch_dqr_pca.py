"""Port parity: distributed PCA with qr_method = "householder" (every QR of
the power iterations is gwas/qrfact.py::net_dqr_enc) against sfgwas_tpu's
at TEST8 on the CPU: tests/test_torch_pca.py's study (kp 4, 12 and 8
individuals over 140 SNPs, 2 power iterations, so two Householder QRs of 4
columns each: the initial one and the first iteration's), its harness and
its keys.

PCA hands the QR columns below the QR band.  The JAX package's net_dqr_enc
clamps its input with drop_to(ct, band), which fails on such a column (its
net_cholqr_enc clamps down only); the port clamps down only.  So the
reference runs here with drop_to made a clamp-down (a drop below a
ciphertext's own level becomes no drop), which every other drop_to call
of the run leaves as it was.  Every ciphertext of Qpc must be bit-equal to the reference's,
with the same level and scale, the decrypted Qpc.txt files equal, and the
PCs span the top two PCs of the standardised pooled matrix."""

import os

import numpy as np
import pytest

from sfgwas_tpu.crypto import ckks as RC
from sfgwas_tpu.gwas import qrfact as RQ
from sfgwas_tpu_torch.gwas import qrfact as PQ
from sfgwas_tpu_torch.gwas import utilities as PU
from test_torch_assoc import assert_same_cts, ref_keys, run  # noqa: F401
from test_torch_pca import NPC, NROWS, genotypes, pca_body

from test_torch_householder_band import ref_householder_repaired  # noqa: F401

# the port's Householder brings x to unit scale first (ROADMAP C): the JAX
# package's runs with the same repair here
pytestmark = pytest.mark.usefixtures("ref_householder_repaired")


class _Calls:
    """Counts one module's net_dqr_enc calls."""

    def __init__(self, mp, mod):
        self.n, orig = 0, mod.net_dqr_enc

        def wrapped(*a, **k):
            self.n += 1
            return orig(*a, **k)

        mp.setattr(mod, "net_dqr_enc", wrapped)


@pytest.fixture(scope="module")
def runs(ref_keys, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pca_hh"))
    out = {"root": root}
    with pytest.MonkeyPatch.context() as mp:
        calls = {"ref": _Calls(mp, RQ), "port": _Calls(mp, PQ)}
        drop = RC.CkksContext.drop_to
        mp.setattr(RC.CkksContext, "drop_to", lambda self, ct, n: drop(self, ct, min(n, ct.nmod)))
        for pkg in ("ref", "port"):
            out[pkg] = run(pkg, ref_keys, pca_body(root, pkg, qr_method="householder"))
    out["calls"] = {k: c.n for k, c in calls.items()}
    return out


def test_qpc_ciphertexts_match_reference(runs):
    # two QRs, each run by all three parties
    assert runs["calls"] == {"ref": 6, "port": 6}
    for pid in (1, 2):
        assert len(runs["port"][pid]) == NPC
        assert_same_cts(runs["ref"][pid], runs["port"][pid])
        with open(os.path.join(runs["root"], "ref", f"p{pid}_Qpc.txt")) as f:
            want = f.read()
        with open(os.path.join(runs["root"], "port", f"p{pid}_Qpc.txt")) as f:
            assert f.read() == want


def test_qpc_spans_top_pcs(runs):
    """As tests/test_torch_pca.py holds the cholqr2 run: each of the top two
    PCs lies in span(Qpc) with |cos| >= 0.9."""
    g = genotypes().astype(float)
    gs = (g - g.mean(0)) / np.maximum(g.std(0), 1e-9)
    u, _, _ = np.linalg.svd(gs, full_matrices=False)
    q = np.concatenate([PU.load_matrix_float(os.path.join(runs["root"], "port", f"p{p}_Qpc.txt")).T
                        for p in (1, 2)])
    assert np.isfinite(q).all() and q.shape == (sum(NROWS), NPC)
    basis, _ = np.linalg.qr(q)
    for k in range(2):
        assert np.linalg.norm(basis.T @ u[:, k]) >= 0.9, k
