"""Port parity: the CholeskyQR2 covariate basis of sfgwas_tpu_torch
(gwas/qrfact.py::net_cholqr_enc, gwas/assoc.py::compute_combined_q) against
sfgwas_tpu's on the CPU, three parties of each package (dealer 0, data
parties 1 and 2, hub 1), and the reference's own contract tests
(tests/test_mhe.py:197-270), ported.  This file runs them at TEST8;
tests/test_torch_qr_reset.py runs the same tests at TEST10.

Both packages run under the reference's collective keys (carried across with
interop), from the same PRG keys, the same local generators and the same
encryption generators.  The two presets run the two branches of the QR:
- TEST8, nrows_all = [0, 300, 200]: every column spans 3 ciphertexts of 128
  slots at party 1 and 2 at party 2.  The QR band (rot_nmod + 2 = 9) is the
  top of the chain, so the refreshes cannot reset the scale and the
  drift-compensation branch runs (s_ref, value_scales, mask_trunc's
  target_scale).
- TEST10, nrows_all = [0, 600, 200]: 2 ciphertexts of 512 slots at party 1
  and 1 at party 2.  The band (9) lies below the top (13), so every refresh
  is a scale reset, the branch PN14QP438 runs.
Every ciphertext of Q must be bit-equal to the reference's, with the same
level and scale; no step is exempt."""

import dataclasses
import functools

import numpy as np
import pytest

from sfgwas_tpu.crypto import basics as RB
from sfgwas_tpu.gwas import assoc as RA
from sfgwas_tpu.gwas import qrfact as RQ
from sfgwas_tpu.mpc import mhe as RM
from sfgwas_tpu.parallel import simulate as RS
from sfgwas_tpu_torch import interop
from sfgwas_tpu_torch.crypto import basics as PB
from sfgwas_tpu_torch.crypto import ckks as PC
from sfgwas_tpu_torch.crypto.params import get_params as port_get_params
from sfgwas_tpu_torch.gwas import assoc as PA
from sfgwas_tpu_torch.gwas import qrfact as PQ
from sfgwas_tpu_torch.mpc import mhe as PM
from sfgwas_tpu_torch.parallel import simulate as PS


def _shifts(slots: int):
    """Powers of two and their complements (tests/test_mhe.py:13 at 128
    slots)."""
    pw = [1 << k for k in range(slots.bit_length() - 1)]
    return pw + [slots - k for k in pw if slots - k not in pw]


@dataclasses.dataclass(frozen=True)
class Case:
    preset: str
    slots: int
    nrows: tuple

    @property
    def n(self) -> int:
        return sum(self.nrows)

    @property
    def split(self):
        return {1: slice(0, self.nrows[1]), 2: slice(self.nrows[1], self.n)}

    def data(self):
        """[ones | 2 columns] and 2 covariates at the disparate scales of
        tests/test_mhe.py:204 and :253-254."""
        rng = np.random.default_rng(12)
        a = rng.normal(size=(self.n, 3)) * np.array([1.0, 20.0, 0.1])
        a[:, 0] = 1.0
        return a, rng.normal(size=(self.n, 2)) * np.array([50.0, 0.3])


CASES = {"TEST8": Case("TEST8", 128, (0, 300, 200)), "TEST10": Case("TEST10", 512, (0, 600, 200))}
TEST8 = CASES["TEST8"]

REF = dict(B=RB, M=RM, Q=RQ, A=RA, S=RS)
PORT = dict(B=PB, M=PM, Q=PQ, A=PA, S=PS)


@pytest.fixture(scope="module")
def case():
    return TEST8


@functools.lru_cache(maxsize=None)
def _keys(case):
    return RS.run_parties(3, lambda mpc: RM.collective_init(
        mpc.net, case.preset, shifts_override=_shifts(case.slots)))


@pytest.fixture(scope="module")
def ref_keys(case):
    """The reference's collective keys for the module's case: made once a
    case and test process, shared by every module that imports this
    fixture."""
    return _keys(case)




def _seeded(mpc):
    """The local PRG (the dealer's secret draws) and the encryption
    generator, seeded alike in both packages."""
    mpc.rand.table[mpc.pid] = np.random.Generator(np.random.Philox(key=[9, mpc.pid]))
    return np.random.default_rng(100 + mpc.pid)


def _run(pkg, case, ref_keys, body, device="cpu"):
    """body(mpc, cps, modules) at three parties of one package."""
    m = REF if pkg == "ref" else PORT
    bundles = {p: interop.bundle_arrays(ref_keys[p]) for p in range(3)}

    def fn(mpc):
        enc_rng = _seeded(mpc)
        if pkg == "ref":
            cps = dataclasses.replace(ref_keys[mpc.pid], enc_rng=enc_rng)
        else:
            ctx = PC.CkksContext(port_get_params(case.preset), device=device)
            cps = interop.crypto_params(ctx, enc_rng=enc_rng, **bundles[mpc.pid])
        return body(mpc, cps, m)

    return m["S"].run_parties(3, fn)


def _decrypt_blocks(mpc, cps, m, Q, nrows):
    """Every data party's rows of Q, decrypted collectively (each source
    broadcasts its ciphertexts) and stacked: [N, ncols]."""
    slots = cps.slots
    blocks = []
    for p in (1, 2):
        nct = -(-nrows[p] // slots)
        cts = [ct for col in Q for ct in col] if mpc.pid == p else [None] * (len(Q) * nct)
        pts = m["M"].collective_decrypt_many(mpc.net, cps, cts, p)
        vals = np.stack([cps.ctx.decode(pt) for pt in pts]).reshape(len(Q), nct * slots)
        blocks.append(vals[:, : nrows[p]].T)
    return np.concatenate(blocks)


def _cholqr(case):
    a_full = case.data()[0]

    def body(mpc, cps, m):
        if mpc.pid > 0:
            loc = a_full[case.split[mpc.pid]]
            A = [m["B"].encrypt_float_vector(cps, loc[:, j]) for j in range(3)]
        else:
            A = [None] * 3
        Q = m["Q"].net_cholqr_enc(cps, mpc, A, list(case.nrows), passes=2)
        if mpc.pid == 0:
            return None
        out = {"Q": interop.cipher_matrix_arrays(Q)}
        if m is PORT:
            out["dec"] = _decrypt_blocks(mpc, cps, m, Q, case.nrows)
        return out

    return body


def _combined(case):
    covs = case.data()[1]

    def body(mpc, cps, m):
        cov = covs[case.split[mpc.pid]] if mpc.pid > 0 else 2
        Q, ncols = m["A"].compute_combined_q(mpc, cps, cov, None, list(case.nrows), False)
        if mpc.pid == 0:
            return ncols
        out = {"Q": interop.cipher_matrix_arrays(Q), "ncols": ncols}
        if m is PORT:
            out["dec"] = _decrypt_blocks(mpc, cps, m, Q, case.nrows)
        return out

    return body


@pytest.fixture(scope="module")
def cholqr(case, ref_keys):
    body = _cholqr(case)
    return _run("ref", case, ref_keys, body), _run("port", case, ref_keys, body)


@pytest.fixture(scope="module")
def combined(case, ref_keys):
    body = _combined(case)
    return _run("ref", case, ref_keys, body), _run("port", case, ref_keys, body)


def test_presets_run_both_branches():
    """TEST8's band is the top of its chain (drift compensation); TEST10's
    and PN14QP438's lie below it (scale resets)."""
    for preset, top in (("TEST8", True), ("TEST10", False), ("PN14QP438", False)):
        ctx = PC.CkksContext(port_get_params(preset), device="cpu")
        band = min(ctx.nq, ctx.params.mm_nmod + 2)
        assert (band == ctx.nq) is top, (preset, band, ctx.nq)


def _assert_same_q(case, ref, port):
    for pid in (1, 2):
        rq, pq = ref[pid]["Q"], port[pid]["Q"]
        nct = -(-case.nrows[pid] // case.slots)
        assert [len(c) for c in pq] == [len(c) for c in rq] == [nct] * len(rq)
        for rcol, pcol in zip(rq, pq):
            for (r0, r1, rn, rs), (p0, p1, pn, ps) in zip(rcol, pcol):
                assert (pn, ps) == (rn, rs)
                assert r0.dtype == p0.dtype == np.uint32
                np.testing.assert_array_equal(p0, r0)
                np.testing.assert_array_equal(p1, r1)


def test_net_cholqr_enc_ciphertexts_match_reference(case, cholqr):
    _assert_same_q(case, *cholqr)


def test_compute_combined_q_ciphertexts_match_reference(case, combined):
    ref, port = combined
    assert ref[0] == port[0] == 3
    assert port[1]["ncols"] == port[2]["ncols"] == 3
    _assert_same_q(case, ref, port)


def test_net_cholqr_enc_orthonormalizes(case, cholqr):
    """tests/test_mhe.py:197-240: Q^T Q = I within 2e-2 (Q scaled back by
    1/sqrt(N)) and column j of Q in the span of A's first j + 1 columns."""
    port = cholqr[1]
    a_full = case.data()[0]
    for pid in (1, 2):
        Q = port[pid]["dec"] / np.sqrt(case.n)
        assert np.allclose(Q.T @ Q, np.eye(3), atol=2e-2), Q.T @ Q
        for j in range(3):
            Aj = a_full[:, : j + 1]
            proj = Aj @ np.linalg.lstsq(Aj, Q[:, j], rcond=None)[0]
            assert np.linalg.norm(Q[:, j] - proj) < 2e-2, j


def test_net_cholqr_enc_matches_numpy_qr(case, cholqr):
    """Each column within 2e-2 of numpy's QR with diag(R) > 0."""
    q, r = np.linalg.qr(case.data()[0])
    q = q * np.sign(np.diag(r))
    for pid in (1, 2):
        got = cholqr[1][pid]["dec"] / np.sqrt(case.n)
        assert np.abs(got - q).max() < 2e-2


def test_combined_q_uniform_scale_and_level(case, combined):
    """tests/test_mhe.py:243-270: every ciphertext of the combined basis at
    one (level, scale); and it is orthonormal, its first column the
    normalized all-ones vector."""
    port = combined[1]
    basis = np.column_stack([np.ones(case.n), case.data()[1]])
    q, r = np.linalg.qr(basis)
    q = q * np.sign(np.diag(r))
    for pid in (1, 2):
        levels = {(n, s) for col in port[pid]["Q"] for (_, _, n, s) in col}
        assert len(levels) == 1, levels
        Q = port[pid]["dec"] / np.sqrt(case.n)
        assert np.allclose(Q.T @ Q, np.eye(3), atol=2e-2)
        assert np.abs(Q - q).max() < 2e-2


def test_qr_methods(case, ref_keys):
    """net_qr: an unknown method is refused at every party, and
    'householder' (net_dqr_enc) and 'cholqr3' (three passes) both
    orthonormalize: Q^T Q = I within 2e-2 (Q scaled back by 1/sqrt(N))."""
    nrows = list(case.nrows)
    a_full = case.data()[0]

    def body(mpc, cps, m):
        with pytest.raises(AssertionError, match="unknown"):
            PQ.net_qr(cps, mpc, [None], nrows, method="lu")
        out = {}
        for method in ("householder", "cholqr3"):
            if mpc.pid > 0:
                loc = a_full[case.split[mpc.pid], :2]
                A = [PB.encrypt_float_vector(cps, loc[:, j]) for j in range(2)]
            else:
                A = [None] * 2
            Q = PQ.net_qr(cps, mpc, A, nrows, method=method)
            out[method] = None if mpc.pid == 0 else _decrypt_blocks(mpc, cps, PORT, Q, nrows)
        return out

    res = _run("port", case, ref_keys, body)
    for pid in (1, 2):
        for method, dec in res[pid].items():
            Q = dec / np.sqrt(case.n)
            assert np.allclose(Q.T @ Q, np.eye(2), atol=2e-2), (method, Q.T @ Q)
