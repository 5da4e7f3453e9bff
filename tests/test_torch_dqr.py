"""Port parity: the Householder QR of sfgwas_tpu_torch (gwas/qrfact.py::
net_dqr_enc, its dealer side net_dqr_enc_party0, and net_dqr_plain) against
sfgwas_tpu's on the CPU, three parties of each package (dealer 0, data
parties 1 and 2, hub 1), with the harness of tests/test_torch_qr.py: the
reference's collective keys carried across with interop, the same PRG keys,
local generators and encryption generators.  This file runs at TEST8
(nrows_all = [0, 300, 200]: 3 and 2 ciphertexts a column, the QR band at the
top of the chain, so the refreshes only drift); tests/test_torch_dqr_reset.py
imports the same tests and runs them at TEST10 (the scale-reset branch that
PN14QP438 runs).

Every ciphertext of Q must be bit-equal to the reference's at every data
party, with the same level and scale, and Q must meet the reference's own
contract in both packages (tests/test_mhe.py:197-240): Q^T Q = N I within
2e-2 and column j in the span of A's first j + 1 columns.

The pivot of column j is global row j, which lies in party 1's first
ciphertext for any width a test can afford (128 slots at TEST8).  The
`late` cases move the pivots onto party 1's last ciphertext by mapping
column j to row j + 4 of that ciphertext (row 260 on at TEST8, 516 on at
TEST10) in both packages' global_to_party_index:
Householder over another set of pivot rows is the QR of a row-permuted A, so
the contract holds as it stands, and the ctid > 0 indexing (the SS input,
the alpha mask, the pivot-row mask of A, the backward pass' mask and the
initial unit columns) is exercised."""

import numpy as np
import pytest

from sfgwas_tpu.crypto import basics as RB
from sfgwas_tpu.gwas import qrfact as RQ
from sfgwas_tpu.mpc import mhe as RM
from sfgwas_tpu_torch import interop
from sfgwas_tpu_torch.crypto import basics as PB
from sfgwas_tpu_torch.gwas import qrfact as PQ
from test_torch_qr import CASES, PORT, _decrypt_blocks, _run, ref_keys  # noqa: F401

NCOLS = 3


@pytest.fixture(scope="module")
def case():
    return CASES["TEST8"]


def _late_index(orig, offset):
    """global_to_party_index with party 1's pivots moved `offset` rows on."""

    def index(cps, nrows_all, col, nparty):
        if col < NCOLS and offset:
            local = col + offset
            assert local < nrows_all[1]
            return 1, local // cps.slots, local % cps.slots
        return orig(cps, nrows_all, col, nparty)

    return index


def _dqr(case):
    a_full = case.data()[0]

    def body(mpc, cps, m):
        Qm = RQ if m is not PORT else PQ
        if mpc.pid == 0:
            Q = Qm.net_dqr_enc_party0(cps, mpc, NCOLS, list(case.nrows))
            assert Q == [None] * NCOLS
            return None
        loc = a_full[case.split[mpc.pid]]
        A = [m["B"].encrypt_float_vector(cps, loc[:, j]) for j in range(NCOLS)]
        Q = Qm.net_dqr_enc(cps, mpc, A, list(case.nrows))
        return {"Q": interop.cipher_matrix_arrays(Q),
                "dec": _decrypt_blocks(mpc, cps, m, Q, case.nrows)}

    return body


@pytest.fixture(scope="module", params=["first", "late"])
def dqr(request, case, ref_keys):
    offset = 0 if request.param == "first" else (case.nrows[1] - 1) // case.slots * case.slots + 4
    body = _dqr(case)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (RB, PB):
            mp.setattr(mod, "global_to_party_index",
                       _late_index(mod.global_to_party_index, offset))
        return offset, _run("ref", case, ref_keys, body), _run("port", case, ref_keys, body)


def assert_same_q(ref, port, nrows, slots, ncols):
    for pid in (1, 2):
        rq, pq = ref[pid]["Q"], port[pid]["Q"]
        nct = -(-nrows[pid] // slots)
        assert [len(c) for c in pq] == [len(c) for c in rq] == [nct] * ncols
        for rcol, pcol in zip(rq, pq):
            for (r0, r1, rn, rs), (p0, p1, pn, ps) in zip(rcol, pcol):
                assert (pn, ps) == (rn, rs)
                assert r0.dtype == p0.dtype == np.uint32
                np.testing.assert_array_equal(p0, r0)
                np.testing.assert_array_equal(p1, r1)


def test_net_dqr_enc_ciphertexts_match_reference(case, dqr):
    _, ref, port = dqr
    assert ref[0] is None and port[0] is None
    assert_same_q(ref, port, case.nrows, case.slots, NCOLS)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_net_dqr_enc_orthonormalizes(case, dqr, pkg):
    """tests/test_mhe.py:197-240's contract: Q^T Q = N I within 2e-2 and
    column j of Q in the span of A's first j + 1 columns; the trailing slots
    are masked (the decrypted blocks carry exactly the parties' rows)."""
    res = dqr[1] if pkg == "ref" else dqr[2]
    a_full = case.data()[0]
    for pid in (1, 2):
        Qn = res[pid]["dec"]
        assert Qn.shape == (case.n, NCOLS)
        assert np.allclose(Qn.T @ Qn, case.n * np.eye(NCOLS), atol=2e-2 * case.n), Qn.T @ Qn
        Q = Qn / np.sqrt(case.n)
        for j in range(NCOLS):
            Aj = a_full[:, : j + 1]
            proj = Aj @ np.linalg.lstsq(Aj, Q[:, j], rcond=None)[0]
            assert np.linalg.norm(Q[:, j] - proj) < 2e-2, j


def test_net_dqr_enc_matches_numpy_qr(case, dqr):
    """Up to the sign of each column, the port's Q is numpy's within 2e-2
    (the QR of a full-rank matrix is unique up to those signs, whichever
    rows pivot)."""
    q, _ = np.linalg.qr(case.data()[0])
    for pid in (1, 2):
        got = dqr[2][pid]["dec"] / np.sqrt(case.n)
        sign = np.sign(np.sum(got * q, axis=0))
        assert np.abs(got - q * sign).max() < 2e-2


def _plain(case, refresh: bool):
    """net_dqr_plain at every party.  With `refresh`, the reference's
    net_dqr_enc is wrapped to refresh its output into the QR band at the
    data parties, the step the port's net_dqr_plain adds before the
    recombination."""
    a_full = case.data()[0]

    def ref_enc(cps, mpc, A, nrows_all, _orig=RQ.net_dqr_enc):
        Q = _orig(cps, mpc, A, nrows_all)
        if mpc.pid > 0:
            Q = RM.bootstrap_mat_all(mpc.net, cps, Q, target_nmod=min(cps.ctx.nq, cps.rot_nmod + 2))
        return Q

    def body(mpc, cps, m):
        Qm = RQ if m is not PORT else PQ
        loc = a_full[case.split[mpc.pid]] if mpc.pid > 0 else None
        Q = Qm.net_dqr_plain(cps, mpc, loc, list(case.nrows))
        if mpc.pid == 0:
            assert Q == [None] * NCOLS
            return None
        return {"Q": interop.cipher_matrix_arrays(Q),
                "dec": _decrypt_blocks(mpc, cps, m, Q, case.nrows) if m is PORT else None}

    return body, ref_enc


def test_reference_net_dqr_plain_runs_out_of_levels(case, ref_keys):
    """Why the port's net_dqr_plain refreshes Qp: the JAX package's spends
    one level more than the chain holds in the recombination's scaling, at
    this preset as at every other (the QR band is 9 primes at each)."""
    body, _ = _plain(case, refresh=False)
    with pytest.raises(AssertionError, match="level underflow"):
        _run("ref", case, ref_keys, body)


def test_net_dqr_plain_matches_reference(case, ref_keys, monkeypatch):
    """net_dqr_plain with the dealer's side: every ciphertext of Q bit-equal
    to the reference's with the same refresh before the recombination, and
    the port's Q is the QR of A scaled by sqrt(N) within 2e-2 (each column
    up to its sign)."""
    body, ref_enc = _plain(case, refresh=True)
    with monkeypatch.context() as mp:
        mp.setattr(RQ, "net_dqr_enc", ref_enc)
        ref = _run("ref", case, ref_keys, body)
    port = _run("port", case, ref_keys, body)
    assert ref[0] is None and port[0] is None
    assert_same_q(ref, port, case.nrows, case.slots, NCOLS)
    q, _ = np.linalg.qr(case.data()[0])
    for pid in (1, 2):
        got = port[pid]["dec"] / np.sqrt(case.n)
        assert np.isfinite(got).all() and got.shape == (case.n, NCOLS)
        assert np.allclose(got.T @ got, np.eye(NCOLS), atol=2e-2), got.T @ got
        sign = np.sign(np.sum(got * q, axis=0))
        assert np.abs(got - q * sign).max() < 2e-2


def test_chip_smoke_householder_check():
    """chip_smoke.py phase 8's measure of a Householder Q: each column
    compared with numpy's up to its sign, Q^T Q / N against I, and a Q off
    in scale by a permille fails its 1e-4 limit."""
    import chip_smoke

    a = np.random.default_rng(3).normal(size=(2000, 6)) * np.array([1, 20, 0.1, 50, 0.3, 2])
    q, _ = np.linalg.qr(a)
    flip = np.array([1, -1, 1, 1, -1, 1.0])
    got = chip_smoke.householder_check(q * flip * np.sqrt(2000), a)
    assert got["negated_columns"] == 2 and got["finite"]
    assert got["qr_err"] < 1e-12 and got["ortho_err"] < 1e-12
    off = chip_smoke.householder_check(q * flip * np.sqrt(2000) * 1.001, a)
    assert off["ortho_err"] > chip_smoke.HH_TOL
