"""Port parity: the logistic path of sfgwas_tpu_torch (gwas/matmult.py's
cmult_mat_* helpers; gwas/assoc.py: compute_grad_and_inv_hessian,
lr_newton_cov_only, gwy_score_test) against sfgwas_tpu's at TEST8 on the
CPU, three parties of each package under the reference's collective keys
(tests/test_torch_assoc.py's harness: the default shift set carried across
with interop, the same PRG keys, local and encryption generators).

One run of each package goes through: the orthonormal covariate basis Cm
(the pooled [1 | covariates] orthonormalised in numpy, each data party's
rows encrypted and refreshed as the protocol refreshes its basis), the
four cmult helpers on it, lr_newton_cov_only for 2 epochs and
gwy_score_test over 2 genotype blocks at the CPU study's sigmoid (degree
15 on [-6, 6]).  Every compute_grad_and_inv_hessian call's outputs (grad,
(Z^T W Z)^-1, B^T, Wz, y~, w: the 2 epochs', the second with the
intercept term, and the score test's), the weights and the statistics
are bit-equal to the reference's as ciphertexts, with the same level and
scale, and the decrypted weights and statistics follow the exact-sigmoid
oracle of the same 2 Newton epochs.  A mixed run puts the port's dealer
with the reference's data parties (an in-process mesh that carries every
message as the wire codec's bytes) through the first epoch: the data
parties' outputs are bit-equal to the reference's own run.  Also: the
rotation keys of the default shift set cover the full-slot
rotate-and-add at PN14's 8,192 slots; chip_smoke.py phase 13's oracle and
span split."""

import dataclasses
import math
import queue
import threading

import numpy as np
import pytest

from sfgwas_tpu.mpc.mpc import MPC as RefMPC
from sfgwas_tpu.mpc.prg import Random as RefRandom
from sfgwas_tpu.ops import ring as RR
from sfgwas_tpu.parallel import transport as RT
from sfgwas_tpu.utils import devlock
from sfgwas_tpu_torch import interop
from sfgwas_tpu_torch.crypto import ckks as PC
from sfgwas_tpu_torch.crypto.params import get_params as port_get_params
from sfgwas_tpu_torch.mpc import mhe as PM
from sfgwas_tpu_torch.mpc.mpc import MPC as PortMPC
from sfgwas_tpu_torch.mpc.prg import Random as PortRandom
from sfgwas_tpu_torch.ops import ring as PR
from sfgwas_tpu_torch.parallel import transport as PT
from test_torch_assoc import (  # noqa: F401
    NROWS, PORT, PRESET, REF, _seeded, assert_same_cts, flat, ref_keys, run,
)

from test_torch_householder_band import ref_householder_repaired  # noqa: F401

# the port's Householder brings x to unit scale first (ROADMAP C): the JAX
# package's runs with the same repair here
pytestmark = pytest.mark.usefixtures("ref_householder_repaired")

NCOV = 2  # covariates; the ones column makes 3
APPROX = (-6.0, 6.0, 15)  # tests/test_e2e_gwas.py:77-82
EPOCHS = 2
SCALE = 10000.0  # inverse_mat_scale, config/configGlobalLogistic.toml
BLOCKS = (30, 20)  # SNPs a block


def _data():
    """Per data party: covariates, a binary phenotype from a logistic model
    over them and two SNPs, and the genotype blocks."""
    rng = np.random.default_rng(21)
    out = {}
    for pid in (1, 2):
        n = NROWS[pid]
        cov = rng.normal(size=(n, NCOV))
        g = rng.binomial(2, rng.uniform(0.2, 0.5, size=sum(BLOCKS)), size=(n, sum(BLOCKS)))
        logit = -0.2 + 0.8 * g[:, 0] - 0.6 * g[:, 3] + 0.5 * cov[:, 0]
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(float)
        out[pid] = (cov, y, g.astype(np.int8))
    return out


def _basis(data):
    """The orthonormal basis of the pooled [1 | covariates], split by party."""
    Z = np.concatenate([np.column_stack([np.ones(NROWS[p]), data[p][0]]) for p in (1, 2)])
    q = np.linalg.qr(Z)[0]
    q *= np.sign(q[0])
    return {1: q[: NROWS[1]], 2: q[NROWS[1]:]}


class _Calls:
    """Records every compute_grad_and_inv_hessian call's outputs at the data
    parties of both packages, by package and pid, while installed."""

    def __init__(self):
        self.got, self.lock = {}, threading.Lock()

    def __enter__(self):
        self.real = {k: m["A"].compute_grad_and_inv_hessian for k, m in (("ref", REF),
                                                                          ("port", PORT))}
        for key, m in (("ref", REF), ("port", PORT)):
            def wrapped(mpc, *a, _real=self.real[key], _key=key, **k):
                out = _real(mpc, *a, **k)
                if mpc.pid > 0:
                    with self.lock:
                        self.got.setdefault((_key, mpc.pid), []).append(
                            [flat(x) if x is not None else None for x in out])
                return out
            m["A"].compute_grad_and_inv_hessian = wrapped
        return self

    def __exit__(self, *exc):
        for key, m in (("ref", REF), ("port", PORT)):
            m["A"].compute_grad_and_inv_hessian = self.real[key]


def _body(epochs: int = EPOCHS, score: bool = True):
    """lr_newton_cov_only for `epochs` epochs and, with score, gwy_score_test
    over the 2 blocks, after the cmult helpers on the basis."""
    data = _data()
    cm_np = _basis(data)

    def body(mpc, cps, m):
        B, M, MM, A = m["B"], m["M"], m["MM"], m["A"]
        pid = mpc.pid
        res = {}
        y, Cm, blocks = None, NCOV + 1, None
        if pid > 0:
            cov, y, g = data[pid]
            blocks = [g[:, : BLOCKS[0]], g[:, BLOCKS[0]:]]
            Cm = [B.encrypt_float_vector(cps, cm_np[pid][:, j]) for j in range(NCOV + 1)]
            Cm = M.bootstrap_mat_all(mpc.net, cps, Cm)
            # the helpers on local operands
            yv = B.encrypt_float_vector(cps, y)
            packed = B.encrypt_float_vector(cps, np.array([0.5, -0.25, 0.125]))
            rows = [B.encrypt_float_vector(cps, np.array([0.3, -0.1, 0.2]) * (k + 1))
                    for k in range(NCOV + 1)]
            res["inner_prod"] = flat(MM.cmult_mat_inner_prod(cps, Cm, Cm))
            res["inner_prod_vector"] = flat(MM.cmult_mat_inner_prod_vector(cps, Cm, yv))
            res["col_col"] = flat(MM.cmult_mat_col_times_col_to_col(cps, Cm, packed, 1))
            res["col_row"] = flat(MM.cmult_mat_col_times_row_to_col(cps, Cm, rows, NCOV + 1))
        w = A.lr_newton_cov_only(mpc, cps, Cm, y, epochs, NROWS, APPROX, SCALE)
        if pid > 0:
            res["weights"] = flat(w)
            # the weights are each party's own ciphertext: party 1's decrypted
            src = w if pid == 1 else [None]
            res["weights_dec"] = cps.ctx.decode(
                M.collective_decrypt_many(mpc.net, cps, src, 1)[0])[: NCOV + 1]
        if not score:
            return res
        stats, filt = A.gwy_score_test(mpc, cps, Cm, blocks, y, w, APPROX, NROWS, SCALE)
        if pid > 0:
            res["stats"] = flat(stats)
            pts = M.collective_decrypt_many(mpc.net, cps, stats, -1)
            res["decoded"] = np.concatenate([cps.ctx.decode(pt) for pt in pts])[filt]
        return res

    return body


@pytest.fixture(scope="module")
def runs(ref_keys):
    body = _body()
    with _Calls() as calls:
        ref, port = run("ref", ref_keys, body), run("port", ref_keys, body)
    for pid in (1, 2):
        ref[pid]["calls"], port[pid]["calls"] = calls.got[("ref", pid)], calls.got[("port", pid)]
    return ref, port


HELPERS = ["inner_prod", "inner_prod_vector", "col_col", "col_row"]


@pytest.mark.parametrize("name", HELPERS)
def test_cmult_helpers_match_reference(runs, name):
    ref, port = runs
    for pid in (1, 2):
        assert_same_cts(ref[pid][name], port[pid][name])


GRAD_HESS = ["grad", "ZTwZInv", "BT", "Wz", "y_tilde", "w"]


@pytest.mark.parametrize("i", range(6), ids=GRAD_HESS)
def test_compute_grad_and_inv_hessian_matches_reference(runs, i):
    """Each call's outputs: the 2 Newton epochs' (the second with the
    intercept term) and the score test's (no gradient)."""
    ref, port = runs
    for pid in (1, 2):
        assert len(ref[pid]["calls"]) == len(port[pid]["calls"]) == EPOCHS + 1
        for r, p in zip(ref[pid]["calls"], port[pid]["calls"]):
            if r[i] is None:
                assert p[i] is None and i == 0
                continue
            assert_same_cts(r[i], p[i])


def test_newton_and_score_test_match_reference(runs):
    ref, port = runs
    for pid in (1, 2):
        assert_same_cts(ref[pid]["weights"], port[pid]["weights"])
        assert_same_cts(ref[pid]["stats"], port[pid]["stats"])
        np.testing.assert_array_equal(port[pid]["decoded"], ref[pid]["decoded"])


def newton_oracle(Z, y, epochs):
    """Exact-sigmoid Newton from zero weights (the first epoch's p is 1/2,
    as lr_newton_cov_only's epoch without the intercept term)."""
    beta = np.zeros(Z.shape[1])
    for _ in range(epochs):
        p = 1 / (1 + np.exp(-Z @ beta))
        w = p * (1 - p)
        beta = beta + np.linalg.solve(Z.T @ (Z * w[:, None]), Z.T @ (y - p))
    return beta


def score_oracle(Z, y, G, beta):
    """The score test at beta as gwy_score_test computes it: the numerator
    g^T (y~ - W Z (Z^T W Z)^{-1} Z^T y~), the denominator g^T W g - g^T W Z
    (Z^T W Z)^{-1} Z^T W g."""
    p = 1 / (1 + np.exp(-Z @ beta))
    w = p * (1 - p)
    yt = y - p
    ZW = Z * w[:, None]
    Hinv = np.linalg.inv(Z.T @ ZW)
    o = ZW @ (Hinv @ (Z.T @ yt))
    gzw = G.T @ ZW
    den = (w[:, None] * G * G).sum(0) - np.einsum("ij,jk,ik->i", gzw, Hinv, gzw)
    return G.T @ (yt - o) / np.sqrt(den)


def test_statistics_follow_the_newton_oracle(runs):
    """The decrypted weights and statistics against the exact-sigmoid
    oracle of the same 2 epochs (the degree-15 sigmoid on [-6, 6] and the
    fixed-point inverse: 2e-2), Pearson corr > 0.999."""
    data = _data()
    Z = np.concatenate([_basis(data)[p] for p in (1, 2)])
    y = np.concatenate([data[p][1] for p in (1, 2)])
    G = np.concatenate([data[p][2] for p in (1, 2)]).astype(float)
    beta = newton_oracle(Z, y, EPOCHS)
    want = score_oracle(Z, y, G, beta)
    port = runs[1]
    for pid in (1, 2):
        assert np.abs(port[pid]["weights_dec"].real - beta).max() < 2e-2
        got = port[pid]["decoded"].real
        assert got.shape == want.shape and np.isfinite(got).all()
        assert np.abs(got - want).max() < 2e-2, np.abs(got - want).max()
        assert np.corrcoef(got, want)[0, 1] > 0.999


def test_default_shifts_cover_full_slot_rotate_and_add():
    """rotate_and_add over all slots rotates left by every power of two
    below the slot count: keys for each, at TEST8 and at PN14's 8,192."""
    for slots in (port_get_params(PRESET).slots, port_get_params("PN14QP438").slots):
        shifts = set(PM.generate_rot_shifts(slots))
        assert {1 << k for k in range(int(math.log2(slots)))} <= shifts, slots


# --- the port's dealer with the reference's data parties


class _BytesMesh:
    """An in-process mesh whose transports carry the wire codec's bytes
    (zero_copy off), so the two packages' Networks talk to each other."""

    def __init__(self, n):
        self.q = {(a, b): queue.Queue() for a in range(n) for b in range(n) if a != b}

    def transport(self, pid, ref: bool):
        mesh = self

        class T:
            zero_copy = False

            def send_bytes(self, to, data):
                mesh.q[(pid, to)].put(bytes(data))

            def recv_bytes(self, frm, timeout=600.0):
                if ref:  # the reference's data parties take turns on jax
                    with devlock.yielding():
                        return mesh.q[(frm, pid)].get(timeout=timeout)
                return mesh.q[(frm, pid)].get(timeout=timeout)

            def close(self):
                pass

        return T()


def test_port_dealer_with_reference_data_parties(ref_keys, runs):
    """The first Newton epoch with the port's dealer: the reference's data
    parties' helpers, Newton-call outputs and weights bit-equal to their
    own run's."""
    mesh = _BytesMesh(3)
    body = _body(epochs=1, score=False)
    results, errors = [None] * 3, []
    devlock.enable()

    def party(pid):
        try:
            if pid == 0:
                net = PT.Network(mesh.transport(0, False), 0, 3, 1, PortRandom(0, 3))
                mpc = PortMPC(net, PR.LElem256, 60, 30, True, 1_000_000)
                ctx = PC.CkksContext(port_get_params(PRESET), device="cpu")
                cps = interop.crypto_params(ctx, enc_rng=_seeded(mpc),
                                            **interop.bundle_arrays(ref_keys[0]))
                results[0] = body(mpc, cps, PORT)
                return
            devlock.acquire()
            try:
                net = RT.Network(mesh.transport(pid, True), pid, 3, 1, RefRandom(pid, 3))
                mpc = RefMPC(net, RR.LElem256, 60, 30, True, 1_000_000)
                cps = dataclasses.replace(ref_keys[pid], enc_rng=_seeded(mpc))
                results[pid] = body(mpc, cps, REF)
            finally:
                devlock.release()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    with _Calls() as calls:
        ts = [threading.Thread(target=party, args=(p,), daemon=True) for p in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=600)
    assert not errors, errors
    assert not any(t.is_alive() for t in ts)
    ref = runs[0]
    for pid in (1, 2):
        for name in HELPERS:
            assert_same_cts(ref[pid][name], results[pid][name])
        (got,) = calls.got[("ref", pid)]
        for r, p in zip(ref[pid]["calls"][0], got):
            assert_same_cts(r, p)


# --- chip_smoke.py phase 13's oracle and span split


def test_chip_smoke_oracle_is_the_reference_oracle(tmp_path):
    """chip_smoke.logistic_oracle converged equals tests/test_e2e_gwas.py's
    oracle_logistic_score on its own data; after 3 epochs it is closer to
    it than after 2 (2.6e-3 off on these 44 individuals)."""
    import chip_smoke
    from test_e2e_gwas import make_logistic_data, oracle_logistic_score

    data = make_logistic_data(str(tmp_path), np.random.default_rng(55))
    keep = np.ones(data[1][0].shape[1], bool)
    keep[7] = False
    want = oracle_logistic_score(data, keep)
    conv = chip_smoke.logistic_oracle(data, keep, chip_smoke.LOGISTIC_CONVERGED_EPOCHS)
    np.testing.assert_allclose(conv, want, rtol=1e-9, atol=1e-9)
    three = chip_smoke.logistic_oracle(data, keep, chip_smoke.LOGISTIC_EPOCHS)
    two = chip_smoke.logistic_oracle(data, keep, 2)
    assert np.abs(three - want).max() < min(1e-2, np.abs(two - want).max())


def test_chip_smoke_span_split():
    """Party 1's span events split per epoch, score preparation and block:
    each part holds the spans that ended since the previous split."""
    import chip_smoke

    ev = [("lr_sigmoid", 1.0), ("lr_inv_ss", 2.0), ("lr_step", 0.5), ("lr_step", 0.25),
          ("lr_epoch", 4.0), ("lr_sigmoid", 1.5), ("lr_epoch", 2.0), ("lr_inv_ss", 3.0),
          ("score_prep", 3.5), ("score_encode", 0.5), ("score_mm", 1.0), ("score_block", 2.0),
          ("score_encode", 0.25), ("score_block", 1.0)]
    got = chip_smoke.logistic_spans(ev)
    assert got["epochs"] == [
        {"lr_sigmoid": 1.0, "lr_inv_ss": 2.0, "lr_step": 0.75, "lr_epoch": 4.0},
        {"lr_sigmoid": 1.5, "lr_epoch": 2.0}]
    assert got["score_prep"] == [{"lr_inv_ss": 3.0, "score_prep": 3.5}]
    assert got["score_blocks"] == [{"score_encode": 0.5, "score_mm": 1.0, "score_block": 2.0},
                                   {"score_encode": 0.25, "score_block": 1.0}]
