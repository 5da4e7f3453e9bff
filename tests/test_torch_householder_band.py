"""The SS Householder's band fault in the JAX package and the port's repair
(sfgwas_tpu_torch/mpc/linalg.py::unit_scale, ROADMAP C).

The JAX package's householder (sfgwas_tpu/mpc/linalg.py:32-67, the Go
sfgwas's mpc/mpc.go:2276-2324) forms v from ||x||^2 truncated to 30
fraction bits: near ||x||^2 ~ 2^-30 only a few bits are left, and
P = I - 2 v v^T is not orthogonal.  Phase 13's first Newton epoch inverts a
near-scalar 6 x 6 matrix whose eigensolver reflects such near-zero columns,
and loses one direction about once in 18 runs on the card.  The port
brings x to unit scale by a secret even power of two first.

Three parties on the CPU, the PRG keys pinned (Philox [key, pid]): the
reference's fault at one key, pinned as it is; the port's P orthogonal at
||x|| from 0 to 1e2 in decades; the port's 6 x 6 inverse right at two keys
on which the reference's loses a direction.

Parity tests that run the reference's Householder (linalg, PCA, logistic)
patch it the same way with reference_householder_repaired()."""

import contextlib

import numpy as np
import pytest

import chip_smoke as cs
from sfgwas_tpu.mpc import linalg as RL
from sfgwas_tpu.parallel import simulate as RS
from sfgwas_tpu_torch.mpc import linalg as PL
from sfgwas_tpu_torch.parallel import simulate as PS

REF_HOUSEHOLDER = RL.householder  # the JAX package's own, unrepaired


def ref_unit_scale(mpc, x):
    """The port's unit_scale, step for step, on the JAX package's MPC."""
    kb, fb = mpc.data_bits, mpc.frac_bits
    half = (kb + fb + 1) // 2
    xr, xm = mpc.beaver_partition(x)
    z = mpc.ring.sum(mpc.beaver_mult_elem(xr, xm, xr, xm), axis=0)[None]
    z = mpc.beaver_reconstruct(z)
    _, root = mpc.normalizer_even_exp(z, 2 * half, mpc.boolean_shares)
    x = RL.ss_mult_vec_scalar(mpc, x, root[0])
    return mpc.trunc(x, kb, half - fb) if half > fb else x


def _ref_householder_repaired(mpc, x):
    return REF_HOUSEHOLDER(mpc, ref_unit_scale(mpc, x))


@contextlib.contextmanager
def reference_householder_repaired():
    """The JAX package's qr_fact_square, tridiag and everything above them
    run its householder on x brought to unit scale, as the port's does."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(RL, "householder", _ref_householder_repaired)
        yield


@pytest.fixture(scope="module")
def ref_householder_repaired():
    """reference_householder_repaired() for a whole test module: its
    parity tests import this and use it with pytest.mark.usefixtures."""
    with reference_householder_repaired():
        yield


F = 30
BAND_KEY = 3  # a key on which the reference's |v| is 1.07 at ||x|| ~ 4e-5


def _householder(L, S, x, key):
    def party(mpc):
        mpc.rand.table[mpc.pid] = np.random.Generator(np.random.Philox(key=[key, mpc.pid]))
        sh = S.make_shares(mpc, [int(round(v * (1 << F))) for v in x])
        return S.reveal_ints(mpc, L.householder(mpc, sh)), mpc.ring.modulus

    ints, q = S.run_parties(3, party)[1]
    v = np.array([(int(t) - q if int(t) > q // 2 else int(t)) / (1 << F) for t in ints])
    return v, np.abs((np.eye(len(v)) - 2 * np.outer(v, v)) @ (np.eye(len(v)) - 2 * np.outer(v, v))
                     - np.eye(len(v))).max()


def _vector(norm: float, seed: int = 1) -> np.ndarray:
    x = np.random.default_rng(seed).uniform(-1, 1, size=5)
    return x / np.linalg.norm(x) * norm


def test_reference_householder_band_fault():
    """||x|| ~ 4e-5 (entries ~3e-5): ||x||^2 keeps ~3 of its bits, the
    reference's |v| is off 1 by 7% and P is 0.36 from orthogonal; the
    port's is orthogonal on the same input and key."""
    x = _vector(4e-5)
    v, err = _householder(RL, RS, x, BAND_KEY)
    assert abs(np.linalg.norm(v) - 1) > 1e-2 and err > 1e-2, (np.linalg.norm(v), err)
    v, err = _householder(PL, PS, x, BAND_KEY)
    assert abs(np.linalg.norm(v) - 1) < 1e-6 and err < 1e-6, (np.linalg.norm(v), err)


@pytest.mark.parametrize("norm", [0.0] + [10.0 ** e for e in range(-9, 3)])
def test_port_householder_orthogonal(norm):
    """max |P^T P - I| <= 1e-4 from ||x|| = 0 (v = 0, P = I) to 1e2."""
    _, err = _householder(PL, PS, _vector(norm), BAND_KEY)
    assert err <= 1e-4, err


def _inverse(L, S, A, key):
    k = A.shape[0]

    def party(mpc):
        mpc.rand.table[mpc.pid] = np.random.Generator(np.random.Philox(key=[key, mpc.pid]))
        sh = S.make_shares(mpc, [int(round(v * (1 << F))) for v in A.reshape(-1)])
        B = L.matrix_inverse_sqrt_svd(mpc, sh.reshape((k, k) + sh.shape[1:]))
        return S.reveal_ints(mpc, B.reshape((k * k,) + B.shape[2:])), mpc.ring.modulus

    ints, q = S.run_parties(3, party)[1]
    Bf = np.array([(int(t) - q if int(t) > q // 2 else int(t)) / (1 << F) for t in ints])
    return cs.inverse_sqrt_error(A, Bf.reshape(k, k))


# keys on which the reference's 6 x 6 inverse of near_scalar_input(0) loses
# a direction (scripts/logistic_oracle_gap.py --sweep 42: 11 of 42 keys)
REF_FAILS = (2, 9)


def test_reference_inverse_loses_a_direction():
    assert _inverse(RL, RS, cs.near_scalar_input(0), REF_FAILS[0]) > 0.5


@pytest.mark.parametrize("key", REF_FAILS)
def test_port_inverse_right_where_reference_fails(key):
    assert _inverse(PL, PS, cs.near_scalar_input(0), key) <= cs.INVERSE_TOL
