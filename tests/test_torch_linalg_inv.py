"""Port parity: the matrix inverses of sfgwas_tpu_torch/mpc/linalg.py
(matrix_inverse_sqrt_svd, matrix_inverse_sym_pos, matrix_inverse_svd)
against sfgwas_tpu's, three parties of each package on the 256-bit field
from the same PRG keys and local generators (tests/test_torch_mpc.py's
harness): every share every party holds bit-equal to the reference's, the
revealed values held as tests/test_mpc_linalg.py:71 and :107 hold the
reference (5e-2).  The three at 3 x 3 here; the other two at 6 x 6 in
tests/test_torch_linalg_inv6.py (a 6 x 6 eigensolve takes ~25 s a package
on the CPU).

The 6 x 6 case of matrix_inverse_sqrt_svd, the one the logistic path runs,
is at the example's range: the path inverts Z^T W Z * inverse_mat_scale / n
(symmetrised), whose eigenvalues reach 2 * 0.25 * 10,000 / sqrt(n), about
112 at the example's n = 2000 (chip_smoke.py phase 13).  A 6 x 6 matrix
with eigenvalues from 112 down to 20 goes through both packages'
matrix_inverse_sqrt_svd: bit-equal shares and B^T B (A + A^T) within 5e-2
of I (no overflow: 16 * 6 * 112^2 is far inside the 30 integer bits)."""

import numpy as np
import pytest

from test_torch_mpc import _both, fxp, tofloat

from test_torch_householder_band import ref_householder_repaired  # noqa: F401

# the port's Householder brings x to unit scale first (ROADMAP C): the JAX
# package's runs with the same repair here
pytestmark = pytest.mark.usefixtures("ref_householder_repaired")


def _shares(mpc, M, a):
    return M.S.make_shares(mpc, [fxp(v) for v in np.asarray(a).reshape(-1)])


def _reveal(mpc, M, x):
    return M.S.reveal_ints(mpc, x.reshape(-1, x.shape[-1]))


def _floats(ints, shape):
    return np.array([tofloat(v) for v in ints]).reshape(shape)


def _sym_pd(n: int, seed: int) -> np.ndarray:
    """tests/test_mpc_linalg.py:73-75 at n = 3 and seed 3."""
    M = np.random.default_rng(seed).normal(size=(n, n)) * 0.3
    return M @ M.T / n + 0.6 * np.eye(n)


def _inv_sqrt_case(A, n):
    def case(mpc, M):
        # the function symmetrises: A / 2 in, (A/2 + A/2^T)^{-1} = A^{-1} out
        B = M.linalg.matrix_inverse_sqrt_svd(mpc, _shares(mpc, M, A / 2).reshape(n, n, -1))
        return B, _reveal(mpc, M, B)

    return case


@pytest.mark.parametrize("n,seed", [(3, 3)])
def test_matrix_inverse_sqrt_svd(n, seed):
    A = _sym_pd(n, seed)
    B = _floats(_both(_inv_sqrt_case(A, n))[1][1], (n, n))
    assert np.allclose(B.T @ B, np.linalg.inv(A), atol=5e-2), B.T @ B


@pytest.mark.parametrize("n,seed", [(3, 4)])
def test_matrix_inverse_sym_pos(n, seed):
    A = _sym_pd(n, seed)

    def case(mpc, M):
        a_inv, a_inv_sqrt = M.linalg.matrix_inverse_sym_pos(
            mpc, _shares(mpc, M, A).reshape(n, n, -1))
        return a_inv, a_inv_sqrt, _reveal(mpc, M, a_inv), _reveal(mpc, M, a_inv_sqrt)

    res = _both(case)[1]
    a_inv, w = _floats(res[2], (n, n)), _floats(res[3], (n, n))
    assert np.allclose(a_inv, np.linalg.inv(A), atol=5e-2), a_inv
    assert np.allclose(w.T @ w, np.linalg.inv(A), atol=5e-2)


@pytest.mark.parametrize("n,seed", [(3, 7)])
def test_matrix_inverse_svd(n, seed):
    """A general (non-symmetric) matrix, tests/test_mpc_linalg.py:104-120."""
    A = np.eye(n) * 1.1 + np.random.default_rng(seed).normal(size=(n, n)) * 0.25

    def case(mpc, M):
        a_inv = M.linalg.matrix_inverse_svd(mpc, _shares(mpc, M, A).reshape(n, n, -1))
        return a_inv, _reveal(mpc, M, a_inv)

    got = _floats(_both(case)[1][1], (n, n))
    assert np.abs(got - np.linalg.inv(A)).max() < 5e-2, got - np.linalg.inv(A)


LAM = np.array([112.0, 90.0, 64.0, 45.0, 30.0, 20.0])  # the example's range


def test_example_range_through_the_inverse():
    U = np.linalg.qr(np.random.default_rng(9).normal(size=(6, 6)))[0]
    A = U @ np.diag(LAM) @ U.T
    B = _floats(_both(_inv_sqrt_case(A, 6))[1][1], (6, 6))
    assert np.abs(B.T @ B @ A - np.eye(6)).max() < 5e-2, B.T @ B @ A
