"""Port parity: the secret-shared eigensolver of sfgwas_tpu_torch
(mpc/linalg.py: householder, qr_fact_square, tridiag, eigen_decomp, swap,
sort_rows_descend) against sfgwas_tpu's, three parties of each package
(dealer 0, data parties 1 and 2) on the 256-bit field, from the same PRG
keys and local generators (the harness of tests/test_torch_mpc.py).

Every share every party holds must be bit-equal to the reference's; the
revealed values are held to numpy as tests/test_mpc_linalg.py:28 and :47
hold the reference: eigenvalues within 3e-2 of numpy's eigh, V V^T = I and
A v = lambda v within 5e-2, the factorisations within 2e-2."""

import numpy as np
import pytest

from test_torch_mpc import _both, fxp, tofloat

from test_torch_householder_band import ref_householder_repaired  # noqa: F401

# the port's Householder brings x to unit scale first (ROADMAP C): the JAX
# package's runs with the same repair here
pytestmark = pytest.mark.usefixtures("ref_householder_repaired")


def _sym(n: int, seed: int) -> np.ndarray:
    """A symmetric positive definite n x n matrix with eigenvalues O(1)."""
    M = np.random.default_rng(seed).normal(size=(n, n)) * 0.4
    return M @ M.T / n + 0.5 * np.eye(n)


def _shares(mpc, M, a):
    return M.S.make_shares(mpc, [fxp(v) for v in np.asarray(a).reshape(-1)])


def _reveal(mpc, M, x):
    return M.S.reveal_ints(mpc, x.reshape(-1, x.shape[-1]))


def _floats(ints, shape):
    return np.array([tofloat(v) for v in ints]).reshape(shape)


def test_householder():
    """The unit Householder vector v of x: (I - 2 v v^T) x = -sign(x0) |x| e1."""
    x = np.array([0.6, -0.3, 0.8, 0.1])

    def case(mpc, M):
        v = M.linalg.householder(mpc, _shares(mpc, M, x).reshape(4, -1))
        return v, _reveal(mpc, M, v)

    v = _floats(_both(case)[1][1], (4,))
    assert abs(v @ v - 1) < 2e-2, v
    hx = x - 2 * v * (v @ x)
    want = np.zeros(4)
    want[0] = -np.sign(x[0]) * np.linalg.norm(x)
    assert np.allclose(hx, want, atol=2e-2), hx


def test_qr_fact_square():
    """4 x 4: Q orthonormal and R Q = A with R lower triangular (the Go
    sfgwas reflects rows, tests/test_mpc_linalg.py:28-44)."""
    A = _sym(4, 3) + np.triu(np.full((4, 4), 0.2))

    def case(mpc, M):
        Q, Rm = M.linalg.qr_fact_square(mpc, _shares(mpc, M, A).reshape(4, 4, -1))
        return Q, Rm, _reveal(mpc, M, Q), _reveal(mpc, M, Rm)

    res = _both(case)[1]
    Q, Rm = _floats(res[2], (4, 4)), _floats(res[3], (4, 4))
    assert np.allclose(Q @ Q.T, np.eye(4), atol=2e-2)
    assert np.allclose(Rm, np.tril(Rm), atol=2e-2), Rm
    assert np.allclose(Rm @ Q, A, atol=2e-2), Rm @ Q


def test_tridiag():
    """6 x 6: T symmetric tridiagonal with T = Q^T A Q, Q orthonormal."""
    A = _sym(6, 5)

    def case(mpc, M):
        T, Q = M.linalg.tridiag(mpc, _shares(mpc, M, A).reshape(6, 6, -1))
        return T, Q, _reveal(mpc, M, T), _reveal(mpc, M, Q)

    res = _both(case)[1]
    T, Q = _floats(res[2], (6, 6)), _floats(res[3], (6, 6))
    band = np.abs(np.subtract.outer(np.arange(6), np.arange(6))) <= 1
    assert np.allclose(T[~band], 0, atol=1e-9)
    assert np.allclose(T, T.T, atol=2e-2)
    assert np.allclose(Q.T @ Q, np.eye(6), atol=2e-2)
    assert np.allclose(Q.T @ A @ Q, T, atol=2e-2), Q.T @ A @ Q - T


def _eigen_case(A, n):
    def case(mpc, M):
        V, L = M.linalg.eigen_decomp(mpc, _shares(mpc, M, A).reshape(n, n, -1))
        Vs, Ls = M.linalg.sort_rows_descend(mpc, V, L)
        return V, L, Vs, Ls, _reveal(mpc, M, Vs), M.S.reveal_ints(mpc, Ls)

    return case


def _check_eigen(A, res, n):
    V, L = _floats(res[4], (n, n)), _floats(res[5], (n,))
    w = np.linalg.eigh(A)[0][::-1]  # descending
    assert np.all(np.diff(L) <= 1e-9), L  # sorted
    assert np.allclose(L, w, atol=3e-2), (L, w)
    assert np.allclose(V @ V.T, np.eye(n), atol=5e-2)
    for i in range(n):
        assert np.linalg.norm(A @ V[i] - L[i] * V[i]) < 5e-2, i


def test_eigen_decomp_and_sort_4x4():
    """tests/test_mpc_linalg.py:47-68."""
    A = _sym(4, 7)
    _check_eigen(A, _both(_eigen_case(A, 4))[1], 4)


def test_eigen_decomp_and_sort_6x6():
    A = _sym(6, 9)
    _check_eigen(A, _both(_eigen_case(A, 6))[1], 6)


def test_swap_and_sort_rows_descend():
    """swap exchanges two shared rows exactly when the shared bit is 1;
    sort_rows_descend orders the rows of A by w, largest first."""
    a, b = np.array([1.5, -2.0, 0.25]), np.array([-0.5, 3.0, 1.0])
    A = np.arange(20, dtype=float).reshape(5, 4) / 8
    w = np.array([0.3, -1.2, 2.5, 0.7, 0.0])

    def case(mpc, M):
        sa, sb = _shares(mpc, M, a).reshape(3, -1), _shares(mpc, M, b).reshape(3, -1)
        out = []
        for bit in (0, 1):
            flip = M.S.make_shares(mpc, [bit])[0]
            out.append(M.linalg.swap(mpc, sa, sb, flip))
        As, ws = M.linalg.sort_rows_descend(
            mpc, _shares(mpc, M, A).reshape(5, 4, -1), _shares(mpc, M, w).reshape(5, -1))
        rev = [M.S.reveal_ints(mpc, x) for pair in out for x in pair]
        return out, As, ws, rev, _reveal(mpc, M, As), M.S.reveal_ints(mpc, ws)

    res = _both(case)[1]
    s00, s01, s10, s11 = [_floats(r, (3,)) for r in res[3]]
    assert np.allclose(s00, a) and np.allclose(s01, b)
    assert np.allclose(s10, b) and np.allclose(s11, a)
    order = np.argsort(-w)
    assert np.allclose(_floats(res[5], (5,)), w[order], atol=1e-6)
    assert np.allclose(_floats(res[4], (5, 4)), A[order], atol=1e-6)
