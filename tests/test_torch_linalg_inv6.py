"""Port parity at 6 x 6 (the logistic path's size with the example's 5
covariates and the ones column) of matrix_inverse_sym_pos and
matrix_inverse_svd, as tests/test_torch_linalg_inv.py holds them at 3 x 3:
bit-equal shares at every party, the revealed inverses within 5e-2."""

import numpy as np
import pytest

from test_torch_linalg_inv import _floats, _reveal, _shares, _sym_pd
from test_torch_mpc import _both

from test_torch_householder_band import ref_householder_repaired  # noqa: F401

# the port's Householder brings x to unit scale first (ROADMAP C): the JAX
# package's runs with the same repair here
pytestmark = pytest.mark.usefixtures("ref_householder_repaired")


def test_matrix_inverse_sym_pos_6x6():
    A = _sym_pd(6, 6)

    def case(mpc, M):
        a_inv, a_inv_sqrt = M.linalg.matrix_inverse_sym_pos(
            mpc, _shares(mpc, M, A).reshape(6, 6, -1))
        return a_inv, a_inv_sqrt, _reveal(mpc, M, a_inv), _reveal(mpc, M, a_inv_sqrt)

    res = _both(case)[1]
    a_inv, w = _floats(res[2], (6, 6)), _floats(res[3], (6, 6))
    assert np.allclose(a_inv, np.linalg.inv(A), atol=5e-2), a_inv
    assert np.allclose(w.T @ w, np.linalg.inv(A), atol=5e-2)


def test_matrix_inverse_svd_6x6():
    A = np.eye(6) * 1.1 + np.random.default_rng(8).normal(size=(6, 6)) * 0.25 / np.sqrt(2)

    def case(mpc, M):
        a_inv = M.linalg.matrix_inverse_svd(mpc, _shares(mpc, M, A).reshape(6, 6, -1))
        return a_inv, _reveal(mpc, M, a_inv)

    got = _floats(_both(case)[1][1], (6, 6))
    assert np.abs(got - np.linalg.inv(A)).max() < 5e-2, got - np.linalg.inv(A)
