"""chip_smoke.logistic_oracle, the plaintext oracle of the logistic study
(phase 13), against a plaintext transcription of the reference's own
arithmetic: lr_newton_cov_only and gwy_score_test
(sfgwas_tpu/gwas/assoc.py:420-700) in their variables (the orthonormal
basis Cm, C_scaled = sqrt(n) Cm, the Hessian scaled by inverse_mat_scale / n
and inverted through B^T B = (A + A^T)^-1, scale_back, o = Wz (Z^T W Z)^-1
Z^T y~ / n) with the exact sigmoid.  Before convergence the statistic's
numerator is g^T (y~ - o), not g^T y~."""

import numpy as np
import pytest

import chip_smoke as cs

IMS = 10_000.0  # config/configGlobalLogistic.toml's inverse_mat_scale


def reference_arithmetic(data, keep, epochs):
    G = np.concatenate([data[1][0], data[2][0]])[:, keep].astype(np.float64)
    G[G < 0] = 0.0
    y = np.concatenate([data[1][1], data[2][1]])
    cov = np.concatenate([data[1][2], data[2][2]])
    n = len(y)
    # compute_combined_q: the QR of [ones | covariates], the first column
    # the normalised ones; Cm = Q / sqrt(n) with Q's columns sqrt(n)-scaled
    Cm, _ = np.linalg.qr(np.column_stack([np.ones(n), cov]))
    Cm[:, 0] = 1.0 / np.sqrt(n)
    C_scaled = Cm * np.sqrt(n)

    def grad_and_inv_hessian(weights, skip_intercept):
        p = 1 / (1 + np.exp(-(np.zeros(n) if skip_intercept else Cm @ weights)))
        y_tilde = y - p
        w_vec = p - p * p
        Wz = C_scaled * w_vec[:, None]
        ztwz = (Cm.T @ Wz) / (n / IMS)
        lam, V = np.linalg.eigh(ztwz + ztwz.T)
        B = (V / np.sqrt(lam)).T  # B^T B = (A + A^T)^-1
        BT = B.T * np.sqrt(IMS * 2 / np.sqrt(n))
        return Cm.T @ y_tilde, BT @ BT.T, BT, Wz, y_tilde, w_vec

    weights = np.zeros(Cm.shape[1])
    for i in range(epochs):
        grad, inv_hess, *_ = grad_and_inv_hessian(weights, i == 0)
        weights = weights + inv_hess @ grad
    _, inv_hess, BT, Wz, y_tilde, w_vec = grad_and_inv_hessian(weights, False)
    o = (Wz @ inv_hess) @ (C_scaled.T @ y_tilde) / n
    gTW2g = ((G.T @ (Wz @ BT)) ** 2).sum(1) / n
    denom = (G * G).T @ w_vec - gTW2g
    return (G.T @ y_tilde - G.T @ o) / np.sqrt(denom), G.T @ y_tilde / np.sqrt(denom)


@pytest.mark.parametrize("epochs", [1, 2, 3])
def test_oracle_is_the_reference_arithmetic(epochs):
    data = cs._logistic_data(0, 300, 200)
    keep = cs.assoc_qc_oracle(data, cs.ASSOC_FILTER, 300)
    want, without_o = reference_arithmetic(data, keep, epochs)
    got = cs.logistic_oracle(data, keep, epochs)
    assert got.shape == want.shape == (keep.sum(),)
    assert np.abs(got - want).max() < 1e-9
    if epochs <= 2:  # far from convergence the o term matters
        assert np.abs(without_o - want).max() > 1e-3
