"""The parity and contract tests of tests/test_torch_qr.py at TEST10, where
the QR band (9) lies below the top of the chain (13): every refresh of the
QR is a scale reset, the branch PN14QP438 runs (TEST8 runs the
drift-compensation branch).  nrows_all = [0, 600, 200]: 2 ciphertexts of 512
slots a column at party 1 and 1 at party 2.  The tests are imported, and
run here under this file's `case`."""

import pytest
from test_torch_qr import (  # noqa: F401  (fixtures and tests run in this module)
    CASES,
    cholqr,
    combined,
    ref_keys,
    test_combined_q_uniform_scale_and_level,
    test_compute_combined_q_ciphertexts_match_reference,
    test_net_cholqr_enc_ciphertexts_match_reference,
    test_net_cholqr_enc_matches_numpy_qr,
    test_net_cholqr_enc_orthonormalizes,
)


@pytest.fixture(scope="module")
def case():
    return CASES["TEST10"]
