"""The Householder parity and contract tests of tests/test_torch_dqr.py at
TEST10, where the QR band (9) lies below the top of the chain (13): every
refresh of the QR is a scale reset, the branch PN14QP438 runs (TEST8 runs
the drift branch).  nrows_all = [0, 600, 200]: 2 ciphertexts of 512 slots a
column at party 1 and 1 at party 2.  The tests are imported, and run here
under this file's `case`."""

import pytest
from test_torch_dqr import (  # noqa: F401  (fixtures and tests run in this module)
    dqr,
    test_net_dqr_enc_ciphertexts_match_reference,
    test_net_dqr_enc_matches_numpy_qr,
    test_net_dqr_enc_orthonormalizes,
)
from test_torch_qr import CASES, ref_keys  # noqa: F401


@pytest.fixture(scope="module")
def case():
    return CASES["TEST10"]
