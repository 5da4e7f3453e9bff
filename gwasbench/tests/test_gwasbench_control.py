"""The control: the program with the secret-sharing fixed point one step
below the configuration's (control.FRAC_BITS in place of mpc_frac_bits),
driven through the harness on the CPU at the test size and judged by the
cell's own limits, on three seeds.  It has to come out not correct."""

import pytest

from gwasbench import control
from gwasbench.tests import helpers


@pytest.mark.parametrize("cell", ["local.assoc", "tcp.assoc", "local.std_inv"])
@pytest.mark.parametrize("seed", [11, 2**31 + 5, 987654321])
def test_control_is_not_correct(tmp_path, cell, seed):
    root = helpers.make_root(tmp_path)
    out = control.control(root, helpers.bench_of(root), cell, seed, device="cpu")
    assert not out["correct"], out
    assert out["failed"] == out["attempted"] == 1
