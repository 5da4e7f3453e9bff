"""A mixed deployment: parties of both packages in one protocol over
loopback TCP, each its own process on the CPU at TEST8 on
tests/test_torch_protocol.py's study with the scan QC route (which both
packages run alike; ROADMAP C: the count route filters the streams in the
port only).  Here the reference's dealer 0 and hub 1 (`python -m
sfgwas_tpu.cli --platform cpu`) run with the port's party 2 (`python -m
sfgwas_tpu_torch.cli --platform cpu`); tests/test_torch_mixed_tcp_hub.py
runs the other split.  Every message crosses the wire between the
packages: the collective keygen, QC's MPC, the covariate basis, the block
products' aggregation and refreshes, the std inverse and the decrypt.

The revealed filter equals the plaintext QC oracle at every party, each
data party's statistics lie within 2e-2 of the plaintext oracle (corr >
0.999), and the two data parties' statistics within 2e-3 of each other."""

import os

import numpy as np

from test_e2e_gwas import oracle_qc
from test_torch_protocol import RESUME_TOL, assert_oracle, read_run, write_study
from test_torch_tcp_study import assert_all_ok, port_cmd, ref_cmd, run_processes, write_tcp_configs


def run_mixed(tmp_path, packages):
    """One study, party p run by packages[p] ("ref" or "port"), each its
    own process over loopback TCP; checked against the oracles."""
    root = str(tmp_path)
    data = write_study(root)
    cache, out = os.path.join(root, "cache"), os.path.join(root, "out")
    cfgs = write_tcp_configs(root, "mixed", cache, out)
    cmd = {"ref": ref_cmd, "port": port_cmd}
    res = run_processes([cmd[k](c) for k, c in zip(packages, cfgs)], root)
    assert_all_ok(res)
    want = oracle_qc(data)
    for pid in (0, 1, 2):
        np.testing.assert_array_equal(
            np.loadtxt(os.path.join(cache, f"party{pid}", "gkeep.txt")).astype(bool), want)
    assert_oracle(data, out, cache)
    s1, s2 = read_run(out, cache, 1)[0], read_run(out, cache, 2)[0]
    assert s1.shape == s2.shape and np.abs(s1 - s2).max() < RESUME_TOL


def test_reference_dealer_and_hub_with_port_party(tmp_path):
    run_mixed(tmp_path, ["ref", "ref", "port"])
