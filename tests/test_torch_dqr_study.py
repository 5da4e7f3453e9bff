"""The study with qr_method = "householder" through the port's CLI
(sfgwas_tpu_torch/cli.py, --local-sim 3 on the CPU at TEST8) against one
run of the reference's own protocol (tests/test_torch_protocol_ref.py's
run_reference) with the same setting: tests/test_torch_protocol.py's study
(24 and 20 individuals, 50 SNPs in 2 blocks, 2 covariates, skip_pca, the
scan-QC route), so the covariate basis of phase 3 is gwas/qrfact.py::
net_dqr_enc in both packages.

The two packages' keys differ, so their decryption noise differs: the
port's run must reveal the reference's SNP filter and land within 2e-3 of
its statistics (tests/test_torch_protocol_ref.py's bound), and within the
plaintext oracle's bounds (2e-2, corr > 0.999)."""

import os

import numpy as np
import pytest

from sfgwas_tpu.gwas import qrfact as RQ
from sfgwas_tpu_torch.gwas import qrfact as PQ
from test_torch_protocol import (
    RESUME_TOL, _Counter, assert_oracle, read_run, run_cli, write_config, write_study,
)
from test_torch_protocol_ref import run_reference

HH = dict(qr_method="householder")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hh_study"))
    data = write_study(root)
    dirs = {k: (os.path.join(root, f"{k}_cache"), os.path.join(root, f"{k}_out"))
            for k in ("ref", "port")}
    with pytest.MonkeyPatch.context() as mp:
        calls = {"ref": _Counter(mp, RQ, "net_dqr_enc"), "port": _Counter(mp, PQ, "net_dqr_enc")}
        run_reference(write_config(os.path.join(root, "ref.toml"), root, *dirs["ref"], **HH))
        run_cli(write_config(os.path.join(root, "port.toml"), root, *dirs["port"], **HH))
    return data, dirs, {k: c.n for k, c in calls.items()}


def test_both_packages_ran_householder(runs):
    # one QR (the covariate basis), run by each of the three parties
    assert runs[2] == {"ref": 3, "port": 3}


def test_port_cli_matches_reference_run(runs):
    data, dirs, _ = runs
    (rcache, rout), (cache, out) = dirs["ref"], dirs["port"]
    for pid in (0, 1, 2):
        np.testing.assert_array_equal(
            np.loadtxt(os.path.join(cache, f"party{pid}", "gkeep.txt")),
            np.loadtxt(os.path.join(rcache, f"party{pid}", "gkeep.txt")))
    for pid in (1, 2):
        got, want = read_run(out, cache, pid)[0], read_run(rout, rcache, pid)[0]
        assert got.shape == want.shape and np.isfinite(got).all()
        assert np.abs(got - want).max() < RESUME_TOL


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_householder_study_matches_oracle(runs, pkg):
    data, dirs, _ = runs
    cache, out = dirs[pkg]
    assert_oracle(data, out, cache)
