"""The logistic study through the port's CLI (sfgwas_tpu_torch/cli.py,
--local-sim 3 on the CPU at TEST8) against one run of the reference's own
protocol (sfgwas_tpu/gwas/protocol.py::ProtocolInfo) on the same data and
config: tests/test_e2e_gwas.py's logistic study (make_logistic_data: 24
and 20 individuals, 50 SNPs in 2 blocks, 2 covariates, a binary phenotype)
with its flags (tests/test_e2e_gwas.py:77-82: use_logistic, degree 15 on
[-6, 6], 3 epochs), skip_pca, the scan QC route and shard_matmult off in
both packages (the reference's own test_e2e_logistic shards its products;
ROADMAP C).

The port's parties restore the reference's key directories
(use_cached_keys), and in both runs each party's local randomness (its
PRG, which the dealer's secret draws come from, and its encryption
generator) is seeded alike as phase 3 starts, so the two runs draw the
same noise in the logistic phase: the port reveals the reference's SNP filter,
its assoc.txt lies within 1e-6 of the reference's, and both correlate
above 0.95 with the exact-Newton oracle (oracle_logistic_score, the
reference's own bound).  (Unseeded, the two runs' statistics differ by
their CKKS and truncation noise, a few 1e-6 at TEST8.)

A third run is the port with the reference's e2e sharding setting
(shard_matmult = true, tests/test_e2e_gwas.py:70-72) over three logical
CPU shards: every product takes the sharded branch, and the statistics
are the unsharded run's bit for bit."""

import os
import shutil

import numpy as np
import pytest
import torch

from sfgwas_tpu.gwas import protocol as RP
from sfgwas_tpu_torch.gwas import assoc as PA
from sfgwas_tpu_torch.gwas import matmult as PMM
from sfgwas_tpu_torch.gwas import protocol as PP
from test_e2e_gwas import make_logistic_data, oracle_logistic_score
from test_torch_protocol import _Counter, read_run, run_cli, write_config
from test_torch_protocol_ref import run_reference

from test_torch_householder_band import ref_householder_repaired  # noqa: F401

# the port's Householder brings x to unit scale first (ROADMAP C): the JAX
# package's runs with the same repair here
pytestmark = pytest.mark.usefixtures("ref_householder_repaired")

LOGISTIC = dict(use_logistic=True, epochs=3, degree=15, A=-6.0, B=6.0, use_cached_keys=True)
SAME_TOL, MIN_CORR = 1e-6, 0.95


def _seed_phase3(mp, module):
    """Each party's local PRG and encryption generator seeded by its pid as
    phase 3 starts."""
    real = module.ProtocolInfo.phase3

    def seeded(self, qpc):
        table = self.net.rand.table
        for k in table:  # the global stream, each pair's, the party's own
            a, b = (-1, -1) if k < 0 else sorted((k, self.pid))
            table[k] = np.random.Generator(np.random.Philox(key=[9, 100 * (a + 2) + b + 2]))
        self.cps.enc_rng = np.random.default_rng(100 + self.pid)
        return real(self, qpc)

    mp.setattr(module.ProtocolInfo, "phase3", seeded)


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("logistic_study"))
    data = make_logistic_data(root, np.random.default_rng(55))
    rcache, rout = os.path.join(root, "ref_cache"), os.path.join(root, "ref_out")
    mp = pytest.MonkeyPatch()
    try:
        _seed_phase3(mp, RP)
        run_reference(write_config(os.path.join(root, "ref.toml"), root, rcache, rout,
                                   **LOGISTIC))
    finally:
        mp.undo()
    cache, out = os.path.join(root, "cache"), os.path.join(root, "out")
    for pid in (0, 1, 2):
        shutil.copytree(os.path.join(rcache, f"party{pid}", "keys.npz.d"),
                        os.path.join(cache, f"party{pid}", "keys.npz.d"))
    return root, data, rcache, rout, cache, out


@pytest.fixture(scope="module")
def port_run(study):
    root, data, rcache, rout, cache, out = study
    mp = pytest.MonkeyPatch()
    try:
        _seed_phase3(mp, PP)
        newton = _Counter(mp, PA, "lr_newton_cov_only")
        score = _Counter(mp, PA, "gwy_score_test")
        run_cli(write_config(os.path.join(root, "port.toml"), root, cache, out, **LOGISTIC))
    finally:
        mp.undo()
    return newton.n, score.n


@pytest.fixture(scope="module")
def sharded_run(study, port_run):
    """The port again, shard_matmult on over [cpu] * 3 (the party's local
    devices, three logical shards), seeded as port_run."""
    root, data, rcache, rout, cache, out = study
    scache, sout = os.path.join(root, "cache_sharded"), os.path.join(root, "out_sharded")
    for pid in (0, 1, 2):
        shutil.copytree(os.path.join(cache, f"party{pid}", "keys.npz.d"),
                        os.path.join(scache, f"party{pid}", "keys.npz.d"))
    mp = pytest.MonkeyPatch()
    try:
        _seed_phase3(mp, PP)
        mp.setattr(PP, "local_devices", lambda kind: [torch.device(kind)] * 3)
        routed = []
        real = PMM._MatmulPlan.groups
        mp.setattr(PMM._MatmulPlan, "groups",
                   lambda self, devices=None: routed.append(devices) or real(self, devices))
        products = _Counter(mp, PMM, "mat_mult_cached")
        run_cli(write_config(os.path.join(root, "sharded.toml"), root, scache, sout,
                             shard_matmult=True, **LOGISTIC))
    finally:
        mp.undo()
        PMM.set_pipeline_devices(None)
    return sout, scache, routed, products.n


def test_sharded_statistics_equal_unsharded(study, port_run, sharded_run):
    root, data, rcache, rout, cache, out = study
    sout, scache, routed, products = sharded_run
    # every product took the sharded branch
    assert len(routed) == products > 0
    assert all(d == [torch.device("cpu")] * 3 for d in routed)
    for pid in (1, 2):
        got, gk = read_run(sout, scache, pid)
        want, wgk = read_run(out, cache, pid)
        assert np.array_equal(gk, wgk)
        assert np.array_equal(got, want)


def test_port_runs_the_logistic_path(study, port_run):
    assert port_run == (3, 3)  # every party, once each


def test_filter_equals_reference(study, port_run):
    root, data, rcache, rout, cache, out = study
    for pid in (0, 1, 2):
        np.testing.assert_array_equal(
            np.loadtxt(os.path.join(cache, f"party{pid}", "gkeep.txt")),
            np.loadtxt(os.path.join(rcache, f"party{pid}", "gkeep.txt")))


def test_statistics_equal_reference(study, port_run):
    root, data, rcache, rout, cache, out = study
    for pid in (1, 2):
        got, want = read_run(out, cache, pid)[0], read_run(rout, rcache, pid)[0]
        assert got.shape == want.shape and np.isfinite(got).all()
        assert np.abs(got - want).max() < SAME_TOL, np.abs(got - want).max()


@pytest.mark.parametrize("which", ["port", "reference"])
def test_statistics_correlate_with_oracle(study, port_run, which):
    """tests/test_e2e_gwas.py:307-322."""
    root, data, rcache, rout, cache, out = study
    o, c = (out, cache) if which == "port" else (rout, rcache)
    got, gk = read_run(o, c, 1)
    want = oracle_logistic_score(data, gk)
    assert got.shape == want.shape
    assert np.corrcoef(got, want)[0, 1] > MIN_CORR
