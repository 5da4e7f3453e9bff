"""The port's CLI against one run of the reference's own protocol
(sfgwas_tpu/gwas/protocol.py::ProtocolInfo, three party threads as
tests/test_e2e_gwas.py:99 run_protocol drives them) on the same TEST8
study and config (tests/test_torch_protocol.py's), with use_cached_keys.

The two packages' keys differ, so their decryption noise differs (under
shared keys the statistics are bit-equal, tests/test_torch_assoc_stats.py):
the port's fresh run must reveal the reference's SNP filter and land within
2e-3 of its statistics.  The port's CLI resumed on the reference's cache
directories (its key directories, filters, basis and block products) runs
no block product, rewrites no cache file and lands within 2e-3 of the
reference's statistics: the cross-package resume."""

import os
import threading

import numpy as np
import pytest

from sfgwas_tpu.gwas.protocol import ProtocolInfo as RefProtocolInfo
from sfgwas_tpu.parallel.transport import LocalCluster as RefLocalCluster
from sfgwas_tpu.utils import devlock
from sfgwas_tpu.utils.config import load_config as ref_load_config
from sfgwas_tpu_torch.gwas import matmult as PMM
from sfgwas_tpu_torch.mpc import mhe as PM
from test_torch_protocol import (
    RESUME_TOL, _Counter, assert_oracle, read_run, run_cli, write_config, write_study,
)


def run_reference(config: str):
    """The reference's three parties from the config, each with its {pid}
    paths and its own cache and output directories (as its CLI's local-sim
    sets them up)."""
    cluster = RefLocalCluster(3)
    errs = [None] * 3
    devlock.enable()  # the reference's party threads take turns on the jax runtime

    def work(pid):
        devlock.acquire()
        try:
            cfg = ref_load_config(config)
            for fld in ("geno_binary_file_prefix", "geno_block_size_file", "pheno_file",
                        "covar_file", "snp_position_file", "geno_count_file"):
                setattr(cfg, fld, getattr(cfg, fld).replace("{pid}", str(pid or 1)))
            cfg.cache_dir = os.path.join(cfg.cache_dir, f"party{pid}")
            cfg.output_dir = os.path.join(cfg.output_dir, f"party{pid}")
            prot = RefProtocolInfo(cfg, pid, transport=cluster.transport(pid))
            prot.gwas()
            prot.sync_and_terminate()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs[pid] = e
        finally:
            devlock.release()

    ts = [threading.Thread(target=work, args=(p,), daemon=True) for p in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=900)
    assert not any(t.is_alive() for t in ts)
    for e in errs:
        if e is not None:
            raise e


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ref_study"))
    data = write_study(root)
    cache, out = os.path.join(root, "ref_cache"), os.path.join(root, "ref_out")
    run_reference(write_config(os.path.join(root, "ref.toml"), root, cache, out,
                               use_cached_keys=True))
    return root, data, cache, out


def test_port_cli_matches_reference_run(reference):
    root, data, rcache, rout = reference
    cache, out = os.path.join(root, "cache"), os.path.join(root, "out")
    run_cli(write_config(os.path.join(root, "port.toml"), root, cache, out))
    for pid in (0, 1, 2):
        np.testing.assert_array_equal(
            np.loadtxt(os.path.join(cache, f"party{pid}", "gkeep.txt")),
            np.loadtxt(os.path.join(rcache, f"party{pid}", "gkeep.txt")))
    for pid in (1, 2):
        got, want = read_run(out, cache, pid)[0], read_run(rout, rcache, pid)[0]
        assert got.shape == want.shape
        assert np.abs(got - want).max() < RESUME_TOL
    assert_oracle(data, out, cache)


def test_port_cli_resumes_from_reference_caches(reference, monkeypatch):
    root, data, rcache, rout = reference
    files = {os.path.join(d, f) for d, _, fs in os.walk(rcache) for f in fs}
    before = {f: os.path.getmtime(f) for f in files}
    out = os.path.join(root, "out_resumed")
    mm = _Counter(monkeypatch, PMM, "mat_mult_stream")
    loads = _Counter(monkeypatch, PM, "_load_key_dir")
    run_cli(write_config(os.path.join(root, "resume.toml"), root, rcache, out,
                         use_cached_keys=True, use_cached_qc=True, use_cached_combined_q=True))
    assert mm.n == 0 and loads.n == 3
    after = {os.path.join(d, f) for d, _, fs in os.walk(rcache) for f in fs}
    assert after == files and {f: os.path.getmtime(f) for f in files} == before
    for pid in (1, 2):
        got, want = read_run(out, rcache, pid)[0], read_run(rout, rcache, pid)[0]
        assert got.shape == want.shape
        assert np.abs(got - want).max() < RESUME_TOL
    assert_oracle(data, out, rcache)
