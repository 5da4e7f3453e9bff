"""The port's whole protocol over byte frames and over TCP, on the CPU at
TEST8 on tests/test_torch_protocol.py's study (24 and 20 individuals, 50
SNPs in 2 blocks, 2 covariates, skip_pca, linear association):

* the CLI's three local-sim parties over a transport that serializes every
  message (the codec path a socket runs: tensors arrive as numpy arrays,
  residues as <u4), fresh and resumed, held to the oracles and to a
  zero-copy run of the same study;
* three `python -m sfgwas_tpu_torch.cli` processes, one a party (the PID
  environment variable, --platform cpu, the global config's
  [servers.partyN] mesh on loopback ports the OS hands out at run time),
  fresh and then resumed from their caches;
* a party that fails after the mesh is up (party 2's plink2 count file is
  cut short, so its QC fails after the keygen): every process exits
  nonzero, well before any transport or test timeout.

The helpers here (the per-party configs, the process runner) are imported
by the mixed-deployment tests."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

import chip_smoke
from sfgwas_tpu_torch.gwas import matmult as PMM
from sfgwas_tpu_torch.parallel import transport as PT
from test_e2e_gwas import oracle_qc
from test_torch_protocol import (
    RESUME_TOL, _Counter, assert_oracle, read_run, run_cli, write_config, write_study,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTY_TIMEOUT_S = 170  # one party process, start to exit


def write_tcp_configs(root: str, tag: str, cache: str, out: str, **flags) -> list:
    """write_config's study and flags split for one process a party
    (chip_smoke.tcp_configs): a global config binding to 127.0.0.1 with a
    fresh [servers.partyN] map on free loopback ports, and one local config
    a party with its own paths ({pid} replaced, the dealer with party 1's)
    and its cache and output directories cache/party{p}, out/party{p}.
    Returns [(global, local)] by pid."""
    g = write_config(os.path.join(root, f"{tag}.toml"), root, cache, out, **flags)
    return chip_smoke.tcp_configs(root, g, tag)


def port_cmd(cfg) -> list:
    return [sys.executable, "-m", "sfgwas_tpu_torch.cli", "--platform", "cpu",
            "--config-global", cfg[0], "--config-local", cfg[1]]


def ref_cmd(cfg) -> list:
    return [sys.executable, "-m", "sfgwas_tpu.cli", "--platform", "cpu",
            "--config-global", cfg[0], "--config-local", cfg[1]]


def run_processes(cmds, log_dir: str, timeout: float = PARTY_TIMEOUT_S) -> list:
    """One process a party (cmds[pid], with PID=pid), all started together;
    waits for all of them within timeout seconds and kills any left.
    Returns [(exit code, seconds from the start, log path)] by pid."""
    # one compute thread a process: three processes with a thread pool each
    # as wide as the host would take turns at a crawl
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    procs, logs, t0 = [], [], time.time()
    try:
        for pid, cmd in enumerate(cmds):
            path = os.path.join(log_dir, f"party{pid}.log")
            logs.append(path)
            with open(path, "w") as f:
                procs.append(subprocess.Popen(cmd, cwd=REPO, env=dict(env, PID=str(pid)),
                                              stdout=f, stderr=subprocess.STDOUT))
        ends = [None] * len(procs)
        while any(e is None for e in ends) and time.time() - t0 < timeout:
            for pid, p in enumerate(procs):
                if ends[pid] is None and p.poll() is not None:
                    ends[pid] = time.time() - t0
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return [(p.returncode, ends[pid], logs[pid]) for pid, p in enumerate(procs)]


def tail(path: str, n: int = 3000) -> str:
    with open(path) as f:
        return f.read()[-n:]


def assert_all_ok(res):
    for pid, (rc, secs, log) in enumerate(res):
        assert rc == 0 and secs is not None, f"party {pid} rc {rc}:\n{tail(log)}"


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tcp_study"))
    return root, write_study(root)


@pytest.fixture(scope="module")
def zero_copy_run(study):
    root, data = study
    cache, out = os.path.join(root, "zc_cache"), os.path.join(root, "zc_out")
    run_cli(write_config(os.path.join(root, "zc.toml"), root, cache, out))
    return cache, out


class Framed(PT.LocalTransport):
    """The in-process mesh with the codec of a socket: every message is
    encoded and decoded."""

    zero_copy = False


def test_study_over_byte_frames(study, zero_copy_run, monkeypatch):
    """The whole study through the CLI with every message encoded and
    decoded, fresh and resumed: the filter is the oracle's, the statistics
    are within 2e-2 of the oracle (corr > 0.999) and within 2e-3 of the
    zero-copy run."""
    root, data = study
    monkeypatch.setattr(PT.LocalCluster, "transport",
                        lambda self, pid, channel=0: Framed(self, pid, channel))
    frames = _Counter(monkeypatch, PT, "decode")
    cache, out = os.path.join(root, "fr_cache"), os.path.join(root, "fr_out")
    run_cli(write_config(os.path.join(root, "fr.toml"), root, cache, out, use_cached_keys=True))
    assert frames.n > 1000
    out2 = os.path.join(root, "fr_out_resumed")
    mm = _Counter(monkeypatch, PMM, "mat_mult_stream")
    run_cli(write_config(os.path.join(root, "fr_res.toml"), root, cache, out2,
                         use_cached_keys=True, use_cached_qc=True, use_cached_combined_q=True))
    assert mm.n == 0
    zc_cache, zc_out = zero_copy_run
    for pid in (1, 2):
        got, gkeep = read_run(out, cache, pid)
        np.testing.assert_array_equal(gkeep, oracle_qc(data))
        want = read_run(zc_out, zc_cache, pid)[0]
        assert got.shape == want.shape and np.abs(got - want).max() < RESUME_TOL
        again = read_run(out2, cache, pid)[0]
        assert again.shape == got.shape and np.abs(again - got).max() < RESUME_TOL
    assert_oracle(data, out, cache)
    assert_oracle(data, out2, cache)


def test_three_cli_processes_over_tcp(study, zero_copy_run, tmp_path):
    """PID=p python -m sfgwas_tpu_torch.cli --platform cpu, one process a
    party over loopback TCP, fresh, then resumed from the caches."""
    root, data = study
    cache, out = str(tmp_path / "cache"), str(tmp_path / "out")
    res = run_processes([port_cmd(c) for c in write_tcp_configs(
        root, "tcp", cache, out, use_cached_keys=True)], str(tmp_path))
    assert_all_ok(res)
    assert_oracle(data, out, cache)
    zc_cache, zc_out = zero_copy_run
    for pid in (1, 2):
        np.testing.assert_array_equal(read_run(out, cache, pid)[1], oracle_qc(data))
        got, want = read_run(out, cache, pid)[0], read_run(zc_out, zc_cache, pid)[0]
        assert got.shape == want.shape and np.abs(got - want).max() < RESUME_TOL
    # every party logged its traffic to each peer
    for pid, (_, _, log) in enumerate(res):
        text = tail(log, 100_000)
        for peer in set(range(3)) - {pid}:
            assert f"[net pid={pid}] peer {peer}: sent" in text
    # resumed: every party restores its keys from its key directory
    out2 = str(tmp_path / "out_resumed")
    (tmp_path / "resumed").mkdir()
    res2 = run_processes([port_cmd(c) for c in write_tcp_configs(
        root, "tcp_res", cache, out2, use_cached_keys=True, use_cached_qc=True,
        use_cached_combined_q=True)], str(tmp_path / "resumed"))
    assert_all_ok(res2)
    for pid, (_, _, log) in enumerate(res2):
        assert f"pid{pid} keys restored from" in tail(log, 200_000), tail(log)
    for pid in (1, 2):
        first, second = read_run(out, cache, pid)[0], read_run(out2, cache, pid)[0]
        assert second.shape == first.shape and np.abs(second - first).max() < RESUME_TOL
    assert_oracle(data, out2, cache)


def test_failing_party_fails_every_process(study, tmp_path):
    """Party 2's count file is cut short: its QC raises after the mesh is
    up and the keys are made.  Party 2 exits nonzero, its connections close,
    and the other two processes fail at their next receive: all three exit
    nonzero within seconds of each other, long before the party timeout."""
    root, data = study
    bad = tmp_path / "gcount_short.bin"
    with open(os.path.join(root, "party2", "gcount.bin"), "rb") as f:
        bad.write_bytes(f.read()[:100])
    cfgs = write_tcp_configs(root, "fail", str(tmp_path / "cache"), str(tmp_path / "out"),
                             use_precomputed_geno_count=True)
    with open(cfgs[2][1]) as f:
        text = f.read().replace(os.path.join(root, "party2", "gcount.bin"), str(bad))
    with open(cfgs[2][1], "w") as f:
        f.write(text)
    res = run_processes([port_cmd(c) for c in cfgs], str(tmp_path))
    for pid, (rc, secs, log) in enumerate(res):
        assert rc not in (0, None) and secs is not None, f"party {pid} rc {rc}:\n{tail(log)}"
    assert "ValueError" in tail(res[2][2], 20_000) or "reshape" in tail(res[2][2], 20_000)
    for pid in (0, 1):
        assert "ConnectionError" in tail(res[pid][2], 20_000), tail(res[pid][2])
    assert max(s for _, s, _ in res) - res[2][1] < 30
    assert max(s for _, s, _ in res) < PARTY_TIMEOUT_S / 2
