"""The port's config, watchdog, protocol guards and CLI entry
(sfgwas_tpu_torch/utils/{config,watchdog}.py, gwas/protocol.py, cli.py)
against the reference on the CPU: every shipped config loads alike in both
packages, snp_distance_filtering equals the reference's, the watchdog runs
only under a memory limit, each part not ported yet raises naming its
ROADMAP item, the CLI refuses to start without a card unless asked for the
CPU, and a party's failure fails the CLI run at once."""

import dataclasses
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from sfgwas_tpu.gwas import protocol as RP
from sfgwas_tpu.utils import config as RCFG
from sfgwas_tpu.utils.watchdog import MemoryWatchdog as RefWatchdog
from sfgwas_tpu_torch import cli
from sfgwas_tpu_torch.gwas import protocol as PP
from sfgwas_tpu_torch.gwas import qrfact as PQR
from sfgwas_tpu_torch.parallel.transport import ClusterClosed, LocalCluster
from sfgwas_tpu_torch.utils import config as PCFG
from sfgwas_tpu_torch.utils.watchdog import MemoryWatchdog
from test_torch_protocol import write_config, write_study

CONFIG = Path(__file__).resolve().parent.parent / "config"
GLOBALS = sorted(p.name for p in CONFIG.glob("configGlobal*.toml"))
LOCALS = sorted(p.name for p in CONFIG.glob("configLocal*.toml"))


def test_shipped_configs_found():
    assert len(GLOBALS) >= 4 and len(LOCALS) >= 7
    assert [f.name for f in dataclasses.fields(PCFG.Config)] == [
        f.name for f in dataclasses.fields(RCFG.Config)]


@pytest.mark.parametrize("name", GLOBALS + LOCALS)
def test_config_loads_as_reference(name):
    got = PCFG.load_config(str(CONFIG / name))
    assert dataclasses.asdict(got) == dataclasses.asdict(RCFG.load_config(str(CONFIG / name)))
    assert got.nparty == got.num_main_parties + 1


@pytest.mark.parametrize("local", LOCALS)
@pytest.mark.parametrize("glob", GLOBALS)
def test_config_pair_loads_as_reference(glob, local):
    args = (str(CONFIG / glob), str(CONFIG / local))
    assert dataclasses.asdict(PCFG.load_config(*args)) == dataclasses.asdict(
        RCFG.load_config(*args))


def test_config_keys_parsed(tmp_path):
    """Degree and the servers map are parsed; unknown keys are ignored."""
    path = tmp_path / "c.toml"
    path.write_text('Degree = 31\nnot_a_field = 5\nnum_snps = 7\n'
                    '[servers.party2]\nipaddr = "10.0.0.2"\n[servers.party2.ports]\nparty0 = "91"\n')
    cfg = PCFG.load_config(str(path))
    assert (cfg.degree, cfg.num_snps) == (31, 7) and not hasattr(cfg, "not_a_field")
    assert cfg.servers == {2: {"ip": "10.0.0.2", "ports": {0: 91}}}
    assert dataclasses.asdict(cfg) == dataclasses.asdict(RCFG.load_config(str(path)))


@pytest.mark.parametrize("seed,thres", [(0, 1), (1, 1000), (2, 5000), (3, 100000)])
def test_snp_distance_filtering_matches_reference(seed, thres):
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.integers(0, 1_000_000, size=400))
    filt = rng.uniform(size=400) < 0.7
    got = PP.snp_distance_filtering(pos, filt, thres)
    want = RP.snp_distance_filtering(pos, filt, thres)
    assert got[0] == want[0] and got[0] == int(got[1].sum())
    np.testing.assert_array_equal(got[1], want[1])
    assert not (got[1] & ~filt).any()


@pytest.mark.parametrize("limit", [0, -1])
def test_watchdog_off_without_limit(limit):
    wd = MemoryWatchdog(limit).start()
    ref = RefWatchdog(limit).start()
    assert wd._thread is None and ref._thread is None


def test_watchdog_runs_under_limit():
    wd = MemoryWatchdog(1 << 50, interval_s=0.01).start()
    try:
        assert wd._thread is not None and wd._thread.is_alive()
        assert wd.start() is wd  # a second start starts no second thread
        deadline = time.time() + 10
        while wd.peak == 0 and time.time() < deadline:
            time.sleep(0.01)
        assert wd.peak > 0
    finally:
        wd.stop()
    wd._thread.join(timeout=5)
    assert not wd._thread.is_alive()


def _dealer(cfg, **kw):
    """The dealer's ProtocolInfo without keys (mpc_only) over a mesh."""
    return PP.ProtocolInfo(cfg, 0, transport=LocalCluster(3).transport(0), mpc_only=True, **kw)


def _cfg(tmp_path, **fields):
    return dataclasses.replace(PCFG.Config(), num_inds=[0, 4, 4], num_snps=10,
                               cache_dir=str(tmp_path / "c"), output_dir=str(tmp_path / "o"),
                               **fields)


def test_tcp_transport_names_a8(tmp_path, monkeypatch):
    """With no transport given, the protocol builds the TCP mesh (A8) from
    the config, as the JAX package's does: the servers map, one channel a
    pair per MPC thread, the binding address."""
    from sfgwas_tpu_torch.parallel import transport as PT

    made = []

    def make(*a):
        made.append(a)
        return LocalCluster(3).transport(0)

    monkeypatch.setattr(PT, "make_tcp_transport", make)
    servers = {0: {"ip": "127.0.0.1", "ports": {1: 7100, 2: 7200}}}
    PP.ProtocolInfo(_cfg(tmp_path, servers=servers, mpc_num_threads=0,
                         binding_ipaddr="127.0.0.1"), 0, mpc_only=True)
    PP.ProtocolInfo(_cfg(tmp_path, servers=servers, mpc_num_threads=3), 0, mpc_only=True)
    assert made == [(0, 3, servers, 1, "127.0.0.1"), (0, 3, servers, 3, "0.0.0.0")]


@pytest.mark.parametrize("device,shards", [("cpu", 1), ("cpu", 2), (None, 0)])
def test_shard_matmult_routes_local_devices(tmp_path, monkeypatch, device, shards):
    """shard_matmult = true builds the protocol and hands the party's local
    devices to set_pipeline_devices: [cpu] for a CPU party, every cuda:i
    for a party on the card (none on this host); a list of one or none
    routes nothing, two logical shards route.  A later protocol without
    shard_matmult clears the routing."""
    from sfgwas_tpu_torch.gwas import matmult as PMM

    if shards == 2:
        monkeypatch.setattr(PP, "local_devices", lambda kind: [torch.device(kind)] * 2)
    seen = []
    real = PMM.set_pipeline_devices
    monkeypatch.setattr(PMM, "set_pipeline_devices",
                        lambda d: seen.append(None if d is None else list(d)) or real(d))
    try:
        _dealer(_cfg(tmp_path, shard_matmult=True), device=device)
        assert seen == [PP.local_devices("cpu" if device else "cuda")]
        assert len(seen[0]) == shards
        assert PMM._pipeline_devices == (seen[0] if shards > 1 else None)
        _dealer(_cfg(tmp_path), device=device)
        assert seen[1:] == [None]
        assert PMM._pipeline_devices is None
    finally:
        real(None)


@pytest.mark.parametrize("fields", [{}, {"use_cached_pca": True}])
def test_pca_names_a9(tmp_path, fields, monkeypatch):
    """PCA (A9) is ported, its Householder QR (A9c) too: the dealer takes
    qr_method = "householder", with use_cached_pca it resumes from its
    Qpc.done marker alone, and net_qr sends that method to net_dqr_enc."""
    prot = _dealer(_cfg(tmp_path, skip_pca=False, qr_method="householder", **fields))
    if fields:
        Path(prot.cache_path("Qpc.done")).write_text("1\n")
        assert prot.phase2() == [None] * prot.config.num_pcs_to_remove
    seen = []
    monkeypatch.setattr(PQR, "net_dqr_enc", lambda *a: seen.append(a) or "Q")
    assert PQR.net_qr(None, prot.mpc, [None], [0, 4, 4], method=prot.config.qr_method) == "Q"
    assert seen == [(None, prot.mpc, [None], [0, 4, 4])]


def test_skip_pca_phase2(tmp_path):
    prot = _dealer(_cfg(tmp_path, skip_pca=True))
    assert prot.phase2() is None and prot.gwas_params.num_pcs == 0


def test_cli_needs_a_card_unless_told(tmp_path, monkeypatch):
    """With no --platform the CLI runs on the card: without one it raises
    before any party starts, as it does for --platform gpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def started(*a, **k):
        raise AssertionError("a party started")

    monkeypatch.setattr(PP.ProtocolInfo, "__init__", started)
    cfg = write_config(str(tmp_path / "g.toml"), str(tmp_path), str(tmp_path / "c"),
                       str(tmp_path / "o"))
    for extra in ([], ["--platform", "gpu"], ["--platform", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--local-sim", "3", "--config-global", cfg] + extra)
    assert not os.path.exists(tmp_path / "c")


def test_cli_without_local_sim_names_a8(tmp_path, monkeypatch):
    """Without --local-sim the CLI runs the party the PID environment
    variable names over the TCP mesh (A8); a mesh that cannot be built fails
    the run with its error."""
    from sfgwas_tpu_torch.parallel import transport as PT

    cfg = write_config(str(tmp_path / "g.toml"), str(tmp_path), str(tmp_path / "c"),
                       str(tmp_path / "o"))
    monkeypatch.setenv("PID", "1")
    pids = []

    def make(pid, *a):
        pids.append(pid)
        raise ConnectionError("no peer")

    monkeypatch.setattr(PT, "make_tcp_transport", make)
    with pytest.raises(ConnectionError, match="no peer"):
        cli.main(["--platform", "cpu", "--config-global", cfg])
    assert pids == [1]


def test_cli_party_failure_fails_the_run(tmp_path):
    """Party 2's phenotype file is missing: it fails after the keygen, the
    mesh closes, and main re-raises party 2's error at once (the others
    would otherwise wait out a 3600 s receive)."""
    root = str(tmp_path)
    write_study(root)
    os.remove(os.path.join(root, "party2", "pheno.txt"))
    cfg = write_config(os.path.join(root, "g.toml"), root, os.path.join(root, "c"),
                       os.path.join(root, "o"))
    t0 = time.time()
    with pytest.raises(FileNotFoundError, match="party2") as err:
        cli.main(["--platform", "cpu", "--local-sim", "3", "--config-global", cfg])
    assert time.time() - t0 < 60
    assert not isinstance(err.value, ClusterClosed)


def test_closed_cluster_raises_at_every_receive():
    cluster = LocalCluster(3)
    t1, t2 = cluster.transport(1), cluster.transport(2)
    t1.send_obj(2, "queued")
    cluster.close("party 0 failed")
    assert t2.recv_obj(1, timeout=1) == "queued"  # what was queued is read first
    for _ in range(2):
        with pytest.raises(ClusterClosed, match="party 0 failed"):
            t2.recv_obj(1, timeout=1)
    with pytest.raises(ClusterClosed):
        t1.recv_obj(0, timeout=1)
    with pytest.raises(ClusterClosed):
        t1.send_obj(2, "late")
