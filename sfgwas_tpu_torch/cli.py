"""CLI entry point (counterpart of sfgwas_tpu/cli.py; the Go sfgwas's
sfgwas.go:17-74).

Usage, one process per party over the TCP mesh of the global config's
[servers.partyN] sections (run_example.sh's layout; the PID environment
variable selects the party):
    PID=1 python -m sfgwas_tpu_torch.cli \\
        --config-global config/configGlobalSkipPCA.toml \\
        --config-local config/configLocal.Party1.toml

or all parties in one process over the in-process mesh:
    python -m sfgwas_tpu_torch.cli --local-sim 3 \\
        --config-global config/configGlobalSkipPCA.toml \\
        --config-local config/configLocalSim.toml

The two-level TOML config matches the Go sfgwas's schema.  A TCP party reads
its own local config; with --local-sim every party reads the same files, and
the path fields may hold a literal {pid} that each party replaces with its
id (the dealer, 0, with 1).  The parties run on the CUDA card unless
--platform names another torch device (cpu); with no card and no
--platform the CLI raises.

Unlike the JAX package's CLI, a party that raises fails the run.  In one
process it closes the in-process mesh, so the other parties' receives raise
at once, and main re-raises its exception.  A TCP party closes its
connections and main re-raises (the process exits nonzero); each peer's next
receive from it raises ConnectionError, so every party's process fails in
turn and none waits for a message that will not come.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import traceback

from .utils.config import load_config
from .utils.watchdog import MemoryWatchdog

# path fields a local-sim party may write with a {pid} placeholder
PID_FIELDS = (
    "geno_binary_file_prefix", "geno_block_size_file", "pheno_file", "covar_file",
    "snp_position_file", "geno_count_file", "sample_keep_file", "snp_ids_file", "cache_dir",
    "output_dir",
)


def _device(platform):
    """--platform -> the torch device of every party: None is the CUDA card
    (raises without one), gpu means cuda."""
    from .crypto.ckks import resolve_device

    if platform is None:
        return resolve_device(None)
    return resolve_device("cuda" if platform == "gpu" else platform)


def _party_config(args, pid: int):
    """A local-sim party's config: {pid} replaced (the dealer takes party
    1's paths) and the cache and output directories made per party."""
    cfg = load_config(args.config_global, args.config_local)
    for fld in PID_FIELDS:
        v = getattr(cfg, fld)
        if v:
            setattr(cfg, fld, v.replace("{pid}", str(pid if pid else 1)))
    cfg.cache_dir = os.path.join(cfg.cache_dir, f"party{pid}")
    cfg.output_dir = os.path.join(cfg.output_dir, f"party{pid}")
    return cfg


def _local_sim(args, device) -> None:
    """All parties as threads of this process over one LocalCluster; the
    first party to raise closes it, and its exception is raised here."""
    from .gwas.protocol import ProtocolInfo
    from .parallel.transport import ClusterClosed, LocalCluster
    from .utils.log import log

    nparty = args.local_sim
    cluster = LocalCluster(nparty)
    errors = []  # (pid, exception) in the order the parties failed
    lock = threading.Lock()

    def work(pid):
        try:
            log(f"pid{pid} worker starting")
            cfg = _party_config(args, pid)
            prot = ProtocolInfo(cfg, pid, transport=cluster.transport(pid), device=device)
            prot.gwas()
            prot.sync_and_terminate()
        except BaseException as e:  # noqa: BLE001 - recorded, the mesh closed, re-raised by main
            if not isinstance(e, ClusterClosed):
                traceback.print_exc()
            with lock:
                errors.append((pid, e))
            cluster.close(f"party {pid} failed: {e!r}")

    threads = [threading.Thread(target=work, args=(p,), name=f"party{p}") for p in range(nparty)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        # the failure that closed the mesh, not the others' ClusterClosed
        pid, err = next(((p, e) for p, e in errors if not isinstance(e, ClusterClosed)), errors[0])
        log(f"party {pid} failed; the run is stopped")
        raise err


def _tcp_party(args, device) -> None:
    """This process's party (the PID environment variable) over the TCP
    mesh; a failure closes its connections before it is raised."""
    from .gwas.protocol import ProtocolInfo
    from .utils.log import log

    pid = int(os.environ.get("PID", "0"))
    prot = None
    try:
        prot = ProtocolInfo(load_config(args.config_global, args.config_local), pid,
                            device=device)
        prot.gwas()
        prot.sync_and_terminate()
    except BaseException:
        log(f"party {pid} failed; its connections are closed")
        if prot is not None:
            prot.net.close()
        raise


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m sfgwas_tpu_torch.cli")
    ap.add_argument("--config-global", required=True)
    ap.add_argument("--config-local", default=None)
    ap.add_argument("--local-sim", type=int, default=0,
                    help="run all N parties (the dealer 0 included) in-process")
    ap.add_argument("--platform", default=None,
                    help="torch device: cpu, or gpu/cuda (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = _device(args.platform)

    # SFGWAS_STACKDUMP=<secs>: periodically dump all thread stacks to stderr
    # (a liveness signal for long runs)
    dump_every = int(os.environ.get("SFGWAS_STACKDUMP", "0"))
    if dump_every > 0:
        import faulthandler

        faulthandler.dump_traceback_later(dump_every, repeat=True)

    # one watchdog for the whole process (sfgwas.go:64)
    watchdog = MemoryWatchdog(load_config(args.config_global, args.config_local).memory_limit)
    watchdog.start()
    try:
        if args.local_sim:
            _local_sim(args, device)
            return 0

        _tcp_party(args, device)
        return 0
    finally:
        watchdog.stop()
        if dump_every > 0:
            faulthandler.cancel_dump_traceback_later()


if __name__ == "__main__":
    sys.exit(main())
