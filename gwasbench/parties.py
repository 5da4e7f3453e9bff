"""The three parties of a run (dealer 0, data parties 1 and 2, hub 1) and the
controller that drives them, in either layout of the configuration:

- "threads": the parties are threads of this process over the port's
  in-process mesh (parallel/transport.py::LocalCluster), as
  `cli.py --local-sim 3` runs them;
- "tcp": the parties are three processes (python -m gwasbench.party) over
  the port's native TCP mesh on 127.0.0.1 (parallel/transport.py::
  make_tcp_transport), as run_example.sh runs them.

The number of parties (num_main_parties + the dealer), the hub
(hub_party_id) and the TCP channels a pair (mpc_num_threads) come from the
configuration.

Every party runs party_main: the collective keygen in memory, the unit's
set-up (QC, or the encrypted inputs), then one unit each time the controller
says "go", until it says "stop"; then the unit's answers are written to the
run directory.  The controller talks to the parties over its own channels
(queues, or the processes' pipes), never over the protocol's mesh.  The hub
reports its spans and its Network's byte count for each unit.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import queue
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

import numpy as np

TAG = "@@gwasbench "  # a party process's protocol lines on its stdout
# how the interpreter runs a party process (its spec's path and its pid follow)
PARTY_COMMAND = ["-m", "gwasbench.party"]
CODE_ROOT = Path(__file__).resolve().parents[1]


def nparty(cfg: dict) -> int:
    return cfg["num_main_parties"] + 1


def unit_module(traffic: dict):
    return importlib.import_module(f"gwasbench.units.{traffic['unit']}")


def _net_bytes(net) -> int:
    return sum(net.sent_bytes.values()) + sum(net.recv_bytes.values())


def party_main(pid: int, make_net, spec: dict, recv, send, tracer=None):
    """One party: `recv()` returns the controller's next message, `send(msg)`
    answers it; `tracer` (the hub of a traced process layout) traces the
    window when the controller asks."""
    from sfgwas_tpu_torch.mpc import mhe as PM
    from sfgwas_tpu_torch.mpc.mpc import MPC
    from sfgwas_tpu_torch.ops import ring as R
    from sfgwas_tpu_torch.utils import prof

    cfg, traffic = spec["config"], spec["traffic"]
    net = make_net()
    mpc = MPC(net, R.field_for_size(cfg["mpc_field_size"]), cfg["mpc_data_bits"],
              cfg["mpc_frac_bits"], cfg["mpc_boolean_shares"], cfg["div_sqrt_max_len"])
    cps = PM.collective_init(net, cfg["ckks_params"], device=spec["device"])
    unit = unit_module(traffic).Party(mpc, cps, cfg, traffic, spec["rundir"], spec["device"])
    send({"kind": "ready"})
    while True:
        msg = recv()
        kind = msg["kind"]
        if kind == "stop":
            break
        if kind == "abort":
            raise Failed("aborted by the controller")
        if kind == "trace_on":
            tracer.start()
            send({"kind": "traced"})
            continue
        if kind == "trace_off":
            send({"kind": "trace", **tracer.stop()})
            continue
        prof.reset()
        before = _net_bytes(net)
        unit.run(msg["index"])
        done = {"kind": "done", "index": msg["index"]}
        if pid == cfg["hub_party_id"]:
            done["spans"] = {k: v[0] for k, v in prof.totals().items()}
            done["net_bytes"] = _net_bytes(net) - before
        send(done)
    outputs = unit.finish()
    if outputs:
        np.savez(os.path.join(spec["rundir"], f"out_p{pid}.npz"), **outputs)
    del unit, cps, mpc
    send({"kind": "final", **process_facts(spec["device"])})


def process_facts(device) -> dict:
    """What a party process reports at its end: its peak device bytes and
    any JAX module it holds (by whole top-level name)."""
    import torch

    cuda = device is None
    return {"memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0,
            "device_name": torch.cuda.get_device_name(0) if cuda else "cpu",
            "jax_modules": jax_modules()}


FORBIDDEN = ("jax", "jaxlib", "flax", "sfgwas_tpu")


def jax_modules() -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the
    JAX package's (the part before the first dot compared whole, so the
    port, sfgwas_tpu_torch, is not one)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Failed(RuntimeError):
    pass


class _Layout:
    """The controller's side: send(pid, msg), and each party's messages in
    self.inbox[pid]."""

    def __init__(self, spec: dict):
        self.nparty, self.hub = nparty(spec["config"]), spec["config"]["hub_party_id"]
        self.inbox = [queue.Queue() for _ in range(self.nparty)]

    def expect(self, pid: int, kind: str, timeout: float) -> dict:
        try:
            msg = self.inbox[pid].get(timeout=timeout)
        except queue.Empty:
            raise Failed(f"party {pid}: no {kind!r} within {timeout} s") from None
        if msg["kind"] != kind:
            raise Failed(f"party {pid}: expected {kind!r}, got {msg['kind']!r}: "
                         f"{msg.get('error', '')}")
        return msg

    def expect_all(self, kind: str, timeout: float) -> list:
        return [self.expect(pid, kind, timeout) for pid in range(self.nparty)]


class Threads(_Layout):
    """The parties as threads of this process over one LocalCluster; a party
    that raises closes it, so the others fail at their next receive."""

    def __init__(self, spec: dict):
        super().__init__(spec)
        from sfgwas_tpu_torch.mpc.prg import Random
        from sfgwas_tpu_torch.parallel.transport import LocalCluster, Network

        n = self.nparty
        self.cluster = LocalCluster(n)
        self.outbox = [queue.Queue() for _ in range(n)]
        self.threads = []
        for pid in range(n):
            def make_net(pid=pid):
                return Network(self.cluster.transport(pid), pid, n, self.hub, Random(pid, n))

            def work(pid=pid, make_net=make_net):
                try:
                    party_main(pid, make_net, spec, self.outbox[pid].get, self.inbox[pid].put)
                except BaseException as e:  # noqa: BLE001 - reported to the controller
                    self.inbox[pid].put({"kind": "error",
                                         "error": "".join(traceback.format_exception(e))})
                    self.cluster.close(f"party {pid} failed: {e!r}")

            t = threading.Thread(target=work, name=f"party{pid}", daemon=True)
            self.threads.append(t)
            t.start()

    def send(self, pid: int, msg: dict):
        self.outbox[pid].put(msg)

    def close(self):
        for t in self.threads:
            t.join(timeout=120)
        alive = [t.name for t in self.threads if t.is_alive()]
        if alive:
            raise Failed(f"party threads still running: {alive}")

    def kill(self):
        """After a failure: the mesh closed and every party told to stop
        waiting, so each thread ends."""
        self.cluster.close("the run failed")
        for box in self.outbox:
            box.put({"kind": "abort"})
        for t in self.threads:
            t.join(timeout=120)


class Processes(_Layout):
    """The parties as processes over TCP; each process's protocol lines go to
    its inbox, the rest of its output to rundir/party<pid>.log."""

    def __init__(self, spec: dict):
        super().__init__(spec)
        from . import gen

        rundir = spec["rundir"]
        n, width = self.nparty, spec["config"]["mpc_num_threads"]
        spec = dict(spec, servers=gen.tcp_servers(n, gen.free_port_bases(n * (n - 1) // 2, width)))
        path = os.path.join(rundir, "spec.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        env = dict(os.environ, PYTHONPATH=str(CODE_ROOT), SFGWAS_QUIET="1",
                   OMP_NUM_THREADS=str(spec["threads_per_party"]))
        self.procs, self.readers, self.logs = [], [], []
        for pid in range(n):
            log = os.path.join(rundir, f"party{pid}.log")
            self.logs.append(log)
            p = subprocess.Popen([sys.executable, *PARTY_COMMAND, path, str(pid)],
                                 cwd=str(CODE_ROOT), env=env, stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                 bufsize=1)
            self.procs.append(p)
            r = threading.Thread(target=self._read, args=(pid, p, log), daemon=True)
            self.readers.append(r)
            r.start()

    def _read(self, pid: int, p, log: str):
        with open(log, "w") as f:
            for line in p.stdout:
                if line.startswith(TAG):
                    self.inbox[pid].put(json.loads(line[len(TAG):]))
                else:
                    f.write(line)
                    f.flush()
        p.wait()
        self.inbox[pid].put({"kind": "error", "error": f"exited {p.returncode}: "
                             + self.tail(pid)})

    def tail(self, pid: int, n: int = 3000) -> str:
        try:
            with open(self.logs[pid]) as f:
                return f.read()[-n:]
        except OSError:
            return ""

    def send(self, pid: int, msg: dict):
        try:
            self.procs[pid].stdin.write(json.dumps(msg) + "\n")
            self.procs[pid].stdin.flush()
        except (BrokenPipeError, ValueError, OSError) as e:
            raise Failed(f"party {pid} is gone: {e!r}: {self.tail(pid)}") from None

    def close(self):
        """Waits for every process (killing any left after a failure) and its
        reader."""
        for p in self.procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for r in self.readers:
            r.join(timeout=60)

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        self.close()


def open_layout(spec: dict):
    return {"threads": Threads, "tcp": Processes}[spec["config"]["layout"]](spec)


def drive(layout, seconds: float, tracer, timeout: float, deadline: float = math.inf) -> dict:
    """Set-up to its end (every party ready, one warm-up unit), then the
    window: units one after another, each timed from "go" to the last
    party's "done".  The first always runs; a later one starts only if the
    last unit's time still fits before the window's end, `seconds` after it
    started, and before `deadline` (a time.perf_counter() reading), so the
    window ends by both unless its one unit is longer.  With a tracer
    the window is traced (in this process, or in the hub's when tracer is
    "hub").  Returns the window's record; the parties' answers are in the
    run directory once close() returns."""
    everyone, hub = range(layout.nparty), layout.hub
    layout.expect_all("ready", timeout)
    t_warm = time.perf_counter()
    for pid in everyone:
        layout.send(pid, {"kind": "go", "index": -1})
    layout.expect_all("done", timeout)
    t_window = time.perf_counter()
    if tracer == "hub":
        layout.send(hub, {"kind": "trace_on"})
        layout.expect(hub, "traced", timeout)
    elif tracer is not None:
        tracer.start()
    units = []
    end = min(time.perf_counter() + seconds, deadline)
    while not units or time.perf_counter() + units[-1]["s"] <= end:
        t0 = time.perf_counter()
        for pid in everyone:
            layout.send(pid, {"kind": "go", "index": len(units)})
        done = layout.expect_all("done", timeout)
        units.append({"s": time.perf_counter() - t0, "spans": done[hub].get("spans", {}),
                      "net_bytes": done[hub].get("net_bytes", 0)})
    trace = None
    if tracer == "hub":
        layout.send(hub, {"kind": "trace_off"})
        trace = layout.expect(hub, "trace", timeout)
    elif tracer is not None:
        trace = tracer.stop()
    for pid in everyone:
        layout.send(pid, {"kind": "stop"})
    finals = layout.expect_all("final", timeout)
    return {"window_start": t_window, "warmup_s": t_window - t_warm, "units": units,
            "trace": trace, "finals": finals}
