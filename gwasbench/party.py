"""One party process of a "tcp" layout (started by gwasbench/parties.py):

    python -m gwasbench.party <spec.json> <pid>

It joins the port's TCP mesh on the spec's ports, then runs party_main: the
controller's messages come one JSON line at a time on stdin, and its
answers go to stdout as lines starting with parties.TAG.  The hub of a
traced run traces its own process (its threads and its kernels).
"""

from __future__ import annotations

import json
import sys
import traceback
from pathlib import Path


def main(argv) -> int:
    from . import parties

    with open(argv[0]) as f:
        spec = json.load(f)
    pid = int(argv[1])

    def send(msg: dict):
        sys.stdout.write(parties.TAG + json.dumps(msg) + "\n")
        sys.stdout.flush()

    def recv() -> dict:
        line = sys.stdin.readline()
        if not line:
            raise ConnectionError("the controller closed its pipe")
        return json.loads(line)

    try:
        import torch

        from sfgwas_tpu_torch.mpc.prg import Random
        from sfgwas_tpu_torch.parallel.transport import Network, make_tcp_transport

        from .trace import Tracer

        cuda = spec["device"] is None
        if cuda:
            torch.cuda.set_device(0)
        servers = {int(p): {"ip": s["ip"], "ports": {int(q): int(v) for q, v in s["ports"].items()}}
                   for p, s in spec["servers"].items()}
        cfg, nets = spec["config"], []
        n, hub = parties.nparty(cfg), cfg["hub_party_id"]

        def make_net():
            # one connection a pair and MPC thread, striped, as the deployment opens them
            t = make_tcp_transport(pid, n, servers, cfg["mpc_num_threads"], "127.0.0.1")
            nets.append(Network(t, pid, n, hub, Random(pid, n)))
            return nets[-1]

        tracer = None
        if spec["trace"] and pid == hub:
            tracer = Tracer(torch, Path(spec["root"]), spec["kernels"], cuda)
        try:
            parties.party_main(pid, make_net, spec, recv, send, tracer)
        finally:
            for net in nets:
                net.close()
    except BaseException as e:  # noqa: BLE001 - reported to the controller, then exit 1
        traceback.print_exc()
        send({"kind": "error", "error": "".join(traceback.format_exception(e))[-3000:]})
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
