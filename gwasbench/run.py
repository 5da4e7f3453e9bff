"""Runs one cell of the benchmark of sfgwas_tpu_torch once, from the root of
a checkout:

    python3 -m gwasbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from BENCHMARK.json: the cell's configuration
(gwasbench/configs/<config>.json, the deployment: layout, parties, crypto and
QC settings), its traffic (gwasbench/workloads/<traffic>.json: the unit of
work, gwasbench/units/<unit>.py, its sizes and the limits of its
comparison), each metric's reader (gwasbench/metrics/<metric>.py) and each
kernel's work count (gwasbench/rooflines/<kernel>.py).

A run: the inputs from the seed; the parties' set-up (the collective keygen
in memory, QC or the encrypted inputs, one warm-up unit); the window, units
one after another (the first always; a later one only if it would end
within --seconds of the window's start and within --seconds + 60 s of the
run's, less the wrap-up); the answers of every unit
compared with the plain reference (gwasbench/reference.py); one JSON line.
--trace 1 traces the window (torch.profiler over every thread, the
program's spans synchronized with the card) and reports the per-layer
metrics; --trace 0 the end-to-end ones.  Without a CUDA card the run exits
3 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402


def host_cores() -> int:
    """The cores this process may run on."""
    return len(os.sched_getaffinity(0))


def threads_per_party() -> int:
    """The CPU thread pools' size for each of the three parties: a third of
    the host's cores, in either layout."""
    return max(1, host_cores() // 3)


if __name__ == "__main__":
    # the thread pools (OpenMP: torch's intra-op pool, BLAS) are sized when
    # they are loaded, so before numpy and torch; each party thread's
    # parallel regions get a team of this size
    os.environ["OMP_NUM_THREADS"] = str(threads_per_party())

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from . import parties, trace  # noqa: E402
from .trace import load_json  # noqa: E402

# the wait for any one party message: set-up, a unit, the answers
PARTY_TIMEOUT_S = 300
# a run's whole time is kept within --seconds + RUN_SLACK_S (what a check
# allows a run) where it can be: the window starts no unit that would end
# past it, less WRAP_UP_S for what follows the window (the parties' answers,
# the reference, reading a trace)
RUN_SLACK_S = 60
WRAP_UP_S = 25


def _say(*a):
    print("gwasbench:", *a, file=sys.stderr, flush=True)


def applies(metric: dict, cell: str, reported=()) -> bool:
    """Whether a metric is the cell's: listed under its workloads, or, without
    that key, an end-to-end metric (every cell) or a per-layer metric whose
    end-to-end metric the cell reports."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def cell_spec(root: Path, bench: dict, name: str):
    """(cell, configuration, traffic, end-to-end metrics, per-layer metrics)."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"gwasbench: no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg = load_json(root / "gwasbench" / "configs" / f"{cell['config']}.json")
    traffic = load_json(root / "gwasbench" / "workloads" / f"{cell['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if applies(m, name)]
    layer = [m for m in bench["per_layer"] if applies(m, name, {m["name"] for m in e2e})]
    return cell, cfg, traffic, e2e, layer


def host_facts(device) -> dict:
    """The card's power limit (nvidia-smi) and the host's CPU model."""
    out = {"cpu": "unknown", "cpu_count": host_cores()}
    try:
        with open("/proc/cpuinfo") as f:
            info = dict(line.split(":", 1) for line in f if ":" in line)
        info = {k.strip(): v.strip() for k, v in info.items()}
        out["cpu"] = (info.get("model name") if info.get("model name", "unknown") != "unknown"
                      else f"family {info.get('cpu family')} model {info.get('model')}")
    except OSError:
        pass
    if device is None:
        try:
            out["power_limit"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=30).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            out["power_limit"] = "unknown"
    return out


def build(cfg: dict, device) -> None:
    """The port's libraries, built into its _build/ directory where they are
    missing (only a checkout's first run builds)."""
    from sfgwas_tpu_torch.ops import native_ring

    if device is None:
        from sfgwas_tpu_torch.ops import cuda_build

        cuda_build.build()
    native_ring.lib()
    if cfg["layout"] == "tcp":
        from sfgwas_tpu_torch.parallel import native_transport

        native_transport.lib()


def read_metrics(root: Path, metrics: list, run: dict) -> dict:
    """Each metric's reader (gwasbench/metrics/<name>.py, read(run) -> a
    number or None); a metric whose reader finds nothing is left out."""
    out = {}
    for m in metrics:
        reader = trace.load_module(root / "gwasbench" / "metrics" / f"{m['name']}.py",
                                   "metric_" + m["name"].replace(".", "_"))
        v = reader.read(run)
        if v is None:
            _say(f"metric {m['name']}: nothing to read")
            continue
        out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def judge(unit, want: dict, outputs: dict, limits: dict, n_units: int):
    """(correct, failed units, {number: {value, limit}}, every number of the
    comparison): every number that has a limit within it over the whole
    window, and the units that fail alone."""
    def ok(nums):
        return all(nums[k] <= lim for k, lim in limits.items())

    nums = unit.compare(want, outputs, list(range(n_units)))
    failed = sum(1 for i in range(n_units) if not ok(unit.compare(want, outputs, [i])))
    checks = {k: {"value": nums[k], "limit": lim} for k, lim in limits.items()}
    return n_units > 0 and ok(nums), failed, checks, nums


def run_cell(root: Path, bench: dict, name: str, seed: int, seconds: float, trace_on: bool,
             device=None, config_changes=None) -> dict:
    """One run of the cell; returns the result line's object.  device None is
    the CUDA card; "cpu" rehearses on the CPU (the tests, at a test preset).
    config_changes replaces keys of the configuration (the control's lower
    precision)."""
    import torch

    cell, cfg, traffic, e2e, layer = cell_spec(root, bench, name)
    cfg = {**cfg, **(config_changes or {})}
    unit = parties.unit_module(traffic)
    cuda = device is None
    rundir = tempfile.mkdtemp(prefix="gwasbench_")
    try:
        data = unit.make_inputs(seed, cfg, traffic, rundir)
        build(cfg, device)
        kernels = sorted(p.stem for p in (root / "gwasbench" / "rooflines").glob("*.py")
                         if p.stem != "__init__")
        spec = {"config": cfg, "traffic": traffic, "rundir": rundir, "device": device,
                "trace": bool(trace_on), "root": str(root), "kernels": kernels,
                "threads_per_party": threads_per_party()}
        if cuda and cfg["layout"] == "threads":
            torch.cuda.reset_peak_memory_stats()
        layout = parties.open_layout(spec)
        tracer = None
        if trace_on:
            tracer = ("hub" if cfg["layout"] == "tcp"
                      else trace.Tracer(torch, root, kernels, cuda))
        try:
            rec = parties.drive(layout, seconds, tracer, PARTY_TIMEOUT_S,
                                T_START + seconds + RUN_SLACK_S - WRAP_UP_S)
        except BaseException:
            layout.kill()
            raise
        layout.close()
        setup_s = rec["window_start"] - T_START
        if cfg["layout"] == "threads":
            peak = torch.cuda.max_memory_allocated() if cuda else 0
            kind = torch.cuda.get_device_name(0) if cuda else "cpu"
        else:
            peak = sum(f["memory_peak_bytes"] for f in rec["finals"])
            kind = rec["finals"][layout.hub].get("device_name", "cpu")
        found = sorted(set(parties.jax_modules()).union(
            *[f.get("jax_modules", []) for f in rec["finals"]]))
        if found:
            raise RuntimeError(f"JAX modules loaded in the run: {found}")
        units = rec["units"]
        outputs = {}
        for pid in range(1, layout.nparty):
            path = os.path.join(rundir, f"out_p{pid}.npz")
            if os.path.exists(path):
                with np.load(path) as z:
                    outputs[pid] = {k: z[k] for k in z.files}
    finally:
        shutil.rmtree(rundir, ignore_errors=True)
    want = unit.reference_outputs(data, cfg, traffic)
    correct, failed, checks, readings = judge(unit, want, outputs, traffic["limits"],
                                              len(units))
    traced = rec["trace"]
    run = {"units": units, "work": unit.work(cfg, traffic), "setup_s": setup_s,
           "trace": traced and traced["summary"], "launches": traced and traced["launches"],
           "peaks": load_json(root / "gwasbench" / "peaks.json"), "root": root}
    result = {
        "correct": bool(correct), "attempted": len(units), "failed": failed,
        "metrics": read_metrics(root, layer if trace_on else e2e, run),
        "device": {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
                   "memory_peak_bytes": int(peak)},
    }
    if traced:
        s = traced["summary"]
        result["device"].update(busy_s=s["busy_s"], window_s=s["window_s"])
        result["breakdown"] = {"device_ops": s["device_ops"], "idle_gaps": s["idle_gaps"]}
    result["host"] = host_facts(device)
    result["units"] = {"work_per_unit": run["work"], "warmup_s": rec["warmup_s"],
                       "unit_s": [u["s"] for u in units]}
    result["readings"] = readings
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("SFGWAS_QUIET", "1")
    root = Path.cwd()
    bench = load_json(root / "BENCHMARK.json")
    chips = {c["name"]: c["chips"] for c in bench["workloads"]}.get(args.workload, 1)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _say(f"needs {chips} CUDA device(s); torch.cuda.is_available() is "
             f"{torch.cuda.is_available()}")
        return 3
    result = run_cell(root, bench, args.workload, args.seed, args.seconds, bool(args.trace))
    found = parties.jax_modules()
    if found:
        _say(f"JAX modules loaded after the window: {found}")
        return 4
    for k, c in result["checks"].items():
        _say(f"check {k} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
