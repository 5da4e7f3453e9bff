"""The traced run's instruments: torch.profiler over every thread of a
process, the program's spans mirrored into the trace, and each roofline
kernel's launches with their work.

The trace is read from the profiler's raw events (as chip_smoke.py's
trace_summary reads them; its own event lists cost a minute and more on a
trace this size).  A trace that holds no device event raises: torch.profiler
has been seen to drop a short trace, and an empty one must not read as an
idle card.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
import sys
import threading
from contextlib import ExitStack, contextmanager
from pathlib import Path

# the names torch.profiler's own event lists leave out (its _filter_name)
UNLISTED_EVENTS = {
    "[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
    "profiler::_record_function_enter_new", "profiler::_record_function_exit",
    "aten::is_leaf", "aten::output_nr", "aten::_version"}
TOP = 10


class Profiler:
    """torch.profiler over every thread of this process, from start() to
    stop() (the card's activity where cuda)."""

    def __init__(self, torch, cuda: bool):
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        self.torch, self.cuda = torch, cuda
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self.prof = profile(activities=acts,
                            experimental_config=_ExperimentalConfig(profile_all_threads=True))

    def _sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def start(self):
        self._sync()
        self.prof.__enter__()

    def stop(self) -> list:
        """The trace's raw rows: (name, on_device, thread, start_ns, end_ns)."""
        self._sync()
        self.prof.__exit__(None, None, None)
        dev = self.torch.autograd.DeviceType.CUDA
        return [(e.name(), e.device_type() == dev, e.start_thread_id(), e.start_ns(),
                 e.end_ns()) for e in self.prof.profiler.kineto_results.events()]


def _merge(intervals):
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def summarize(rows, spans=(), require_device: bool = True) -> dict:
    """From raw rows (name, on_device, thread, start_ns, end_ns): the device's
    busy seconds (the union of its events), the traced window's seconds
    (first to last event), device seconds by name, and the longest idle
    gaps named by the innermost span (of `spans`, host ranges in the trace)
    open at the gap's middle, else "no span"."""
    rows = [r for r in rows if r[0] not in UNLISTED_EVENTS]
    span_names = set(spans)
    dev = [r for r in rows if r[1] and r[0] not in span_names]
    if not dev and require_device:
        raise RuntimeError("torch.profiler traced no device event in the window")
    busy = _merge((r[3], r[4]) for r in dev)
    t0 = min((r[3] for r in rows), default=0)
    t1 = max((r[4] for r in rows), default=0)
    by_name: dict = {}
    count: dict = {}
    for r in dev:
        by_name[r[0]] = by_name.get(r[0], 0) + r[4] - r[3]
        count[r[0]] = count.get(r[0], 0) + 1
    host_spans = sorted((r[3], r[4], r[0]) for r in rows if not r[1] and r[0] in span_names)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for s, t in gaps[:TOP]:
        mid = (s + t) // 2
        open_ = [h for h in host_spans if h[0] <= mid <= h[1]]
        # the innermost: the latest to start
        name = max(open_)[2] if open_ else "no span"
        named.append([name, (t - s) / 1e9])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": sum(t - s for s, t in busy) / 1e9,
        "window_s": (t1 - t0) / 1e9,
        "device_s_by_name": {k: v / 1e9 for k, v in by_name.items()},
        "device_events_by_name": count,
        "device_ops": [[k, v / 1e9] for k, v in top],
        "idle_gaps": named,
    }


class Tracer:
    """The traced window of one process: the program's spans on (synchronized
    with the card when it is one), mirrored into torch.profiler's trace over
    every thread, and the roofline kernels' launches recorded.  stop()
    returns {"summary": summarize(...), "launches": {kernel: [(bytes,
    operations), ...]}}."""

    def __init__(self, torch, root: Path, kernels, cuda: bool):
        self.torch, self.root, self.kernels, self.cuda = torch, root, list(kernels), cuda

    def start(self):
        from sfgwas_tpu_torch.utils import prof

        self.names: set = set()
        self.stack = ExitStack()
        self.launches = self.stack.enter_context(
            instrument(self.torch, self.root, self.kernels, self.names))
        prof.ENABLED, prof.SYNC = True, (self.torch.cuda.synchronize if self.cuda else None)
        self.stack.callback(setattr, prof, "ENABLED", False)
        self.stack.callback(setattr, prof, "SYNC", None)
        self.profiler = Profiler(self.torch, self.cuda)
        self.profiler.start()

    def stop(self) -> dict:
        try:
            rows = self.profiler.stop()
        finally:
            self.stack.close()
        return {"summary": summarize(rows, self.names, self.cuda), "launches": self.launches}


def _resolve(target: str):
    mod, attr = target.split(":")
    return importlib.import_module(mod), attr


@contextmanager
def instrument(torch, root: Path, kernels, span_names_out: set):
    """Within the block: every span the program opens is also a
    torch.profiler range of its name (its names collected into
    span_names_out), and each kernel's launches (modules
    root/gwasbench/rooflines/<kernel>.py) are recorded with their work.
    Yields {kernel: [(bytes, operations), ...]}."""
    from sfgwas_tpu_torch.utils import prof

    launches = {k: [] for k in kernels}
    lock = threading.Lock()
    with ExitStack() as stack:
        real_span = prof.span

        def span(name: str):
            cm = ExitStack()
            cm.enter_context(real_span(name))
            cm.enter_context(torch.profiler.record_function(name))
            span_names_out.add(name)
            return cm

        prof.span = span
        stack.callback(setattr, prof, "span", real_span)
        for k in kernels:
            spec = load_module(root / "gwasbench" / "rooflines" / f"{k}.py", f"roofline_{k}")
            mod, attr = _resolve(spec.WRAPS)
            real = getattr(mod, attr)

            def wrapped(*a, _real=real, _spec=spec, _k=k, **kw):
                w = _spec.work(a, kw)
                out = _real(*a, **kw)
                if w is not None:
                    with lock:
                        launches[_k].append(w)
                return out

            setattr(mod, attr, wrapped)
            stack.callback(setattr, mod, attr, real)
        yield launches


def roofline_share(root: Path, kernel: str, launches, summary, peaks) -> float | None:
    """Sum over the window's launches of each launch's bound (the larger of
    bytes over the HBM rate and operations over the integer rate) over the
    device seconds of the kernel's events, in %; None where the trace and
    the record disagree on the number of launches or either is empty."""
    spec = load_module(root / "gwasbench" / "rooflines" / f"{kernel}.py", f"roofline_{kernel}")
    pat = re.compile(spec.DEVICE_NAME)
    n = sum(c for k, c in summary["device_events_by_name"].items() if pat.search(k))
    secs = sum(v for k, v in summary["device_s_by_name"].items() if pat.search(k))
    if not launches and not n:
        return None
    if not launches or n != len(launches) or secs <= 0:
        print(f"gwasbench: {kernel}: {len(launches)} launches recorded, {n} in the trace",
              file=sys.stderr, flush=True)
        return None
    bound = sum(max(b / peaks["hbm_bytes_per_s"], o / peaks["int_ops_per_s"])
                for b, o in launches)
    return 100.0 * bound / secs


def load_module(path: Path, name: str):
    """A module from a file found by name (metric readers, roofline counts)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)
