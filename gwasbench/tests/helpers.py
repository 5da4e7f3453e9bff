"""A benchmark root of the repository's BENCHMARK.json, configurations,
traffic and readers, cut to a test size (TEST8, 100 individuals a data party,
blocks of 150 SNPs, 301 std-inverse values and a warm-up of 129) in a
temporary directory, with the cells' own limits, and a check of a result
line against the contract."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


# the TCP layout's cell: its configuration is in gwasbench/configs, and
# BENCHMARK.json leaves it out while its calls stall on the card (PERF.md,
# Open questions); the tests run it as the cell it would be
TCP_CONFIG = {"name": "example_tcp", "file": "gwasbench/configs/example_tcp.json",
              "source": "https://github.com/hhcho/sfgwas run_example.sh", "reduced": ["num_snps",
              "mpc_num_threads"], "why": "three party processes over the native TCP mesh"}
TCP_CELL = {"name": "tcp.assoc", "config": "example_tcp", "traffic": "assoc_2x4546", "chips": 1,
            "why": "the association calls as three party processes over loopback TCP"}


def with_tcp_cell(bench: dict) -> dict:
    """bench with the TCP layout's cell, reporting what local.assoc does."""
    bench = json.loads(json.dumps(bench))
    bench["configs"].append(TCP_CONFIG)
    bench["workloads"].append(TCP_CELL)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "local.assoc" in m.get("workloads", []) and not m["source"] == "device_trace":
            m["workloads"].append(TCP_CELL["name"])
    return bench


def make_root(tmp: Path) -> Path:
    """tmp laid out as a checkout's benchmark at the test size, with the TCP
    layout's cell; returns it."""
    g = tmp / "gwasbench"
    g.mkdir(parents=True)
    for d in ("metrics", "rooflines"):
        shutil.copytree(REPO / "gwasbench" / d, g / d)
    shutil.copy(REPO / "gwasbench" / "peaks.json", g / "peaks.json")
    (g / "configs").mkdir()
    (g / "workloads").mkdir()
    bench = with_tcp_cell(json.loads((REPO / "BENCHMARK.json").read_text()))
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg.update(ckks_params="TEST8", num_inds=[0, 100, 100], num_snps=300,
                   geno_block_snps=150)
        (tmp / c["file"]).write_text(json.dumps(cfg))
    for t in {c["traffic"] for c in bench["workloads"]}:
        tr = json.loads((REPO / "gwasbench" / "workloads" / f"{t}.json").read_text())
        if tr["unit"] == "std_inv":
            tr["values"], tr["warmup_values"] = 301, 129
        (g / "workloads" / f"{t}.json").write_text(json.dumps(tr))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def bench_of(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def check_line(res: dict, trace: bool) -> None:
    """The result line's keys and types, as the contract has them."""
    line = json.loads(json.dumps(res))
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in line, k
    assert isinstance(line["correct"], bool)
    assert line["attempted"] >= 1 and 0 <= line["failed"] <= line["attempted"]
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    d = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(d)
    if trace:
        assert {"busy_s", "window_s"} <= set(d)
        b = line["breakdown"]
        assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert list(line)[-1] == "checks"
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
