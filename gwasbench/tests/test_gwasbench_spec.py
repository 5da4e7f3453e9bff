"""BENCHMARK.json against the benchmark's contract, and every file it names
present: configurations, traffic mixes, metric readers, roofline counts."""

import json
import re

from gwasbench.tests import helpers

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json():
    path = helpers.REPO / "BENCHMARK.json"
    assert path.stat().st_size <= 64 * 1024
    b = json.loads(path.read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["gwasbench"] and 1 <= len(b["command"]) <= 32
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    # a full check with 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    cfgs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("gwasbench/") and (helpers.REPO / c["file"]).exists()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        data = json.loads((helpers.REPO / c["file"]).read_text())
        assert set(c["reduced"]) == set(data["reduced"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in cfgs and w["chips"] in (1, 4)
        assert (helpers.REPO / "gwasbench" / "workloads" / f"{w['traffic']}.json").exists()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        mine = [m for m in b["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(mine) >= 2 and "setup_s" in {m["name"] for m in mine}
        assert any(w["name"] in m["workloads"] for m in b["per_layer"])
    assert {c["config"] for c in b["workloads"]} == set(cfgs)
    cells = {w["name"] for w in b["workloads"]}
    names = set()
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= cells
        assert (helpers.REPO / "gwasbench" / "metrics" / f"{m['name']}.py").exists()
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
            kernel = m["name"].split(".")[-1][: -len("_roofline")]
            assert kernel in {"ntt", "mac"}
    for p in (helpers.REPO / "gwasbench" / "rooflines").glob("*.py"):
        assert p.stem == "__init__" or "def work" in p.read_text()


def test_traffic_limits():
    for p in (helpers.REPO / "gwasbench" / "workloads").glob("*.json"):
        t = json.loads(p.read_text())
        assert (helpers.REPO / "gwasbench" / "units" / f"{t['unit']}.py").exists()
        assert t["limits"]["missing_answers"] == 0
