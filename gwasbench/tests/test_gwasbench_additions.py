"""A cell made only of files written into a temporary directory (a
configuration, a traffic mix, a per-layer metric's reader and the lines of
BENCHMARK.json) runs with no edit to the harness: additions need none."""

import json
import shutil

from gwasbench import run
from gwasbench.tests import helpers


def test_cell_from_new_files_only(tmp_path):
    root = helpers.make_root(tmp_path)
    g = root / "gwasbench"
    cfg = json.loads((g / "configs" / "example_local.json").read_text())
    cfg["source"] = "a deployment that only this test knows"
    (g / "configs" / "tiny_local.json").write_text(json.dumps(cfg))
    tr = json.loads((g / "workloads" / "std_inv_99337.json").read_text())
    tr["values"], tr["warmup_values"] = 129, 65
    (g / "workloads" / "std_inv_129.json").write_text(json.dumps(tr))
    (g / "metrics" / "units.count.py").write_text(
        '"""Units in the traced window."""\n\n\ndef read(run):\n    return len(run["units"])\n')
    bench = helpers.bench_of(root)
    bench["configs"].append({"name": "tiny_local", "source": cfg["source"],
                             "file": "gwasbench/configs/tiny_local.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "tiny.std_inv", "config": "tiny_local",
                               "traffic": "std_inv_129", "chips": 1, "why": "a test"})
    bench["end_to_end"][1]["workloads"].append("tiny.std_inv")
    bench["per_layer"].append({"name": "units.count", "unit": "units", "better": "higher",
                               "source": "host_clock", "layer": "harness",
                               "moves": "std_inv_s", "workloads": ["tiny.std_inv"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run.run_cell(root, bench, "tiny.std_inv", 5, 0.01, True, device="cpu")
    assert res["correct"], res["checks"]
    assert res["metrics"]["units.count"] == {"value": 1.0, "unit": "units"}
    assert not (helpers.REPO / "gwasbench" / "metrics" / "units.count.py").exists()
    shutil.rmtree(root)
