"""On the card: one short run of each cell through the command, and the
command's refusals.  Without a card the command exits 3 and prints nothing,
which runs here too."""

import json
import shutil
import subprocess
import sys

import pytest

from gwasbench.tests import helpers


def _run(cwd, cell, seconds=1, trace=0, timeout=900):
    return subprocess.run([sys.executable, "-m", "gwasbench.run", "--workload", cell, "--seed",
                           "3000000007", "--seconds", str(seconds), "--trace", str(trace)],
                          cwd=cwd, capture_output=True, text=True, timeout=timeout)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run(helpers.REPO, "local.std_inv")
    assert p.returncode == 3 and p.stdout == ""


@pytest.mark.needs_cuda
@pytest.mark.parametrize("cell", [w["name"] for w in helpers.bench_of(helpers.REPO)["workloads"]])
def test_cell_on_card(card, cell):
    p = _run(helpers.REPO, cell)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    helpers.check_line(res, False)
    assert res["correct"] and res["device"]["platform"] == "gpu", res


@pytest.mark.needs_cuda
def test_benchmark_alone_gives_no_result(card, tmp_path):
    """In a directory with BENCHMARK.json and the benchmark's files alone the
    program is missing: the command fails and prints no result."""
    shutil.copy(helpers.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(helpers.REPO / "gwasbench", tmp_path / "gwasbench")
    p = _run(tmp_path, "local.std_inv", timeout=300)
    assert p.returncode != 0 and p.stdout == ""
