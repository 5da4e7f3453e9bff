"""A CPU rehearsal of each cell through the harness at the test size: one
warm-up unit, then a window of one unit, the answers compared with the
reference, a valid result line with `correct` true."""

import pytest

from gwasbench import run
from gwasbench.tests import helpers

CELLS = [("local.assoc", False), ("tcp.assoc", False), ("local.std_inv", False),
         ("local.assoc", True), ("tcp.assoc", True), ("local.std_inv", True)]


@pytest.mark.parametrize("cell,trace", CELLS)
def test_cell_rehearsal(tmp_path, cell, trace):
    root = helpers.make_root(tmp_path)
    bench = helpers.bench_of(root)
    res = run.run_cell(root, bench, cell, 2**33 + 7, 0.01, trace, device="cpu")
    helpers.check_line(res, trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 1 and res["failed"] == 0
    names = set(res["metrics"])
    if trace:
        want = {"assoc.encode_wait_s", "assoc.std_inv_s", "basis.s", "mm.product_s",
                "mhe.agg_bs_s", "net.bytes_per_snp"} if "assoc" in cell else {
                    "ss.sqrt_s", "ss_he.convert_s"}
        assert want <= names
        # no card: no device metric is read on the CPU
        assert not any(n.startswith(("device.", "kernel.")) for n in names)
    else:
        assert names == {"setup_s", "assoc_snps_per_s" if "assoc" in cell else "std_inv_s"}
