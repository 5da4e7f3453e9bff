"""What the harness loads: no module whose top-level name is JAX's, jaxlib's,
flax's or the JAX package's (sfgwas_tpu; the port, sfgwas_tpu_torch, is
another name), and the reference and the generators load nothing of the
program or of chip_smoke.py.  Each check runs in a fresh interpreter."""

import json
import subprocess
import sys

from gwasbench import parties
from gwasbench.tests import helpers

HARNESS = ["gwasbench.run", "gwasbench.parties", "gwasbench.party", "gwasbench.trace",
           "gwasbench.readers", "gwasbench.control", "gwasbench.units.assoc",
           "gwasbench.units.std_inv", "gwasbench.gen", "gwasbench.reference"]
# what the parties import when they run
PROGRAM = ["sfgwas_tpu_torch.gwas.assoc", "sfgwas_tpu_torch.gwas.qc",
           "sfgwas_tpu_torch.gwas.filestream", "sfgwas_tpu_torch.mpc.mhe",
           "sfgwas_tpu_torch.mpc.mpc", "sfgwas_tpu_torch.mpc.ss_he",
           "sfgwas_tpu_torch.parallel.transport", "sfgwas_tpu_torch.parallel.native_transport",
           "sfgwas_tpu_torch.ops.cuda_build", "sfgwas_tpu_torch.ops.native_ring",
           "sfgwas_tpu_torch.utils.prof"]


def _top_level_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=helpers.REPO, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    readers = [p for p in (helpers.REPO / "gwasbench" / "metrics").glob("*.py")]
    code = "\n".join(f"import {m}" for m in HARNESS + PROGRAM)
    code += "\nfrom pathlib import Path\nfrom gwasbench import trace\n" + "\n".join(
        f"trace.load_module(Path({str(p)!r}), 'm{i}')" for i, p in enumerate(readers))
    top = _top_level_after(code)
    assert "sfgwas_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "sfgwas_tpu"}, top


def test_reference_loads_nothing_of_the_program():
    top = _top_level_after("import gwasbench.reference, gwasbench.gen")
    assert not top & {"sfgwas_tpu_torch", "sfgwas_tpu", "chip_smoke", "jax", "torch"}, top


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "sfgwas_tpu_torch_fake.x", object())
    assert parties.jax_modules() == []
    monkeypatch.setitem(sys.modules, "sfgwas_tpu.fake", object())
    assert parties.jax_modules() == ["sfgwas_tpu"]
