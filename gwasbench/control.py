"""The control of a cell's comparison: the program run with the precision
one step below the one its configuration states, judged by the cell's own
comparison and limits.  The configuration states the secret-sharing
fixed point, mpc_frac_bits (30 fraction bits); the control runs the cell
with FRAC_BITS (20) in its place.  It must come out not correct on every
seed.

    python3 -m gwasbench.control --workload <cell> --seeds 1 2 3 [--frac-bits 24]

runs each seed as one run of the cell (the warm-up unit and one timed
unit) and prints one JSON line a seed: the numbers compared, their limits
and `correct`.  --frac-bits reads another step.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .run import run_cell
from .trace import load_json

# the SS fraction bits of the control, in place of the configuration's 30
FRAC_BITS = 20


def control(root: Path, bench: dict, name: str, seed: int, device=None,
            frac_bits: int = FRAC_BITS) -> dict:
    res = run_cell(root, bench, name, seed, 0.01, False, device, {"mpc_frac_bits": frac_bits})
    return {"workload": name, "seed": seed, "mpc_frac_bits": frac_bits,
            **{k: res[k] for k in ("correct", "attempted", "failed", "readings", "checks")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frac-bits", type=int, default=FRAC_BITS)
    args = ap.parse_args(argv)
    root = Path.cwd()
    bench = load_json(root / "BENCHMARK.json")
    for seed in args.seeds:
        print(json.dumps(control(root, bench, args.workload, seed, frac_bits=args.frac_bits)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
