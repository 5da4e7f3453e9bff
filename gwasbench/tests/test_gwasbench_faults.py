"""A run driven through the harness (its look for a card skipped, on the CPU
at the test size) with the timed path broken underneath: `correct` has to
come out false for each fault the cells can have.  A fault takes an object
with monkeypatch's setattr; in the "tcp" layout every party process applies
it before it runs its party."""

import numpy as np
import pytest

from gwasbench import parties, run
from gwasbench.tests import helpers


def _answers_altered(mp):
    """An answer altered where it is produced: the first ciphertext of the
    statistics negated."""
    from sfgwas_tpu_torch.gwas import assoc

    real = assoc.get_association_stats

    def broken(mpc, cps, *a, **k):
        stats, filt = real(mpc, cps, *a, **k)
        if stats is not None:
            stats = [cps.ctx.mul_const_int(stats[0], -1)] + list(stats[1:])
        return stats, filt

    mp.setattr(assoc, "get_association_stats", broken)


def _half_left_out(mp):
    """Half of the batch left out: the second half of the SNPs' statistics
    dropped from the answer."""
    from sfgwas_tpu_torch.gwas import assoc

    real = assoc.get_association_stats

    def broken(*a, **k):
        stats, filt = real(*a, **k)
        if filt is not None:
            idx = np.flatnonzero(filt)
            filt = filt.copy()
            filt[idx[len(idx) // 2 :]] = False
        return stats, filt

    mp.setattr(assoc, "get_association_stats", broken)


def _exchange_left_out(mp):
    """The exchange between the parties left out: each data party keeps its
    own block product instead of the aggregate."""
    from sfgwas_tpu_torch.mpc import mhe

    mp.setattr(mhe, "aggregate_cmat", lambda net, cps, cm: cm)


def _state_unchanged(mp):
    """A step that returns its state unchanged: the SS square root and inverse
    hand back their input."""
    from sfgwas_tpu_torch.mpc.mpc import MPC

    mp.setattr(MPC, "sqrt_and_sqrt_inverse", lambda self, x, *a, **k: (x, x))


def _std_inv_answers_altered(mp):
    """An answer altered where it is produced: vary's inverse square root
    doubled."""
    from sfgwas_tpu_torch.gwas import assoc

    real = assoc.compute_std_inv

    def broken(mpc, cps, *a, **k):
        x, y = real(mpc, cps, *a, **k)
        if y is not None:
            y = cps.ctx.mul_const_int(y, 2)
        return x, y

    mp.setattr(assoc, "compute_std_inv", broken)


def _late(module: str, name: str, alter):
    """The fault `alter(cps, answer)` on every call of module.name after a
    party's first (the warm-up), so that only the window's units are
    wrong."""
    import importlib

    mod = importlib.import_module(module)
    real, calls = getattr(mod, name), {}

    def broken(mpc, cps, *a, **k):
        calls[mpc.pid] = calls.get(mpc.pid, 0) + 1
        out = real(mpc, cps, *a, **k)
        return alter(cps, out) if calls[mpc.pid] > 1 and out[0] is not None else out

    return mod, name, broken


def _late_answers_altered(mp):
    """An answer altered in the window's units only: the statistics' first
    ciphertext negated from each party's second call on."""
    def alter(cps, out):
        stats, filt = out
        return [cps.ctx.mul_const_int(stats[0], -1)] + list(stats[1:]), filt

    mp.setattr(*_late("sfgwas_tpu_torch.gwas.assoc", "get_association_stats", alter))


def _late_std_inv_altered(mp):
    """An answer altered in the window's units only: vary's inverse square
    root doubled from each party's second call on."""
    def alter(cps, out):
        return out[0], cps.ctx.mul_const_int(out[1], 2)

    mp.setattr(*_late("sfgwas_tpu_torch.gwas.assoc", "compute_std_inv", alter))


ASSOC_FAULTS = [_answers_altered, _half_left_out, _exchange_left_out, _state_unchanged,
                _late_answers_altered]
FAULTS = ([(cell, f) for cell in ("local.assoc", "tcp.assoc") for f in ASSOC_FAULTS]
          + [("local.std_inv", f) for f in (_state_unchanged, _std_inv_answers_altered,
                                            _late_std_inv_altered)])

PARTY_WITH_FAULT = """
import sys, types
from gwasbench.tests import test_gwasbench_faults as faults
getattr(faults, {name!r})(types.SimpleNamespace(setattr=setattr))
from gwasbench import party
sys.exit(party.main(sys.argv[1:]))
"""


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_is_not_correct(tmp_path, monkeypatch, cell, fault):
    root = helpers.make_root(tmp_path)
    if cell.startswith("tcp."):
        monkeypatch.setattr(parties, "PARTY_COMMAND",
                            ["-c", PARTY_WITH_FAULT.format(name=fault.__name__)])
    else:
        fault(monkeypatch)
    res = run.run_cell(root, helpers.bench_of(root), cell, 424242, 0.01, False, device="cpu")
    helpers.check_line(res, False)
    assert not res["correct"], res["checks"]
    assert res["failed"] == res["attempted"] == 1
