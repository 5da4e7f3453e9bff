"""The std-inverse round trip: one unit is gwas/assoc.py::compute_std_inv on
n values, n - 1 SNP variances (varx) and the phenotype's (vary), with every
SNP kept: HE -> SS, the SS square root and inverse, SS -> HE.  In set-up the
values are made from the seed, each data party encrypts its half, and the
aggregate is dropped to the level phase 7 hands it at; the warm-up unit
runs the same round trip on the first ciphertext's worth of them
(warmup_values).  The outputs of every timed unit are kept on the card and
decrypted once the window has closed.

The answers compared: each unit's decrypted 1/sqrt of every value at each
data party, against the reference's, by their largest and their
root-mean-square absolute difference.
"""

from __future__ import annotations

import os

import numpy as np

from .. import gen, reference

WORK_UNIT = "round trips"


def work(cfg: dict, traffic: dict) -> int:
    return 1


def make_inputs(seed: int, cfg: dict, traffic: dict, rundir: str):
    v = gen.variances(seed, traffic["values"], sum(cfg["num_inds"]))
    np.save(os.path.join(rundir, "variances.npy"), v)
    return v


def _inputs(mpc, cps, v: np.ndarray, nmod: int):
    """(varx, vary, filt, m) of compute_std_inv for the values v (the last is
    vary): each data party encrypts its share of varx (party 1 vary), the
    aggregate is dropped to nmod primes; the filter keeps every SNP."""
    from sfgwas_tpu_torch.crypto import basics as B
    from sfgwas_tpu_torch.mpc import mhe as PM

    m = len(v) - 1
    nct = -(-m // cps.slots)
    if mpc.pid == 0:
        return [None] * nct, None, None, m
    x = np.zeros(m)
    part = np.array_split(np.arange(m), mpc.net.nparty - 1)[mpc.pid - 1]
    x[part] = v[:m][part]
    y = v[m] if mpc.pid == 1 else 0.0
    cts = B.encrypt_float_vector(cps, x) + B.encrypt_float_vector(cps, [y])
    cts = [cps.ctx.drop_to(ct, nmod) for ct in PM.aggregate_cvec(mpc.net, cps, cts)]
    filt = np.zeros(nct * cps.slots, dtype=bool)
    filt[:m] = True
    return cts[:-1], cts[-1], filt, m


class Party:
    """One party's side: the encrypted inputs in the constructor (and a
    smaller set for the warm-up unit, index -1), then run() once a unit."""

    def __init__(self, mpc, cps, cfg: dict, traffic: dict, rundir: str, device):
        self.mpc, self.cps = mpc, cps
        v = np.load(os.path.join(rundir, "variances.npy"))
        nmod = traffic["input_nmod"]
        self.inputs = _inputs(mpc, cps, v, nmod)
        w = traffic["warmup_values"]
        self.warm = _inputs(mpc, cps, np.concatenate([v[: w - 1], v[-1:]]), nmod)
        self.m = self.inputs[3]
        self.kept = []

    def run(self, index: int) -> None:
        from sfgwas_tpu_torch.gwas.assoc import compute_std_inv

        varx, vary, filt, m = self.warm if index < 0 else self.inputs
        out = compute_std_inv(self.mpc, self.cps, varx, vary, m, filt)
        if self.mpc.pid > 0 and index >= 0:
            self.kept.append(out)

    def finish(self) -> dict:
        """Decrypts every unit's outputs (collectively, at the data parties):
        1/sqrt of the n - 1 varx values, then vary's."""
        from sfgwas_tpu_torch.mpc import mhe as PM

        if self.mpc.pid == 0:
            return {}
        ctx, got = self.cps.ctx, {}
        for i, (cx, cy) in enumerate(self.kept):
            pts = PM.collective_decrypt_many(self.mpc.net, self.cps, list(cx) + [cy], -1)
            x = np.concatenate([ctx.decode(pt) for pt in pts[:-1]])[: self.m]
            got[f"inv_sqrt{i}"] = np.concatenate([x, ctx.decode(pts[-1])[:1]])
        self.kept = []
        return got


def reference_outputs(v, cfg: dict, traffic: dict) -> dict:
    """What a sound program answers for one unit, by the reference."""
    return {"inv_sqrt0": reference.inv_sqrt(v), "parties": range(1, cfg["num_main_parties"] + 1)}


def compare(want: dict, outputs: dict, unit_ids) -> dict:
    """Units without an answer, and the largest and the root-mean-square
    absolute difference of 1/sqrt from the reference's (want,
    reference_outputs) over the units unit_ids at every data party."""
    parties, want = want["parties"], want["inv_sqrt0"]
    missing, worst, sq, cnt = 0, 0.0, 0.0, 0
    for pid in parties:
        out = outputs.get(pid, {})
        for i in unit_ids:
            got = out.get(f"inv_sqrt{i}")
            if got is None:
                missing += 1
                continue
            e = reference.abs_errors(got, want)
            worst = max(worst, e["max"])
            sq += e["rms"] ** 2 * want.size
            cnt += want.size
    return {"missing_answers": missing, "inv_sqrt_max_abs_err": worst,
            "inv_sqrt_rms_abs_err": float(np.sqrt(sq / cnt)) if cnt else 0.0}
