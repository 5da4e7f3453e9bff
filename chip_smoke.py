#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (sfgwas_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]
    python3 chip_smoke.py --k1-only DIR --k1-shapes FILE

Phases (any failed check raises; the exit code is then nonzero):
 1. print the card's name and power limit (nvidia-smi);
 2. build the CUDA kernels from sfgwas_tpu_torch/csrc with nvcc (sm_90a),
    one nvcc per source, all started together, and print each kernel's
    registers, spills and stack frame from ptxas (a spill in any kernel, or
    a stack frame in K1, fails the run);
 3. the main path at PN14QP438, with every kernel launch count set to 0
    first: local keygen with rotation keys for exactly the shifts the plan
    needs, the diagonal encode of a 1000 x 4546 int8 genotype block in
    {0,1,2}, 8 encrypted columns of N(0,1) values, mat_mult_cached (one
    warm-up call, 3 timed calls), decrypt and decode against Q^T G in numpy
    (abs err < 1e-2); the counts are read right after.  Then one more call
    is timed stage by stage (synchronized spans) and one is traced with
    torch.profiler (device time by kernel, the device's idle share; a read
    of a device value by the host, aten::_local_scalar_dense, fails the
    run);
 4. the same product through the plain torch versions of every kernel on
    the card: the output ciphertexts must be bit-identical;
 5. each kernel against its plain version on the main path's own inputs
    (bit equality), with both timed by CUDA events, at every shape the
    main path launches it with: K1 at every (direction, prime rows, shape)
    that one mat_mult_cached call launches it with, as recorded at its
    wrapper, each with its launches per call, and K1's total over the call
    (launches x ms) beside the profiler's device time for K1; K3 at the
    hoisted and the grouped shapes, K2 at the block row;
 6. one JSON line of kernels, then the final line
    {"ok": true, "device": {...}}.

Needs a CUDA card; without one it exits nonzero and prints no result.
Writes the record to chiprun_out/chip_smoke.json, K1's shapes to
chiprun_out/k1_shapes.json and the profiler's table to
chiprun_out/mm_profile.txt.

--k1-only DIR --k1-shapes FILE times only K1, from the sfgwas_tpu_torch
package under DIR (for example another commit's tree), at the shapes of a
k1_shapes.json, each against its plain version, and prints one JSON line:
two trees are compared by running both in one call.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# integer operations per second: the card's 67 TFLOP/s float32 rate outside
# the tensor cores (NVIDIA data sheet), the only non-tensor rate published;
# a multiply-add counts as two operations, as a fused multiply-add does in
# that rate, and the int32 pipe is not faster, so this bounds the time from
# below.  It is the script's only integer peak.
INT_OPS_PER_S = 67e12


def _say(*a):
    print(*a, flush=True)


def _time_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call over `reps` calls after one warm-up,
    from CUDA events around the whole run."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _bound_ms(nbytes: float, ops: float):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _same(torch, a, b) -> bool:
    return a.shape == b.shape and bool(torch.equal(a, b))


def _profile(torch, fn, path: str) -> dict:
    """One call of fn under torch.profiler: device time by kernel name, the
    device's busy share of the traced window, and the full table in `path`.
    Raises when the trace holds no device kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        raise AssertionError("torch.profiler traced no device kernel")
    by_name: dict = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, t in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    busy += cur_e - cur_s
    window = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    readbacks = sum(1 for e in events if e.name == "aten::_local_scalar_dense")
    with open(path, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {
        "window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
        "device_sum_ms": sum(by_name.values()) / 1e3, "idle_share": 1 - busy / window,
        "kernels": len(dev), "top_ms": [[k[:80], v / 1e3] for k, v in top[:15]],
        "k1_ms": sum(v for k, v in by_name.items() if "ntt_" in k) / 1e3,
        "host_readbacks": readbacks,
    }


def _check(torch, kernels, name, kernel, source, replaces, shape, run, run_plain, reps, preps,
           nbytes, ops, timed=None):
    """Bit equality of run() and run_plain() (lists of tensors), then both
    timed; `timed` = (kernel, plain) callables to time instead.  Appends the
    kernel's record to `kernels`."""
    got, want = run(), run_plain()
    torch.cuda.synchronize()
    eq = all(_same(torch, a, b) for a, b in zip(got, want))
    err = 0 if eq else max(float((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
    del got, want
    ms = _time_ms(torch, (timed or (run, run_plain))[0], reps)
    pms = _time_ms(torch, (timed or (run, run_plain))[1], preps)
    bms, by = _bound_ms(nbytes, ops)
    kernels.append(dict(
        name=name, kernel=kernel, route="cuda", source=source, replaces=replaces,
        shape=shape, bit_equal=eq, max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
        bound_by=by, library_ms=None,
    ))
    torch.cuda.empty_cache()


def _k1_rows(torch, cuda_ntt, rns, basis, shapes, dev, kernels):
    """K1 against its plain version at each [inverse, rows, shape, launches
    per call] of `shapes`, on random residues of the rows' primes; returns
    K1's total over one call, sum of launches x ms."""
    total = 0.0
    for inverse, rows, shape, per_call in shapes:
        rows = tuple(rows)
        L, Bn, N = shape
        qcol = torch.tensor([basis.primes[r] for r in rows], device=dev)[:, None, None]
        x = torch.remainder(
            torch.randint(0, 1 << 30, (L, Bn, N), device=dev, dtype=torch.int64), qcol
        ).to(torch.int32)
        del qcol
        size = L * Bn * N
        sym = "ntt_inv" if inverse else "ntt_fwd"
        stages = basis.logn * (N // 2) + (N if inverse else 0)  # Shoup multiplies per poly
        _check(
            torch, kernels, f"{sym} {list(shape)}", sym, "sfgwas_tpu_torch/csrc/ntt.cu",
            f"sfgwas_tpu/ops/pallas_ntt.py:{114 if inverse else 90}", list(shape),
            lambda: [cuda_ntt.ntt_b_kernel(x, basis, rows, inverse)],
            lambda: [rns._ntt_b_butterfly(x, basis, rows, inverse)],
            max(5, min(200, int(4e8 // size))), 1 if size > 2e7 else 3,
            2 * size * 4 + 2 * L * N * 4, 3 * L * Bn * stages,
        )
        kernels[-1]["launches_per_mat_mult"] = per_call
        kernels[-1]["rows"] = list(rows)
        total += per_call * kernels[-1]["ms"]
        del x
    return total


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def k1_only(torch, root: str, shapes_path: str) -> int:
    """Time K1 of the package under `root` at the shapes in `shapes_path`."""
    sys.path.insert(0, os.path.abspath(root))
    from sfgwas_tpu_torch.crypto.params import get_params
    from sfgwas_tpu_torch.ops import cuda_build, cuda_ntt, rns

    smi = _smi()
    _say(smi)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cuda_build.build(["ntt"])
    with open(shapes_path) as f:
        rec = json.load(f)
    kernels: list = []
    total = _k1_rows(torch, cuda_ntt, rns, get_params(rec["preset"]).basis, rec["shapes"], dev,
                     kernels)
    bad = [k["name"] for k in kernels if not k["bit_equal"]]
    _say(json.dumps({"k1_tree": os.path.abspath(root), "card": smi, "k1_total_ms": total,
                     "kernels": kernels}))
    if bad:
        raise AssertionError(f"K1 differs from its plain version: {bad}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--k1-only", metavar="DIR", help="time only K1 of the package under DIR")
    ap.add_argument("--k1-shapes", metavar="FILE", help="K1's shapes (a k1_shapes.json)")
    args = ap.parse_args()
    if bool(args.k1_only) != bool(args.k1_shapes):
        ap.error("--k1-only and --k1-shapes go together")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if args.k1_only:
        return k1_only(torch, args.k1_only, args.k1_shapes)
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "chiprun_out")
    sys.path.insert(0, root)
    from sfgwas_tpu_torch.crypto import basics as B
    from sfgwas_tpu_torch.crypto import ckks as C
    from sfgwas_tpu_torch.crypto.params import get_params
    from sfgwas_tpu_torch.gwas import matmult as MM
    from sfgwas_tpu_torch.mpc.mhe import CryptoParams
    from sfgwas_tpu_torch.ops import cuda_build, cuda_ntt, rns
    from sfgwas_tpu_torch.utils import prof

    # ---- 1. the card
    smi = _smi()
    _say(smi)
    max_sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 2. build
    t0 = time.time()
    secs = cuda_build.build()
    _say(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
         f"({time.time() - t0:.1f} s wall)")
    ptxas = {name: cuda_build.ptxas_report(name) for name in cuda_build.SOURCES}
    for name, rep in ptxas.items():
        for k in rep:
            _say(f"ptxas {name}: {k['kernel'][:60]} {k['registers']} registers, "
                 f"spills {k['spill_stores']}/{k['spill_loads']} B, stack {k['stack']} B, "
                 f"smem {k['smem']} B")
    # K1 holds its 32 coefficients in registers: a stack frame means an
    # array went to local memory
    spilled = [k["kernel"] for n in cuda_build.SOURCES for k in ptxas[n]
               if k["spill_stores"] or k["spill_loads"] or (n == "ntt" and k["stack"])]
    if spilled or not all(ptxas[n] for n in cuda_build.SOURCES):
        raise AssertionError(f"ptxas: spills in {spilled} or no report")

    # ---- 3. the main path
    cuda_build.reset_launch_counts()
    t_main = time.time()
    params = get_params("PN14QP438")
    ctx = C.CkksContext(params)  # the card, kernels on
    rng = np.random.default_rng(args.seed)
    sk = ctx.gen_secret_key(rng)
    pk = ctx.gen_public_key(sk, rng)
    cps = CryptoParams(ctx, sk, pk, None, {}, rng)
    n_ind, n_snp, ncols = 1000, 4546, 8
    geno = rng.integers(0, 3, size=(n_ind, n_snp), dtype=np.int8)
    nmod = MM.mm_nmod(cps)
    t = time.time()
    cache = MM.preprocess_matrix(cps, geno, nmod)
    torch.cuda.synchronize()
    t_pre = time.time() - t
    d = cache[0][0].d
    shifts = set()
    for row in cache:
        for blk in row:
            shifts.update(int(b) for b in blk.babies)
            shifts.update((int(g) * d) % params.slots for g in blk.giants)
    shifts.discard(0)
    gels = sorted({ctx.galois_for_rotation(k) for k in shifts})
    t = time.time()
    cps.rot_keys.update(ctx.gen_rot_keys_batched(sk, gels, rng, key_nmod=params.mm_nmod))
    torch.cuda.synchronize()
    t_keys = time.time() - t
    Qm = rng.normal(size=(ncols, n_ind))
    A = [[ctx.drop_to(B.encrypt_float_vector(cps, Qm[i])[0], nmod)] for i in range(ncols)]
    out = MM.mat_mult_cached(cps, A, cache)  # warm-up
    torch.cuda.synchronize()
    iters = 3
    t = time.time()
    for _ in range(iters):
        out = MM.mat_mult_cached(cps, A, cache)
    torch.cuda.synchronize()
    dt = (time.time() - t) / iters
    got = np.stack([B.decode_float_vector(cps, [ctx.decrypt(row[0], sk)]) for row in out])
    want = Qm @ geno.astype(np.float64)
    err = float(np.abs(got[:, :n_snp] - want).max())
    launches = {k: v.launches for k, v in cuda_build.REGISTRY.items()}
    t_main = time.time() - t_main
    k_total = sum(len(blk.giants) for row in cache for blk in row)
    gmacs = 2 * ncols * k_total * nmod * ctx.n / dt / 1e9
    _say(f"main path: preprocess {t_pre:.2f} s, rotation keys ({len(gels)}) {t_keys:.2f} s, "
         f"whole path {t_main:.1f} s")
    _say(f"mat_mult_cached: {dt:.4f} s per block product, {gmacs:.3f} GMAC/s "
         f"({k_total} diagonals, nmod {nmod}, {ncols} columns)")
    _say(f"decode vs Q^T G: max abs err {err:.3e}")
    if not np.isfinite(got).all() or err >= 1e-2:
        raise AssertionError(f"decoded product off: max abs err {err}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    # launches of one mat_mult_cached call
    cuda_build.reset_launch_counts()
    out = MM.mat_mult_cached(cps, A, cache)
    torch.cuda.synchronize()
    per_call = {k: v.launches for k, v in cuda_build.REGISTRY.items()}
    _say(f"launches: main path {json.dumps(launches)}; one mat_mult_cached {json.dumps(per_call)}")
    # K1's (direction, prime rows, shape) in one call, recorded at its wrapper
    k1_calls: collections.Counter = collections.Counter()
    k1_launch = cuda_ntt.ntt_b_kernel

    def k1_recording(x, basis, rows, inverse=False):
        k1_calls[(bool(inverse), tuple(rows), tuple(x.shape))] += 1
        return k1_launch(x, basis, rows, inverse)

    cuda_ntt.ntt_b_kernel = k1_recording
    try:
        MM.mat_mult_cached(cps, A, cache)
        torch.cuda.synchronize()
    finally:
        cuda_ntt.ntt_b_kernel = k1_launch
    k1_shapes = [[inv, list(rows), list(shape), n] for (inv, rows, shape), n in
                 sorted(k1_calls.items(), key=lambda kv: kv[0][0])]
    for sym, inv in (("ntt_fwd", False), ("ntt_inv", True)):
        if sum(n for i, _, _, n in k1_shapes if i == inv) != per_call[sym]:
            raise AssertionError(f"K1 shapes recorded {k1_shapes} miss launches of {sym}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "k1_shapes.json"), "w") as f:
        json.dump({"preset": "PN14QP438", "shapes": k1_shapes}, f)
    # the stages of one call, each ended by a device synchronize
    prof.ENABLED, prof.SYNC = True, torch.cuda.synchronize
    prof.reset()
    MM.mat_mult_cached(cps, A, cache)
    stages = {k: v[0] * 1e3 for k, v in prof.totals().items()}
    prof.ENABLED, prof.SYNC = False, None
    _say(f"stages of one mat_mult_cached (ms, synchronized): {json.dumps(stages)}")
    os.makedirs(out_dir, exist_ok=True)
    profiled = _profile(torch, lambda: MM.mat_mult_cached(cps, A, cache),
                        os.path.join(out_dir, "mm_profile.txt"))
    profiled["stages_ms"] = stages
    _say(f"profile of one mat_mult_cached: {json.dumps(profiled)}")
    if profiled["host_readbacks"]:
        raise AssertionError(f"mat_mult_cached read {profiled['host_readbacks']} device "
                             "values back to the host")

    # ---- 4. the product through the plain versions, on the card
    pctx = C.CkksContext(params, device=dev, kernels=False)
    pcps = CryptoParams(pctx, sk, pk, None, cps.rot_keys, rng)
    t = time.time()
    pout = MM.mat_mult_cached(pcps, A, cache)
    torch.cuda.synchronize()
    _say(f"plain-path mat_mult_cached: {time.time() - t:.3f} s (first call)")
    same = all(
        _same(torch, a.c0, b.c0) and _same(torch, a.c1, b.c1)
        for ra, rb in zip(out, pout) for a, b in zip(ra, rb)
    )
    _say(f"output ciphertexts kernel path == plain path: {same}")
    if not same:
        raise AssertionError("kernel-path product differs from the plain-path product")

    # ---- 5. each kernel against its plain version at main-path shapes
    kernels = []
    ext_rows = tuple(range(nmod)) + (ctx.sp_row,)
    N = ctx.n
    logn = ctx.params.logn

    def check(*a, **kw):
        _check(torch, kernels, *a, **kw)

    # K1 at every shape of one call
    k1_total = _k1_rows(torch, cuda_ntt, rns, params.basis, k1_shapes, dev, kernels)
    _say(f"K1 over one mat_mult_cached: {k1_total:.4f} ms (sum of launches x ms), "
         f"profiler {profiled['k1_ms']:.4f} ms")
    plan = MM._plan_for(cps, cache, nmod, row_batch=ncols)
    gi = plan.giant_index(ctx)

    # K3 at the hoisted rotations of the real A against the real baby keys
    babies = [b for b in plan.babies[0] if b % params.slots != 0]
    gl = [ctx.galois_for_rotation(b) for b in babies]
    ik0, ik1 = cps.stacked_keys_inv(gl, nmod)
    C1s = torch.stack([A[i][0].c1 for i in range(ncols)])
    q_ext = ctx._t(ext_rows)["q"]
    mu_ext = rns.barrett_mu64(params.basis, ext_rows, dev)

    def ks_check(name, ext, k0, k1, reps, preps):
        G, S, J, X, _ = ext.shape
        Bk = k0.shape[1]
        nbytes = 4 * N * (G * S * J * X + 2 * G * Bk * J * X + 2 * G * S * Bk * X)
        macs = 2 * G * S * Bk * J * X * N
        check(name, "ks_digit_product", "sfgwas_tpu_torch/csrc/ks_digit.cu",
              "sfgwas_tpu/crypto/ckks.py:993" if Bk > 1 else "sfgwas_tpu/crypto/ckks.py:1050",
              [G, S, Bk, J, X, N],
              lambda: C.ks_digit_product(ext, k0, k1, q_ext, mu_ext, logn),
              lambda: C.ks_digit_product_plain(ext, k0, k1, q_ext), reps, preps,
              nbytes, 2 * macs)

    ext = ctx.decompose_ntt_b(C1s, nmod).contiguous()[None]
    ks_check("ks_digit_product (hoisted)", ext, ik0[None], ik1[None], 10, 2)
    del ext

    # K2 at the real block row: the baby rotations of A and the whole cache
    R0, R1 = MM.baby_rotations(cps, A, plan, 0)
    (g,) = plan.groups()[0]
    q_mm = ctx._t(range(nmod))["q"]
    mu_mm = rns.barrett_mu64(params.basis, range(nmod), dev)
    runs = g["runs"]
    acc_shape = (len(plan.segments) + 1, ncols, nmod, N)
    zeros = lambda: torch.zeros(acc_shape, dtype=torch.int32, device=dev)  # noqa: E731
    tacc0, tacc1 = zeros(), zeros()  # timed in place, as the product runs it
    E = int(runs.run_start_host[-1])
    nbytes = 4 * (2 * R0.shape[0] * ncols * nmod * N  # R0, R1: the row's babies
                  + k_total * nmod * N  # the diagonal polys
                  + 2 * 2 * runs.nruns * ncols * nmod * N)  # ACC rows read and written
    macs = 2 * E * ncols * nmod * N
    check(
        "mac_dense", "mac_dense", "sfgwas_tpu_torch/csrc/mac_dense.cu",
        "sfgwas_tpu/gwas/matmult.py:504", [runs.nruns, E, R0.shape[0], ncols, nmod, N],
        lambda: MM.mac_dense(zeros(), zeros(), R0, R1, g["polys"], runs, q_mm, mu_mm, logn),
        lambda: MM.mac_dense_plain(zeros(), zeros(), R0, R1, g["polys"], runs, q_mm),
        5, 1, nbytes, 2 * macs,
        timed=(lambda: MM.mac_dense(tacc0, tacc1, R0, R1, g["polys"], runs, q_mm, mu_mm, logn),
               lambda: MM.mac_dense_plain(tacc0, tacc1, R0, R1, g["polys"], runs, q_mm)),
    )
    del tacc0, tacc1
    # the real accumulators of this block row, for K3's grouped shape
    acc0, acc1 = MM.mac_dense(zeros(), zeros(), R0, R1, g["polys"], runs, q_mm, mu_mm, logn)
    del R0, R1

    # K3 at the grouped giant step: the real rotated segments of ACC1 and
    # their gathered keys, one key per group
    nrot = len(gi["gels"])
    ext = ctx.decompose_ntt_b(acc1[gi["rot"]].reshape(nrot * ncols, nmod, N), nmod)
    ext = ext.contiguous().view(nrot, ncols, nmod, nmod + 1, N)
    del acc0, acc1
    ig0, ig1 = cps.stacked_keys_inv(gi["uniq_gels"], nmod)
    ks_check("ks_digit_product (grouped)", ext, ig0[gi["gsel"]][:, None],
             ig1[gi["gsel"]][:, None], 10, 1)
    del ext

    for k in kernels:
        k["launches"] = launches[k["kernel"]]
        k.setdefault("launches_per_mat_mult", per_call[k["kernel"]])
    _say("kernel checks: " + ", ".join(
        f"{k['name']} equal={k['bit_equal']} {k['ms']:.4f} ms (plain {k['plain_ms']:.3f} ms, "
        f"bound {k['bound_ms']:.4f} ms by {k['bound_by']})" for k in kernels))
    bad = [k["name"] for k in kernels if not k["bit_equal"]]
    if bad:
        raise AssertionError(f"kernels differ from their plain versions: {bad}")

    record = {
        "kernels": kernels,
        "card": smi,
        "max_sm_clock_mhz": max_sm_mhz,
        "sm_count": torch.cuda.get_device_properties(0).multi_processor_count,
        "ptxas": ptxas,
        "main_path": {
            "preset": "PN14QP438", "block": [n_ind, n_snp], "columns": ncols,
            "diagonals": k_total, "nmod": nmod, "rotation_keys": len(gels),
            "secs_per_block_product": dt, "gmac_per_s": gmacs, "max_abs_err": err,
            "preprocess_s": t_pre, "rotation_keygen_s": t_keys, "path_s": t_main,
            "kernel_vs_plain_ciphertexts_equal": same,
        },
        "profile": profiled,
        "k1_total_ms": k1_total,
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    _say(json.dumps({"kernels": kernels}))
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
