"""Times the SS ring's device ops of one tree of the port on the card, so
that two trees (for example a parent commit unpacked with `git archive`
and the working tree) can be compared in one call, in turns:

    python scripts/ring_staged_ab.py --tree _tree/parent
    python scripts/ring_staged_ab.py --tree .

Each run builds the tree's csrc/ring.cu into that tree's _build/, then, on
LElem256 at n = 198,674 elements (phase 16's square root stacks its g and h
to [198,674, 32]), times through ops/ring.py: add, sub, neg, mul_int(a, 2),
mul, mul_const (one constant row), sum over the leading axis of [2, 99,337,
32], from_i32 of [99,337] values, and ops/cuda_ring.py's reduce (K8) of
[198,674, 32] digits in [0, 510].  For each: the device ms per call (the
sum of every device kernel's duration in a torch.profiler trace of `reps`
calls, over the calls), the device kernels per call, the CUDA-event ms per
call, the bound (bytes moved at 3.35 TB/s: each input read once, a
broadcast row once, each output written once) and the results' SHA-256,
so the two trees' bits can be compared.  Prints one JSON line with the
card's name and power limit.  Needs a CUDA card; imports nothing of JAX.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)


def _device(torch, fn, reps):
    """(device ms per call, device kernels per call) over reps calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.002)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.002)
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.device_type() == torch.autograd.DeviceType.CUDA]
    return sum(e.end_ns() - e.start_ns() for e in ev) / reps / 1e6, len(ev) / reps


def _events_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=".", help="root of the tree whose port is timed")
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("ring_staged_ab.py: needs a CUDA card")
    from sfgwas_tpu_torch.ops import cuda_build, cuda_ring
    from sfgwas_tpu_torch.ops import ring as R

    if str(cuda_build.PKG) != os.path.join(os.path.realpath(tree), "sfgwas_tpu_torch"):
        sys.exit(f"ring_staged_ab.py: imported the port from {cuda_build.PKG}, not {tree}")
    t0 = time.time()
    cuda_build.build(["ring"])
    build_s = time.time() - t0
    ring = R.LElem256
    L, n, dev = ring.nlimb, 198_674, torch.device("cuda", 0)
    rng = np.random.default_rng(19)
    a = torch.as_tensor(np.array(ring.rand(rng, (n,)))).to(dev)
    b = torch.as_tensor(np.array(ring.rand(rng, (n,)))).to(dev)
    c = torch.as_tensor(ring.const_np(123456789123456789).copy()).to(dev)
    v = torch.as_tensor(rng.integers(0, 2**31 - 1, size=n // 2).astype(np.int32)).to(dev)
    digits = (a + b).contiguous()
    stacked = a.reshape(2, n // 2, L)
    e = 4 * n * L  # bytes of one [n, L] array
    ops = {  # name: (call, bytes moved)
        "reduce": (lambda: cuda_ring.reduce(ring, digits), 2 * e),
        "add": (lambda: ring.add(a, b), 3 * e),
        "sub": (lambda: ring.sub(a, b), 3 * e),
        "neg": (lambda: ring.neg(a), 2 * e),
        "mul_int": (lambda: ring.mul_int(a, 2), 2 * e),
        "mul": (lambda: ring.mul(a, b), 3 * e),
        "mul_const": (lambda: ring.mul_const(a, c), 2 * e + 4 * L),
        "sum": (lambda: ring.sum(stacked, axis=0), e + e // 2),
        "from_i32": (lambda: ring.from_i32(v), 4 * (n // 2) + e // 2),
    }
    saved = ring.host
    ring.host = False
    out = {}
    try:
        for name, (fn, nbytes) in ops.items():
            res = fn()
            torch.cuda.synchronize()
            sha = hashlib.sha256(res.cpu().numpy().tobytes()).hexdigest()[:16]
            dms, kernels = _device(torch, fn, args.reps)
            out[name] = {"device_ms": dms, "kernels_per_call": kernels,
                         "events_ms": _events_ms(torch, fn, args.reps),
                         "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "sha256_16": sha}
    finally:
        ring.host = saved
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"tree": args.tree, "card": smi, "device": torch.cuda.get_device_name(0),
                      "build_s": build_s, "n": n, "ops": out}))


if __name__ == "__main__":
    main()
