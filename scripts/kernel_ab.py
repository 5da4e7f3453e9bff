"""Times K5's mask (bs_mask), K10 (ring_matmul) and K11 (ring_dot) of one
tree of the port on the card, so that two trees (for example a parent
commit unpacked with `git archive` and the working tree) can be compared
in one call, in turns:

    python scripts/kernel_ab.py --tree _tree/parent
    python scripts/kernel_ab.py --tree .
    python scripts/kernel_ab.py --tree .
    python scripts/kernel_ab.py --tree _tree/parent

Each run builds the tree's csrc/bs_share.cu and csrc/ring.cu into that
tree's _build/, then times through the tree's wrappers, at the shapes the
main path launches them with (PN14QP438, N = 16,384):
  * bs_mask at [nwords, B, L, Lf]: [3, 8, 3, 17] (the MHE phase's 3-word
    refresh), [6, 7, 5, 17] (the association's refresh of its 7 products),
    [10, 12, 9, 11] (the QR band refresh), [18, 1, 17, 17] (the preset's
    widest mask) and two grids that fill the card ([3, 64, 3, 17], [10,
    48, 9, 11]: many ciphertexts refreshed at once), on the tables
    mhe._bs_tables builds for rows
    0..L-1 and 0..Lf-1, with the kernel the tree's wrapper picks (and,
    where the tree has mhe.bs_mask_split, at each split 1, 2 and 4 too);
  * ring_matmul on LElem256 at 6 x 6 x 6 (the SS inverse's products) and 3
    x 900 x 2 (a long sum);
  * ring_dot on LElem256 at [99,337, 37] . [37] (the normaliser);
  * an empty kernel, built here from a two-line source with the same nvcc
    flags, bound and launched the same way (ctypes, the current stream)
    with the grid the tree's ring_matmul takes at 6 x 6 x 6: K10's floor.
For each: the device ms per call (the sum of every device kernel's
duration in a torch.profiler trace of `reps` calls, over the calls), the
device kernels per call, the CUDA-event ms per call, the bound (the larger
of the bytes moved at 3.35 TB/s, each input read once and each output
written once, and the integer operations at 33.5e12 a second, a
multiply-add counted as two) and the results' SHA-256, so that the two
trees' bits can be compared.  Prints one JSON line with the card's name
and power limit, and the build's ptxas registers, stack bytes, spill
stores and spill loads of each kernel timed.
Needs a CUDA card; imports nothing of JAX.
"""

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
INT_OPS_PER_S = 33.5e12  # H100 SXM INT32 peak (NVIDIA H100 white paper), as in chip_smoke.py
THREEFRY_OPS = 20 * 3 + 5 * 2 + 2 + 1  # as chip_smoke.py counts a Threefry-2x32 word
BARRETT_OPS = 6
MASK_SHAPES = ([3, 8, 3, 17], [6, 7, 5, 17], [10, 12, 9, 11], [18, 1, 17, 17], [3, 64, 3, 17],
               [10, 48, 9, 11])
MATMUL_SHAPES = ((6, 6, 6), (3, 900, 2))
DOT_SHAPE = (99_337, 37)
EMPTY_SRC = r"""
__global__ void empty_kernel() {}
extern "C" int empty_launch(unsigned blocks, int threads, void* stream) {
    empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
"""


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


def _empty_kernel(cuda_build):
    """The empty kernel's launcher, built beside the tree's libraries."""
    src = cuda_build.BUILD_DIR / "empty_kernel.cu"
    lib = cuda_build.BUILD_DIR / "libempty_kernel.so"
    src.write_text(EMPTY_SRC)
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True, capture_output=True, timeout=600)
    fn = ctypes.CDLL(str(lib)).empty_launch
    fn.argtypes = [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _sha(torch, outs):
    h = hashlib.sha256()
    for t in outs:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


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
        sys.exit("kernel_ab.py: needs a CUDA card")
    from sfgwas_tpu_torch.crypto import ckks as C
    from sfgwas_tpu_torch.crypto.params import get_params
    from sfgwas_tpu_torch.mpc import mhe as PM
    from sfgwas_tpu_torch.ops import cuda_build, cuda_ring
    from sfgwas_tpu_torch.ops import ring as R

    if str(cuda_build.PKG) != os.path.join(os.path.realpath(tree), "sfgwas_tpu_torch"):
        sys.exit(f"kernel_ab.py: imported the port from {cuda_build.PKG}, not {tree}")
    dev = torch.device("cuda", 0)
    t0 = time.time()
    cuda_build.build(["bs_share", "ring"])
    build_s = time.time() - t0
    empty = _empty_kernel(cuda_build)
    out: dict = {}

    def timed(name, fn, nbytes, ops, extra=None):
        res = fn()
        torch.cuda.synchronize()
        dms, kernels = _device(torch, fn, args.reps)
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT_OPS_PER_S * 1e3
        out[name] = {"device_ms": dms, "kernels_per_call": kernels,
                     "events_ms": _events_ms(torch, fn, args.reps),
                     "bound_ms": max(tb, to), "bound_by": "bytes" if tb >= to else "operations",
                     "sha256_16": _sha(torch, res if isinstance(res, (tuple, list)) else [res]),
                     **(extra or {})}

    params = get_params("PN14QP438")
    ctx = C.CkksContext(params, device=dev)
    N, logn = params.n, params.logn
    for nwords, b, L, Lf in MASK_SHAPES:
        tl = PM._bs_tables(ctx, tuple(range(L)), nwords)
        tf = PM._bs_tables(ctx, tuple(range(Lf)), nwords)
        variant = (PM.bs_mask_variant(tl, tf, nwords, logn) if hasattr(PM, "bs_mask_variant")
                   else "register" if tl["fast"] and tf["fast"] and nwords <= 4 else "generic")
        cols = b * N
        ops = cols * (nwords * (THREEFRY_OPS + 2) + (L + Lf) * (2 * nwords + BARRETT_OPS))
        run = lambda: PM.bs_mask(tl, tf, (7, 8), 3, b, nwords, 23 if nwords < 18 else 13, logn)
        if not hasattr(PM, "bs_mask_split"):
            timed(f"bs_mask {[nwords, b, L, Lf, N]}", run, 4 * (L + Lf) * cols, ops,
                  {"variant": variant})
            continue
        chosen = PM.bs_mask_split(b, logn)
        timed(f"bs_mask {[nwords, b, L, Lf, N]}", run, 4 * (L + Lf) * cols, ops,
              {"variant": variant, "split": chosen})
        rule = PM.bs_mask_split
        try:  # the register kernel at each split, whichever the rule picks
            for split in (1, 2, 4):
                PM.bs_mask_split = lambda *a: split  # noqa: B023
                timed(f"bs_mask {[nwords, b, L, Lf, N]} split={split}", run,
                      4 * (L + Lf) * cols, ops, {"variant": variant, "split": split})
        finally:
            PM.bs_mask_split = rule
    ring = R.LElem256
    Lr, W = ring.nlimb, ring.nlimb // 4
    rng = np.random.default_rng(20)
    for r, k, c in MATMUL_SHAPES:
        A = torch.as_tensor(np.array(ring.rand(rng, (r, k)))).to(dev)
        B = torch.as_tensor(np.array(ring.rand(rng, (k, c)))).to(dev)
        timed(f"ring_matmul {[r, k, c]}", lambda: cuda_ring.matmul(ring, A, B),
              4 * Lr * (r * k + k * c + r * c), 2 * W * W * r * k * c)
    n, k = DOT_SHAPE
    # canonical LElem256 digits drawn on the card: a top digit below 255
    # keeps the value below 2^256 - 2^248 < p256
    gen = torch.Generator(device=dev).manual_seed(20)
    a = torch.randint(0, 256, (n, k, Lr), generator=gen, device=dev, dtype=torch.int32)
    a[..., -1] %= 255
    cf = torch.as_tensor(np.array(ring.rand(rng, (k,)))).to(dev)
    timed(f"ring_dot {[n, k, Lr]}", lambda: cuda_ring.dot(ring, a, cf),
          4 * Lr * (n * k + k + n), 2 * W * W * n * k)
    # the empty kernel at the grid this tree's K10 launches at 6 x 6 x 6: a
    # warp an element (4 a block) where the tree has MATMUL_MAX_K, else one
    # thread an element (128 a block)
    warp_each = hasattr(cuda_ring, "RING_MATMUL_MAX_K")
    grid, threads = ((36 + 3) // 4, 128) if warp_each else (1, 128)

    def launch_empty():
        rc = empty(grid, threads, torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"empty kernel: CUDA error {rc}")
        return []

    timed("empty kernel (K10's 6 x 6 x 6 grid)", launch_empty, 0, 0,
          {"grid": [grid, threads]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    ptxas = {k["kernel"]: [k["registers"], k["stack"], k["spill_stores"], k["spill_loads"]]
             for name in ("bs_share", "ring") for k in cuda_build.ptxas_report(name)
             if "mask" in k["kernel"] or "matmul" in k["kernel"] or "dot" in k["kernel"]}
    print(json.dumps({"tree": args.tree, "card": smi, "device": torch.cuda.get_device_name(0),
                      "build_s": build_s, "ops": out, "ptxas": ptxas}))


if __name__ == "__main__":
    main()
