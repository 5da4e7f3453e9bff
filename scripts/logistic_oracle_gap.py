"""Where phase 13's logistic statistics stand against the plaintext oracles.

Six modes:

  python scripts/logistic_oracle_gap.py --stats chiprun_out/assoc_logistic.txt \
      --blocks 1 --epochs 2

reads a phase-13 run's party-1 statistics (chip_smoke.py writes
chiprun_out/assoc_logistic.txt) and prints their largest distance from the
oracle after 1, 2, 3, 4 and 50 Newton epochs, with the score test's
numerator as gwy_score_test computes it, g^T (y~ - o)
(chip_smoke.logistic_oracle), and as g^T y~ alone (the statistic that
leaves o out, which only the converged oracle may).  The data comes from
chip_smoke._logistic_data at --seed, 1000 individuals a data party and the
first --blocks of the study's blocks, as phase 13 made it.

  python scripts/logistic_oracle_gap.py --probe --epochs 3

runs phase 13's CPU rehearsal (TEST8, 2 x 100 individuals, 300 SNPs)
with each data party decrypting the Newton weights at every
compute_grad_and_inv_hessian call, and prints, per epoch, the largest
distance of the port's linear predictor Cm w from exact Newton's Z beta
and the part of it along the exact step (a scale error of the step would
show there).  About 4 minutes here.

  python scripts/logistic_oracle_gap.py --fit chiprun_out/assoc_logistic.txt \
      --blocks 1 --epochs 1

fits the covariate weights beta that the score test of a run's statistics
was computed at (least squares over the exact statistic, gwy_score_test's,
as a function of beta) and prints the fit's residual and beta's distance
from exact Newton's after --epochs, in the orthonormal basis of [1 | C]
(R beta, with Z = QR): the coordinates of the Newton weights a run got
wrong, the space the port's weights live in.

  python scripts/logistic_oracle_gap.py --card-runs 3

runs phase 13's CLI run (chip_smoke._logistic_study_runs, the card) that
many times and reveals, at party 1, the input and output of every 6 x 6
SS inverse of the run (mpc/linalg.py::matrix_inverse_sqrt_svd), printing
the input's spectrum and the output's error against numpy's inverse, and
each run's distance from the oracle; it saves them under
chiprun_out/probe13/.  The reveals add protocol rounds but no draw from a
shared PRG.

  python scripts/logistic_oracle_gap.py --replay chiprun_out/probe13/run0.npz \
      --replay-index 0 --seeds 8

runs the port's SS inverse at three parties on the CPU (threads, the
config's 256-bit field, 60 data bits, 30 fraction bits) on one input A
that --card-runs revealed, once for each PRG key (Philox [seed, pid],
seeds --first-seed onwards), and prints the output's error against numpy's inverse:
whether a failure comes with that input or with the masks.  About 30 s a
seed here.

  python scripts/logistic_oracle_gap.py --sweep 40 --workers 4

runs the 6 x 6 SS inverse (matrix_inverse_sqrt_svd) of both packages, the
port's and the JAX package's, at three parties on the CPU on the
near-scalar input of phase 13's first Newton epoch
(chip_smoke.near_scalar_input at --seed), once for each of N PRG keys
(Philox [key, pid], keys --first-seed onwards), and prints each run's
max |eig(B^T B (A + A^T)) - 1| and each package's failures (above
chip_smoke.INVERSE_TOL): the JAX package's Householder loses P's
orthogonality on near-zero columns (ROADMAP C), the port's brings them to
unit scale first.  About 20 s a key and package here, spread over
--workers processes.
"""

import argparse
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def _pooled(data, keep):
    G = np.concatenate([data[1][0], data[2][0]])[:, keep].astype(np.float64)
    G[G < 0] = 0.0
    y = np.concatenate([data[1][1], data[2][1]])
    Z = np.column_stack([np.ones(len(y)), np.concatenate([data[1][2], data[2][2]])])
    return G, y, Z


def newton(Z, y, epochs):
    """Exact Newton's linear predictors Z beta after 0..epochs steps."""
    beta = np.zeros(Z.shape[1])
    etas = [Z @ beta]
    for _ in range(epochs):
        p = 1 / (1 + np.exp(-Z @ beta))
        w = p * (1 - p)
        beta = beta + np.linalg.solve(Z.T @ (Z * w[:, None]), Z.T @ (y - p))
        etas.append(Z @ beta)
    return etas


def without_o(data, keep, epochs):
    """The statistic with the numerator g^T y~ alone."""
    G, y, Z = _pooled(data, keep)
    p = 1 / (1 + np.exp(-newton(Z, y, epochs)[-1]))
    w = p * (1 - p)
    ZW = Z * w[:, None]
    gzw = G.T @ ZW
    den = (w[:, None] * G * G).sum(0) - np.einsum("ij,jk,ik->i", gzw, np.linalg.inv(Z.T @ ZW),
                                                  gzw)
    return (G.T @ (y - p)) / np.sqrt(den)


def stats_mode(args):
    sizes = cs.STUDY_BLOCKS[: args.blocks]
    data = cs._logistic_data(args.seed, 1000, int(sum(sizes)))
    keep = cs.assoc_qc_oracle(data, cs.ASSOC_FILTER, 1000)
    got = np.loadtxt(args.stats)
    print(f"{args.stats}: {got.size} statistics, {args.blocks} block(s), run at "
          f"{args.epochs} epochs")
    for e in (1, 2, 3, 4, cs.LOGISTIC_CONVERGED_EPOCHS):
        print(f"  oracle at {e:2d} epochs: g^T (y~ - o) {np.abs(got - cs.logistic_oracle(data, keep, e)).max():.3e}"
              f", g^T y~ {np.abs(got - without_o(data, keep, e)).max():.3e}")


def probe_mode(args):
    import torch

    from sfgwas_tpu_torch.gwas import assoc as PA
    from sfgwas_tpu_torch.mpc import mhe as PM

    real = PA.compute_grad_and_inv_hessian
    weights, basis = {1: [], 2: []}, {}

    def decrypt(net, cps, cts):
        out = {}
        for p in (1, 2):
            mine = cts if net.pid == p else [None] * len(cts)
            pts = PM.collective_decrypt_many(net, cps, mine, p)
            out[p] = np.stack([np.asarray(cps.ctx.decode(pt)) for pt in pts])
        return out

    def probed(mpc, cps, Cm, C_scaled_up, y, w, *a, **k):
        if mpc.pid > 0:
            if mpc.pid not in basis:
                basis[mpc.pid] = decrypt(mpc.net, cps, [row[0] for row in Cm])
            weights[mpc.pid].append(decrypt(mpc.net, cps, list(w))[mpc.pid][0])
        return real(mpc, cps, Cm, C_scaled_up, y, w, *a, **k)

    PA.compute_grad_and_inv_hessian = probed
    n_loc = 100
    with tempfile.TemporaryDirectory() as out:
        data, _ = cs._logistic_study_runs(
            torch, args.seed, out, n_loc, [150, 150], platform="cpu",
            overrides={"ckks_params": "TEST8", "num_inds": [0, n_loc, n_loc], "num_snps": 300,
                       "epochs": args.epochs})
    U = np.concatenate([basis[1][1][:, :n_loc], basis[1][2][:, :n_loc]], axis=1).T
    G, y, Z = _pooled(data, np.ones(300, bool))
    etas = newton(Z, y, args.epochs)
    ncol = U.shape[1]
    for e, w in enumerate(weights[1]):  # the calls see the weights after 0..epochs epochs
        diff = U @ w[:ncol] - etas[e]
        line = f"  after {e} epoch(s): |Cm w - Z beta| {np.abs(diff).max():.3e}"
        if e:
            step = etas[e] - etas[e - 1]
            line += f", along the exact step {(diff @ step) / (step @ step):.3e} of it"
        print(line)


def fit_mode(args):
    from scipy.optimize import least_squares

    sizes = cs.STUDY_BLOCKS[: args.blocks]
    data = cs._logistic_data(args.seed, 1000, int(sum(sizes)))
    keep = cs.assoc_qc_oracle(data, cs.ASSOC_FILTER, 1000)
    got = np.loadtxt(args.fit)
    G, y, Z = _pooled(data, keep)
    exact = np.linalg.lstsq(Z, newton(Z, y, args.epochs)[-1], rcond=None)[0]

    def stat(beta):
        p = 1 / (1 + np.exp(-Z @ beta))
        w = p * (1 - p)
        ZW = Z * w[:, None]
        H = np.linalg.inv(Z.T @ ZW)
        gzw = G.T @ ZW
        den = (w[:, None] * G * G).sum(0) - np.einsum("ij,jk,ik->i", gzw, H, gzw)
        o = ZW @ (H @ (Z.T @ (y - p)))
        return (G.T @ (y - p - o)) / np.sqrt(den)

    fit = least_squares(lambda d: stat(exact + d) - got, np.zeros(Z.shape[1]))
    R = np.linalg.qr(Z)[1]
    np.set_printoptions(precision=4, linewidth=150)
    print(f"{args.fit}: {got.size} statistics; at exact Newton's beta after {args.epochs} "
          f"epoch(s) {np.abs(stat(exact) - got).max():.3e} off")
    print(f"  fitted beta: residual {np.abs(fit.fun).max():.3e}; R (beta - exact) {R @ fit.x}; "
          f"R exact {R @ exact}")


def card_mode(args):
    import json
    import time

    import torch

    from sfgwas_tpu_torch.mpc import linalg as PL
    from sfgwas_tpu_torch.ops import cuda_build

    real = PL.matrix_inverse_sqrt_svd
    calls = []

    def tofloat(v, mpc):
        v, q = int(v), mpc.ring.modulus
        return (v - q if v > q // 2 else v) / (1 << mpc.frac_bits)

    def probed(mpc, A):
        k = A.shape[0]
        a = mpc.reveal_sym(A.reshape((k * k,) + A.shape[2:]))
        B = real(mpc, A)
        b = mpc.reveal_sym(B.reshape((k * k,) + B.shape[2:]))
        if mpc.pid == 1:
            Af, Bf = (np.array([tofloat(v, mpc) for v in mpc.ring.to_ints(m)]).reshape(k, k)
                      for m in (a, b))
            S = Af + Af.T
            inv = np.linalg.inv(S)
            calls.append((Af, Bf))
            print(f"  inverse {len(calls)}: eig(A + A^T) {np.linalg.eigvalsh(S)}, largest "
                  f"off-diagonal {np.abs(S - np.diag(np.diag(S))).max():.3e}; B^T B "
                  f"{np.abs(Bf.T @ Bf - inv).max() / np.abs(inv).max():.3e} off (relative), "
                  f"eig(B^T B (A + A^T)) {np.linalg.eigvalsh(Bf.T @ Bf @ S)}", flush=True)
        return B

    PL.matrix_inverse_sqrt_svd = probed
    print(cs._smi(), flush=True)
    cuda_build.build()
    out = os.path.join(ROOT, "chiprun_out", "probe13")
    os.makedirs(out, exist_ok=True)
    for i in range(args.card_runs):
        t = time.time()
        calls.clear()
        data, runs = cs._logistic_study_runs(torch, args.seed, out, 1000, cs.LOGISTIC_BLOCKS)
        c = cs.logistic_study_check(data, runs, 1000, cs.LOGISTIC_RUN_EPOCHS)
        np.savez(os.path.join(out, f"run{i}.npz"), A=np.stack([a for a, _ in calls]),
                 B=np.stack([b for _, b in calls]), stats=runs["fresh"]["stats"][1])
        print(f"run {i}: {time.time() - t:.1f} s, party 1 {json.dumps(c[1])}", flush=True)


def replay_mode(args):
    from sfgwas_tpu_torch.mpc import linalg as PL
    from sfgwas_tpu_torch.parallel import simulate as PS

    A = np.load(args.replay)["A"][args.replay_index]
    k = A.shape[0]
    inv = np.linalg.inv(A + A.T)
    print(f"{args.replay}[{args.replay_index}]: eig(A + A^T) {np.linalg.eigvalsh(A + A.T)}")
    for seed in range(args.first_seed, args.first_seed + args.seeds):
        def party(mpc):
            mpc.rand.table[mpc.pid] = np.random.Generator(np.random.Philox(key=[seed, mpc.pid]))
            vals = [int(round(v * (1 << mpc.frac_bits))) for v in A.reshape(-1)]
            sh = PS.make_shares(mpc, vals)
            B = PL.matrix_inverse_sqrt_svd(mpc, sh.reshape((k, k) + sh.shape[1:]))
            return PS.reveal_ints(mpc, B.reshape((k * k,) + B.shape[2:])), mpc.ring.modulus, \
                mpc.frac_bits

        ints, q, fb = PS.run_parties(3, party)[1]
        Bf = np.array([(v - q if v > q // 2 else v) / (1 << fb) for v in ints]).reshape(k, k)
        print(f"  seed {seed}: B^T B {np.abs(Bf.T @ Bf - inv).max() / np.abs(inv).max():.3e} off "
              f"(relative), eig(B^T B (A + A^T)) {np.linalg.eigvalsh(Bf.T @ Bf @ (A + A.T))}",
              flush=True)


def _sweep_one(job):
    """One key of --sweep in a worker process: (package, key, error, seconds)."""
    import time

    pkg, key, seed = job
    if pkg == "jax":
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
        from sfgwas_tpu.mpc import linalg as L
        from sfgwas_tpu.parallel import simulate as S
    else:
        from sfgwas_tpu_torch.mpc import linalg as L
        from sfgwas_tpu_torch.parallel import simulate as S
    A = cs.near_scalar_input(seed)
    k = A.shape[0]

    def party(mpc):
        mpc.rand.table[mpc.pid] = np.random.Generator(np.random.Philox(key=[key, mpc.pid]))
        sh = S.make_shares(mpc, [int(round(v * (1 << mpc.frac_bits))) for v in A.reshape(-1)])
        B = L.matrix_inverse_sqrt_svd(mpc, sh.reshape((k, k) + sh.shape[1:]))
        return S.reveal_ints(mpc, B.reshape((k * k,) + B.shape[2:])), mpc.ring.modulus, \
            mpc.frac_bits

    t = time.time()
    ints, q, fb = S.run_parties(3, party)[1]
    Bf = np.array([(int(v) - q if int(v) > q // 2 else int(v)) / (1 << fb)
                   for v in ints]).reshape(k, k)
    return pkg, key, cs.inverse_sqrt_error(A, Bf), time.time() - t


def sweep_mode(args):
    import multiprocessing

    keys = range(args.first_seed, args.first_seed + args.sweep)
    jobs = [(pkg, key, args.seed) for key in keys for pkg in ("port", "jax")]
    failed = {"port": [], "jax": []}
    with multiprocessing.get_context("spawn").Pool(args.workers) as pool:
        for pkg, key, err, secs in pool.imap_unordered(_sweep_one, jobs):
            if not err <= cs.INVERSE_TOL:
                failed[pkg].append(key)
            print(f"  {pkg} key {key}: max |eig(B^T B (A + A^T)) - 1| {err:.3e} ({secs:.1f} s)",
                  flush=True)
    for pkg in ("port", "jax"):
        print(f"{pkg}: {len(failed[pkg])} of {len(keys)} keys failed (above "
              f"{cs.INVERSE_TOL}): {sorted(failed[pkg])}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stats", help="a phase-13 run's assoc_logistic.txt")
    ap.add_argument("--blocks", type=int, default=1)
    ap.add_argument("--epochs", type=int, default=cs.LOGISTIC_RUN_EPOCHS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--fit", help="a phase-13 run's assoc_logistic.txt")
    ap.add_argument("--card-runs", type=int, default=0)
    ap.add_argument("--replay", help="a --card-runs run's npz")
    ap.add_argument("--replay-index", type=int, default=0, help="which inverse of the run")
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--first-seed", type=int, default=0)
    ap.add_argument("--sweep", type=int, default=0, help="keys of the near-scalar inverse")
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args()
    if args.probe:
        probe_mode(args)
    elif args.stats:
        stats_mode(args)
    elif args.fit:
        fit_mode(args)
    elif args.card_runs:
        card_mode(args)
    elif args.replay:
        replay_mode(args)
    elif args.sweep:
        sweep_mode(args)
    else:
        ap.error("give --stats FILE, --fit FILE, --probe, --card-runs N, --replay FILE or "
                 "--sweep N")


if __name__ == "__main__":
    main()
