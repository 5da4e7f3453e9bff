"""Where phase 13's logistic statistics stand against the plaintext oracles.

Two modes:

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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stats", help="a phase-13 run's assoc_logistic.txt")
    ap.add_argument("--blocks", type=int, default=1)
    ap.add_argument("--epochs", type=int, default=cs.LOGISTIC_RUN_EPOCHS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--probe", action="store_true")
    args = ap.parse_args()
    if args.probe:
        probe_mode(args)
    elif args.stats:
        stats_mode(args)
    else:
        ap.error("give --stats FILE or --probe")


if __name__ == "__main__":
    main()
