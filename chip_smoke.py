#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (sfgwas_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]
    python3 chip_smoke.py --tree DIR --shapes FILE
    python3 chip_smoke.py --pca-probe

Phases (any failed check raises; the exit code is then nonzero):
 1. print the card's name and power limit (nvidia-smi);
 2. build the CUDA kernels from sfgwas_tpu_torch/csrc with nvcc (sm_90a),
    one nvcc per source, all started together, and print each kernel's
    registers, spills and stack frame from ptxas (a spill in any kernel, or
    a stack frame in K1, fails the run);
 3. the main path at PN14QP438, with every kernel launch count set to 0
    first: local keygen with rotation keys for exactly the shifts the plan
    needs (K4's launches recorded at its wrapper), the diagonal encode of a 1000 x 4546 int8 genotype block in
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
    (bit equality) at every shape the main path launches it with, timed:
    the kernel's device time per launch from torch.profiler (`ms`; a trace
    without a launch of its kernel is taken again, and after three such
    traces `ms` is the CUDA-event time of one call and `ms_from` says
    "events" where it otherwise says "profiler"), the
    CUDA-event time of one wrapper call (`call_ms`, which includes the
    host's work around the launch) and the plain version's (`plain_ms`):
    K1 at every (direction, prime rows, shape) that one mat_mult_cached
    call launches it with, as recorded at its wrapper, each with its
    launches per call, and K1's total over the call (launches x ms) beside
    the profiler's device time for K1; K4 at every
    draw of the rotation keygen; K3 at the hoisted and the grouped shapes,
    K2 at the block row;
 6. the MHE collective layer at PN14QP438, with every launch count set to
    0 first: three parties (dealer 0, data parties 1 and 2, hub 1) as
    threads on the card run collective_init with the default shift set
    (303 rotation keys, the public and relinearisation keys; set-up
    seconds split into the three), each data party encrypts 8 vectors of
    8192 N(0,1) values under the collective key, the 8 are aggregated and
    dropped to nmod 3, then collective_bootstrap_many refreshes them to the
    matmult band (the scale-reset path) and to the top, and
    collective_decrypt_many decodes both within 1e-3 of the numpy sum at
    each data party (ms per bootstrap and per decrypt of 8: mean of 3 after
    a warm-up); the counts are read right after.  One band bootstrap is
    traced with torch.profiler over all threads (the idle share; a host
    read-back fails the run).  K1 (at every direction, rows and shape), K4,
    K5 (bs_mask, bs_combine) and K6 are held bit for bit against their
    plain versions at every shape the phase launches them with, recorded at
    their wrappers (K4-K6 on the phase's own inputs, K1 on random residues
    of the rows' primes), and timed; a bs_mask record names the kernel
    that took it (the register kernel, with its split, or the generic
    one), and every path's mask launches by word count go to
    chip_smoke.json's k5_launches_by_nwords;
 7. the secret-sharing domain and the SS<->HE bridge at PN14QP438: three
    parties as threads on the card (dealer 0, data parties 1 and 2, hub 1;
    run_parties with the 256-bit field, 60 data bits, 30 fraction bits,
    boolean shares and the native ring engine) under collective keys from
    collective_init with an empty shift set (the conjugation key alone).
    The std-inverse round trip of sfgwas_tpu/gwas/assoc.py:383-410 at the
    example's size, n = 99,337 (99,336 SNP variances and the phenotype's,
    uniform in [0.01, 4] from --seed): each data party encrypts its half as
    13 ciphertexts of 8192 slots (and party 1 the phenotype's), they are
    aggregated and dropped to nmod 3, then cvec_to_ss / ciphertext_to_ss
    (whose guard refreshes them through the collective bootstrap first),
    sqrt_and_sqrt_inverse over all n values, ss_to_cmat / ss_to_ciphertext
    and collective_decrypt_many: 1/sqrt(v) within 1e-4 max(1, 1/sqrt(v)) of
    numpy at both data parties.  One warm-up round trip at n = 8,192 (also
    checked), then the timed one, with every launch count set to 0 just
    before it and read right after it: party 1's stages as synchronized
    spans, its square root under a host profile (shares in the native
    engine, in Beaver partitions, in the ring draws and in transport waits),
    the round trip under torch.profiler over all threads (the device's idle
    share; a read of a device value by the host fails the run, and so do
    more device -> host copies than the hub's one a converted ciphertext).
    Then chol_whiten of a 6 x 6 Gram (the example's 5 covariates and the
    ones column, from --seed): W upper triangular, W^T G W = I within 2e-2.
    K1, K4, K5 and K6 are held bit for bit against their plain versions at
    every shape the timed round trip launched them with, recorded at their
    wrappers, and timed;
 8. the CholeskyQR2 covariate basis at PN14QP438: three parties as
    threads on the card (run_parties as in phase 7) under collective keys
    from collective_init with the default shift set (303 rotation keys and
    the relinearisation key); each data party holds 1000 individuals with
    5 covariates from --seed (column scales 1, 20, 0.1, 50, 0.3), and
    compute_combined_q (cholqr2 with the ones column: 6 columns, 21 Gram
    pairs, 2 passes) runs once as a warm-up, once timed (every launch count
    set to 0 just before it and read right after it; party 1's spans
    cholqr_gram, cholqr_ss, cholqr_recombine, he2ss, ss2he and bootstrap,
    synchronized) and once under torch.profiler over all threads (device
    busy and idle share, device ms by kernel and of the labelled plain-torch
    programs of ROADMAP B12-B14, device -> host copies).  Each data party
    decrypts its rows of the timed Q collectively: Q^T Q within QR_TOL of I
    and Q within QR_TOL of numpy's QR of [ones | covariates] (diag(R) > 0),
    after dividing by sqrt(2000), every ciphertext at one (nmod, scale).
    K1, K3 (the relinearisation and the rotation ladder), K4, K5 and K6
    are held bit for bit against their plain versions at every shape the
    timed call launched them with, recorded at their wrappers, and timed.
    Then net_qr(method="householder") (gwas/qrfact.py::net_dqr_enc) runs
    once on each of two inputs over the same 2 x 1000 rows: [ones |
    covariates] (6 columns) and a N(0,1) matrix of 15 columns from --seed
    (PCA's width at config/configGlobal.toml's 5 PCs and 10 oversampling
    columns), every launch count set to 0 just before each and read
    right after it, the kernels' inputs recorded at their wrappers
    during each, party 1's spans synchronized (qr_sqsum, qr_aggz,
    qr_ispos, qr_ss2he, qr_uvec_mul, qr_dcmm, qr_backward); each Q,
    decrypted collectively and divided by sqrt(2000), within HH_TOL =
    1e-4 of numpy's QR (each column with the sign of the Householder
    one) and Q^T Q within 1e-4 of I; then K1 and K3-K6 against their
    plain versions at every shape of each call that no earlier check
    held.  K5's generic kernel, which no path of this preset launches
    (every mask has at most 18 words on primes within the register
    kernel's lazy bound), is held to its plain version and timed at the
    CholeskyQR's widest mask, off the path (qr.bs_mask_generic_off_path);
 9. the linear association phase at PN14QP438, phases 1 and 3 of
    sfgwas_tpu/gwas/protocol.py driven by hand: three parties as threads on
    the card (run_parties as in phase 7) under collective keys from
    collective_init with the default shift set; each data party holds 1000
    individuals, 5 covariates (phase 8's scales) and 1 block of 4546 SNPs
    (genotype files with about 1% missing calls, MAF uniform in [0.02,
    0.5], and the plink2 count file, all from --seed; the example's SNP
    axis of 99,336 cut to 4,546), and a phenotype with 5 planted effects.
    QC from the counts (config/configGlobal.toml's thresholds), the column
    filters on the blocks' streams with missing read as 0, then
    get_association_stats twice: traced under torch.profiler over all
    threads (the device's busy and idle share, device ms by kernel and of
    the labelled plain-torch programs, peak device memory; a host read of a
    device value fails the run), then timed with every launch count set to
    0 just before it and read right after it (party 1's spans qc,
    combined_q, assoc_ynew, assoc_block with assoc_encode_wait, assoc_mm
    and assoc_agg_bs inside it, assoc_sxx, assoc_syy, std_inv and decrypt,
    synchronized).  The revealed SNP filter must equal a plaintext QC
    oracle of the same counts and every decrypted statistic lie within
    2e-2 of the plaintext oracle (the QR projection of
    tests/test_e2e_gwas.py) with Pearson corr > 0.999; K2 must have run
    once per block at each data party.  K1, K2, K3, K4, K5 and K6 are held
    bit for bit against their plain versions at every shape the timed call
    launched them with, recorded at their wrappers, and timed;
10. the linear skip-PCA study through the port's CLI at the example's
    width: cli.main(["--local-sim", "3", "--config-global", ...])
    in this process with no --platform (the card), a config of
    config/configGlobalSkipPCA.toml's flags (PN14QP438, its thresholds, QC
    from the plink2 counts, use_cached_keys, use_cached_qc,
    use_cached_combined_q, skip_pca) and paths in {pid} form, on data from
    --seed in a temporary directory removed at the end: per data party
    1000 individuals, 5 covariates and the first of the config's 22
    blocks, 4,546 SNPs (phase 9's generators).  Run
    1 is fresh, with every launch count set to 0 before it and read after
    it: all six kernels launched, K2 once a block at each data party and
    held bit for bit against its plain version on the same inputs right
    after each launch, the
    revealed filter equal to the QC oracle and the statistics within 2e-2
    of the plaintext oracle with corr > 0.999.  Run 2 resumes from run 1's
    caches: every party's bundle restored from its key directory, K2
    launched 0 times, the statistics within 2e-3 of run 1's.  Each run's
    command seconds, party 1's qc / pca / assoc seconds from the
    protocol's own line, its host-clock spans, keygen or restore seconds
    per party, key-directory write seconds, peak device memory and peak
    host RSS are recorded; then K2 is timed at its first launch and K1,
    K3, K4, K5 and K6 are held against their plain versions at every shape
    of run 1 that no earlier phase checked, recorded at their wrappers.
    After run 2 the same temporary directory holds phase 14's run;
11. the same study at 1 of the config's 22 blocks (4,546 SNPs) as three
    party processes over loopback TCP: this script started
    again once a party (--party-run, PID in the environment, after this
    process built the six kernels, the ring engine and the transport
    library), each running cli.main with the global config (a
    [servers.partyN] map on 127.0.0.1 at free ports, one channel a pair)
    and its own local config and no --platform, with phase 10's hooks and
    cpu_count // 3 OpenMP threads.  Run 1 is fresh: every party's launch
    counts set to 0 before and read after its run, all six kernels
    launched, K2 once at each data party and held bit for bit against
    its plain version right after each launch in the process that launched
    it, the filter and the statistics held to the oracles; then, one party
    at a time, K1 and K3-K6 against their plain versions at every shape of
    the party's run that no earlier check held.  Run 2 resumes from run
    1's caches (every bundle restored, K2 launched 0 times, the statistics
    within 2e-3 of run 1's).  Recorded per run: the seconds from the first
    start to the last run record and to the last exit, each party's
    protocol line, keygen or restore seconds, bytes and messages per peer
    (Network's counters over the whole run), peak device memory and host
    RSS, and the card's peak used memory (nvidia-smi).  A party that fails
    or runs out of time stops the others and fails the run;
12. the default-config study with PCA through the port's CLI, in this
    process as phase 10 runs its study: config/configGlobal.toml's flags
    (PN14QP438, its QC thresholds and count route, use_cached_keys, 5 PCs
    with 10 oversampling columns, cholqr2, snp_dist_thres 100,000), per
    data party 1000 individuals and 5 covariates, the first of the
    config's 22 blocks (4,546 SNPs), 1 of its 20 power iterations and 1 of
    its 5 shifted-QR iterations an eigenvalue, and distributed_pca's
    device budget cut with the blocks (pca_device_budget: 6 GiB x 1/22).
    The genotypes come from three
    subpopulations (Balding-Nichols allele frequencies at F_ST = 0.05
    around phase 9's MAFs, each individual's subpopulation drawn
    uniformly) and the phenotype has 5 planted effects and a shift per
    subpopulation; the positions file spaces the SNPs so that LD pruning
    keeps up to 10,000 (all those QC keeps at 1 block), and the cut
    budget puts both PCA diagonal caches on the host-streamed path, as
    the example's 22 blocks put them.  Run 1 is fresh (launch
    counts set to 0 before it and read after
    it, K2 held bit for bit against its plain version right after each
    launch, party 1's spans synchronized on the card, the host chunks
    copied to the card counted); run 2 resumes from the decrypted PCs
    (use_cached_pca) and the QC, basis and key caches.  Checks: the
    filters equal to the QC oracle; each run's decrypted PCs (the data
    parties' Qpc.txt) finite, with each of the top two exact PCs of the
    standardised, pruned, pooled genotypes in their span at |cos| >= 0.99;
    the statistics within 2e-2 (corr > 0.999) of the oracle on [1 |
    covariates | PCs]; run 2 without distributed_pca and within 2e-2 of run
    1; the caches host-streamed; all six kernels launched.  Then K2 is timed
    at its first (PCA) launch and K1, K3, K4, K5 and K6 are held against
    their plain versions at every shape of run 1 that no earlier phase
    checked.  Recorded: each run's command seconds, party 1's PCA spans
    (the encode, the sketch, the moments, the Q scaling, each power
    iteration's qxt, aggregation, bootstrap, qx and QR, the Gram, the
    eigendecomposition, the sort, the subspace), the bytes of host chunks
    copied to the card, peak device memory and host RSS;
13. the logistic study through the port's CLI, in this process as phase 10
    runs its study: config/configGlobalLogistic.toml's flags (PN14QP438, its
    QC thresholds and count route, use_cached_keys, skip_pca, use_logistic
    with the degree-62 sigmoid on [-10, 10] and inverse_mat_scale 10,000),
    per data party 1000 individuals and 5 covariates, the first of the
    config's 22 blocks (4,546 SNPs) and 1 of its 15 Newton epochs, phase
    9's genotype and count generators with a binary phenotype from a
    logistic model over the covariates and 3 planted SNPs.  One fresh run
    (the logistic phase keeps no cache of its own): launch counts set to 0
    before it and read after it, all six kernels launched, K2 4 times a
    block at each data party (g^T W z B^T at 6 rows, g^T W g on the squared
    block, g^T y~ and g^T o at 1 row) and held bit for bit against its
    plain version right after each launch, party 1's spans synchronized on
    the card.  Checks: the filter equal to the QC oracle; the statistics
    finite, within 2e-2 (corr > 0.999) of an exact-sigmoid oracle of the
    same Newton epoch from zero weights (with the score test's numerator
    g^T (y~ - o) as gwy_score_test computes it) and correlated above 0.99
    with the converged (50-epoch) one.  Then K2 is timed at its first launch at
    each row count and K1, K3, K4, K5 and K6 are held against their plain
    versions at every shape no earlier phase checked.  Recorded: the
    command seconds, party 1's protocol line, its spans per Newton epoch
    (lr_epoch: lr_sigmoid, lr_hess_he, lr_inv_ss, lr_step), of the score
    test's preparation (score_prep) and per block (score_block:
    score_encode, score_mm, score_ss), the launch counts, peak device
    memory and host RSS;
14. the skip-PCA study with qr_method = "householder": a third run of
    phase 10's CLI study (run by phase 10 after its resumed run, on the
    same data and config) with use_cached_combined_q = false on run 1's
    key and QC caches, its basis and block-product caches removed first,
    so that the covariate basis is net_dqr_enc's and the block products
    are computed again; launch counts set to 0 before it and read after
    it, K2 held bit for bit against its plain version right after each
    launch, party 1's spans synchronized on the card.  Checks: every
    bundle restored from the key cache, the filter equal to the QC oracle,
    the statistics finite, within 2e-2 (corr > 0.999) of the plaintext
    oracle and within 1e-3 of phase 10's run 1 (cholqr2), all six kernels
    launched, K2 once a block at each data party.  Then K1 and K3-K6 are
    held against their plain versions at every shape no earlier phase
    checked.  Recorded: the command seconds, party 1's protocol line, its
    combined_q and Householder spans, the launch counts, peak device
    memory and host RSS;
15. within-party sharding, two logical shards of the one card
    ([cuda:0, cuda:0]: every step of the sharded branch runs, the copies
    between shards are no-ops), run right after phase 5 on phase 3's
    block: (b) mat_mult_sharded over the two shards on phase 3's cache
    (one block column), and on the block placed twice as two block
    columns (a real split: column bj on slot bj % 2) unsharded, sharded
    and through set_pipeline_devices with a plain mat_mult_cached call,
    every output bit-identical to phase 3's; the two-column product timed
    unsharded and sharded over 3 calls each, the sharded one also stage by
    stage (synchronized spans) and traced (no device value read back),
    with K1 and K3 held at its new shapes; (c) K2 at each shard slot's
    launch against its plain version (the first timed, the other
    compared).  And (d), a fourth run of phase 10's study after phase
    14's: the resumed config with run 1's basis put back, the block
    products computed again with every product routed over the two shards
    (the config with shard_matmult = true, the protocol's local_devices
    giving [cuda:0, cuda:0]; the routing reset after), then its unsharded
    twin (the same caches, phase 3 seeded alike in both).  Checks: the
    filter equal to the QC oracle; the statistics within 2e-2 (corr >
    0.999) of the oracle and bit-equal to the twin's (their distance from
    phase 10's resumed run, which draws its own masks, is recorded); the
    block products' basis rows bit-equal to run 1's; every product
    through the sharded branch, K2 held bit for bit at each launch, K1
    and K3-K6 at every new shape;
16. the SS domain's device mode (ring.host False: the shares on the card,
    the ring's digit arithmetic on K8-K11), run after phase 13: (a) phase
    7's timed sqrt_and_sqrt_inverse (n = 99,337) and (b) phase 13's first
    matrix_inverse_sqrt_svd (the 6 x 6 inverse of the first Newton
    epoch's near-scalar Z^T W Z), each kept by its phase at every party
    (the PRG table it started from, its input and its outputs:
    _FirstCalls) and replayed at three parties (run_parties with the
    phase's MPC parameters) in device mode, every launch count set to 0
    before the replays and read after them, (a)'s device work traced
    (device activity alone).  Checks: every party's outputs bit-equal to
    the phase's host-mode outputs, the data parties' outputs tensors on
    the card, K8-K11 each launched, the launches recorded at the wrappers equal to
    the counts.  Recorded: party 1's seconds in both modes, its host
    profile of each replay (the native engine, the ring kernels'
    wrappers, partitions, reveals, draws, transport waits), the device's
    busy and idle share of (a).  Then (c) K8-K11 against their plain
    versions at every shape the replays launched them with, each timed at
    its shape of the most work (launches times bytes);
17. the static SASS of K4, K5 and K6 (cuobjdump: instructions and opcodes
    per kernel), one JSON line of kernels, then the final line
    {"ok": true, "device": {...}}.

Needs a CUDA card; without one it exits nonzero and prints no result.
Writes the record to chiprun_out/chip_smoke.json, the shapes --tree times
to chiprun_out/shapes.json, the profiler's tables to
chiprun_out/mm_profile.txt, chiprun_out/bs_profile.txt,
chiprun_out/ss_profile.txt, chiprun_out/qr_profile.txt and
chiprun_out/assoc_profile.txt, the SASS listings to
chiprun_out/sass_main_*.txt, party 1's assoc.txt of phase
10's runs to chiprun_out/assoc_fresh.txt and chiprun_out/assoc_resumed.txt
and of phase 11's to chiprun_out/assoc_tcp_{fresh,resumed}.txt and of
phase 12's to chiprun_out/assoc_pca_{fresh,resumed}.txt and of phase 13's
to chiprun_out/assoc_logistic.txt and of phase 14's to
chiprun_out/assoc_householder.txt and of phase 15's routed run to
chiprun_out/assoc_routed.txt, the sharded product's profile to
chiprun_out/shard_profile.txt, and the logs of phase 11's parties to
chiprun_out/tcp_{fresh,resumed}_party*.log.

--pca-probe runs only pca_probe: phase 12's fresh study with collective
decrypts around PCA's steps, up to the eigensolve (the in-vivo bisect of a
PCA that misses its PCs; chiprun_out/pca_probe.txt).

--tree DIR --shapes FILE times only K1 (at one product's shapes), K4 (at
every path's draws), bs_mask (at the MHE and SS phases' row sets) and K6
(at those phases' lifts, on bounded values made from a seed; skipped, and said
so, when the shapes file has no crt_lift entry), from the sfgwas_tpu_torch
package under DIR (for example another commit's tree), at the shapes of a
shapes.json, each against its plain version as above, counts the SASS of
K4, K5 and K6 (chiprun_out/sass_<DIR's name>_*.txt) and prints one JSON
line: two trees are compared by running both, in turns, in one call.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import copy
import inspect
import itertools
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# integer instructions of one Threefry-2x32 word as jax.random.bits draws it:
# 20 rounds of add, rotate and xor, five key injections of two adds (the
# second word's addend, a key word plus the injection's index, is the same
# for every thread of a launch), the two initial key adds and the final xor
# of the two outputs
THREEFRY_OPS = 20 * 3 + 5 * 2 + 2 + 1
BARRETT_OPS = 6  # a 64-bit Barrett reduction: umulhi, multiply, subtract, compare, select
# the kernels of each path: a path that launches one of its kernels no time fails
MM_PATH = ("ntt_fwd", "ntt_inv", "mac_dense", "ks_digit_product", "uniform_mod")
SHARD_PATH = MM_PATH[:4]  # the products of phase 15, on keys already made
MHE_PATH = ("ntt_fwd", "ntt_inv", "uniform_mod", "bs_mask", "bs_combine", "crt_lift")
# each kernel's device function, as torch.profiler names it (a pattern)
DEVICE_NAMES = {
    "ntt_fwd": r"ntt_kernel<\d+, false>", "ntt_inv": r"ntt_kernel<\d+, true>",
    "mac_dense": r"mac_dense_kernel", "ks_digit_product": r"ks_digit_kernel",
    "uniform_mod": r"uniform_mod_kernel", "bs_mask": r"bs_mask_kernel",
    "bs_mask_generic": r"bs_mask_generic_kernel",
    "bs_combine": r"bs_combine_kernel", "crt_lift": r"crt_lift_kernel",
    "ring_reduce": r"ring_reduce_kernel", "ring_mul": r"ring_mul_kernel",
    "ring_combine": r"ring_combine_kernel", "ring_sum": r"ring_sum_kernel",
    "ring_from_i32": r"ring_from_i32_kernel",
    "ring_matmul": r"ring_matmul_kernel", "ring_dot": r"ring_dot_kernel",
}
# integer operations per second: the H100 SXM's INT32 peak, 33.5 TOPS
# (NVIDIA H100 Tensor Core GPU Architecture white paper), a multiply-add
# counted as two operations; half the 67 TFLOP/s float32 rate, since an SM
# has 64 INT32 lanes beside its 128 FP32 lanes.  It is the script's only
# integer peak.
INT_OPS_PER_S = 33.5e12


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


PROFILE_TRIES = 3
PROFILE_PAD_S = 0.002


def _device_ms(torch, fn, reps: int, kernel: str):
    """Device milliseconds per launch of `kernel` over `reps` calls of fn
    after one warm-up: the sum of the durations torch.profiler records for
    the device functions named DEVICE_NAMES[kernel], over their count, with
    that count and the source ("profiler").  On an H100 torch.profiler now
    and then returned a trace of a few short launches (K4 at 7 calls of
    0.04 ms) with no device event at all, three times in a row, so the
    launches are framed by PROFILE_PAD_S of host time on each side, and a
    trace without the kernel's launches is taken again with more calls, up
    to PROFILE_TRIES times in all; after that the time is the CUDA-event
    time of one call of fn, a launch with its host overhead, with count 0
    and source "events"."""
    from torch.profiler import ProfilerActivity, profile

    pat = re.compile(DEVICE_NAMES[kernel])
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(reps * attempt):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        events = prof.profiler.kineto_results.events()  # raw: cheaper than prof.events()
        on_dev = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA]
        durs = [e.end_ns() - e.start_ns() for e in on_dev if pat.search(e.name())]
        if durs:
            return sum(durs) / len(durs) / 1e6, len(durs), "profiler"
        print(f"chip_smoke: torch.profiler traced no launch of {kernel} ({pat.pattern}) in "
              f"try {attempt} of {PROFILE_TRIES}: {reps * attempt} calls, {len(on_dev)} device "
              f"and {len(events) - len(on_dev)} host events", file=sys.stderr, flush=True)
    return _time_ms(torch, fn, reps), 0, "events"


def _bound_ms(nbytes: float, ops: float):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _same(torch, a, b) -> bool:
    return a.shape == b.shape and bool(torch.equal(a, b))


def _profile(torch, fn, path: str, all_threads: bool = False, labels=()) -> dict:
    """One call of fn under torch.profiler: device time by kernel name and
    by port kernel (DEVICE_NAMES), the device's busy share of the traced
    window, and a table by name in `path`; all_threads traces the host
    operations of every thread (party threads); `labels` names
    record_function ranges whose device time (the kernels launched inside
    them) is summed.  Read from the profiler's raw events (trace_summary):
    torch.profiler's own event lists cost a minute and more to build on a
    party run's trace.  Raises when the trace holds no device kernel."""
    from torch.profiler import ProfilerActivity, profile

    kw = {}
    if all_threads:
        from torch._C._profiler import _ExperimentalConfig

        kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **kw) as prof:
        fn()
        torch.cuda.synchronize()
    out = trace_summary(_trace_rows(torch, prof), labels)
    if not out["kernels"]:
        raise AssertionError("torch.profiler traced no device kernel")
    with open(path, "w") as f:
        f.write(out.pop("table"))
    return out


def _trace_rows(torch, prof) -> list:
    """trace_summary's rows of a finished torch.profiler run."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.device_type() == cuda, e.start_thread_id(), e.start_ns(), e.end_ns(),
             e.correlation_id(), e.linked_correlation_id())
            for e in prof.profiler.kineto_results.events()]


# the names torch.profiler's event lists leave out (its _filter_name)
UNLISTED_EVENTS = {
    "[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
    "profiler::_record_function_enter_new", "profiler::_record_function_exit",
    "aten::is_leaf", "aten::output_nr", "aten::_version"}


def trace_summary(rows, labels=()) -> dict:
    """_profile's numbers from a trace's raw events, rows of (name,
    on_device, thread, start_ns, end_ns, correlation_id,
    linked_correlation_id) as torch.profiler's kineto results give them.
    As torch.profiler links them, a device event belongs to the host op
    (linked id 0) whose correlation id is the event's linked one, the
    innermost op that launched it: an op's self device time is that of its
    own kernels, a labelled range's device time that of the kernels of
    every op it holds on its thread, itself included.  A labelled range
    also appears on the device's timeline, spanning its first to its last
    kernel, gaps included: not a kernel.  `table`: calls, host ms and
    device ms (a host op's self device time) by name, by device ms."""
    rows = [r for r in rows if r[0] not in UNLISTED_EVENTS]
    dev = [r for r in rows if r[1] and r[0] not in labels]
    host = [r for r in rows if not r[1]]
    by_name: dict = {}
    for r in dev:
        by_name[r[0]] = by_name.get(r[0], 0) + r[4] - r[3]
    busy = 0
    if dev:
        spans = sorted((r[3], r[4]) for r in dev)
        cur_s, cur_e = spans[0]
        for s, t in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, t
            else:
                cur_e = max(cur_e, t)
        busy += cur_e - cur_s
    window = (max(r[4] for r in rows) - min(r[3] for r in rows)) if rows else 0
    ops = {r[5]: r for r in host if r[6] == 0}  # host ops by correlation id
    own: dict = {}  # device ns of each op's own kernels, by its correlation id
    for r in dev:
        if r[6] in ops:
            own[r[6]] = own.get(r[6], 0) + r[4] - r[3]
    self_dev: dict = {}
    host_ns: dict = {}
    calls: dict = {}
    for r in host:
        host_ns[r[0]] = host_ns.get(r[0], 0) + r[4] - r[3]
        calls[r[0]] = calls.get(r[0], 0) + 1
    for cid, ns in own.items():
        name = ops[cid][0]
        self_dev[name] = self_dev.get(name, 0) + ns
    for r in dev:
        calls[r[0]] = calls.get(r[0], 0) + 1
    labelled = {}
    if labels:
        # per thread: the start of each op with kernels, sorted, and the running
        # sum of their device ns
        per_thread: dict = {}
        for cid, ns in own.items():
            per_thread.setdefault(ops[cid][2], []).append((ops[cid][3], ns))
        index = {}
        for t, lst in per_thread.items():
            lst.sort()
            index[t] = ([s for s, _ in lst], list(itertools.accumulate((n for _, n in lst),
                                                                         initial=0)))
        for label in labels:
            hits = [r for r in host if r[0] == label]
            total = 0
            for h in hits:
                if h[2] in index:
                    starts, cum = index[h[2]]
                    total += (cum[bisect.bisect_right(starts, h[4])]
                              - cum[bisect.bisect_left(starts, h[3])])
            labelled[label] = {"calls": len(hits), "device_ms": total / 1e6}
    aten = sorted(((k, self_dev.get(k, 0) / 1e6) for k in host_ns if k.startswith("aten::")),
                  key=lambda kv: -kv[1])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    port_ms = {sym: sum(v for k, v in by_name.items() if re.search(pat, k)) / 1e6
               for sym, pat in DEVICE_NAMES.items()}
    device = {**self_dev, **by_name}
    table = ["calls  host_ms  device_ms  name (a host op's device_ms: its own kernels)"]
    for name in sorted(calls, key=lambda k: (-device.get(k, 0), -host_ns.get(k, 0)))[:60]:
        table.append(f"{calls[name]:>8} {host_ns.get(name, 0) / 1e6:>12.3f} "
                     f"{device.get(name, 0) / 1e6:>12.3f}  {name}")
    return {
        "port_kernel_ms": port_ms, "labelled_ms": labelled, "aten_self_device_ms": aten[:12],
        "window_ms": window / 1e6, "device_busy_ms": busy / 1e6,
        "device_sum_ms": sum(by_name.values()) / 1e6,
        "idle_share": 1 - busy / window if window else 1.0,
        "kernels": len(dev), "top_ms": [[k[:80], v / 1e6] for k, v in top[:15]],
        "k1_ms": sum(v for k, v in by_name.items() if "ntt_" in k) / 1e6,
        "host_readbacks": calls.get("aten::_local_scalar_dense", 0),
        "dtoh_copies": sum(1 for r in dev if "DtoH" in r[0]),
        "host_threads": len({r[2] for r in host}), "table": "\n".join(table) + "\n",
    }


# False while _collective_kernel_checks holds the shapes it does not time:
# _check then compares the kernel with its plain version and times neither
TIMING = True


def _check(torch, kernels, name, kernel, source, replaces, shape, run, run_plain, reps, preps,
           nbytes, ops, timed=None):
    """Bit equality of run() and run_plain() (lists of tensors), then both
    timed; `timed` = (kernel, plain) callables to time instead.  `ms` is the
    kernel's device time per launch (torch.profiler), `call_ms` the CUDA-event
    time of one wrapper call, `plain_ms` the plain version's.  Appends the
    kernel's record to `kernels` (with TIMING off, a record of the equality
    alone)."""
    got, want = run(), run_plain()
    torch.cuda.synchronize()
    eq = all(_same(torch, a, b) for a, b in zip(got, want))
    err = 0 if eq else max(float((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
    del got, want
    if not TIMING:
        bms, by = _bound_ms(nbytes, ops)
        kernels.append(dict(name=name, kernel=kernel, shape=shape, bit_equal=eq,
                            max_abs_err=err, ms=None, bound_ms=bms, bound_by=by))
        return
    fn, plain = timed or (run, run_plain)
    ms, traced, ms_from = _device_ms(torch, fn, reps, kernel)
    cms = _time_ms(torch, fn, reps)
    pms = _time_ms(torch, plain, preps)
    bms, by = _bound_ms(nbytes, ops)
    kernels.append(dict(
        name=name, kernel=kernel, route="cuda", source=source, replaces=replaces,
        shape=shape, bit_equal=eq, max_abs_err=err, ms=ms, call_ms=cms, plain_ms=pms,
        bound_ms=bms, bound_by=by, library_ms=None, traced_launches=traced, ms_from=ms_from,
    ))
    torch.cuda.empty_cache()


def _k1_rows(torch, cuda_ntt, rns, basis, shapes, dev, kernels, per="launches_per_mat_mult"):
    """K1 against its plain version at each [inverse, rows, shape, launches]
    of `shapes` (launches stored under `per`), on random residues of the
    rows' primes; returns K1's total over those launches, sum of launches x
    ms."""
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
        kernels[-1][per] = per_call
        kernels[-1]["rows"] = list(rows)
        total += per_call * (kernels[-1]["ms"] or 0.0)
        del x
    return total


class _Patches:
    """Attributes of modules or classes replaced by wrappers of their real
    values; restore() puts the real values back, last patch first."""

    def __init__(self):
        self._undo: list = []

    def patch(self, owner, attr: str, make):
        """Set owner.attr to make(real) and return the real value."""
        real = getattr(owner, attr)
        setattr(owner, attr, make(real))
        self._undo.append((owner, attr, real))
        return real

    def restore(self):
        for owner, attr, real in reversed(self._undo):
            setattr(owner, attr, real)
        self._undo.clear()


class _Recorder(_Patches):
    """Wraps kernel wrappers that their callers look up in the module at
    call time: keeps the arguments of the first launch at each key and
    counts launches per key, under a lock (the parties launch from their
    threads).  restore() puts the real wrappers back."""

    def __init__(self):
        super().__init__()
        self.args: dict = {}
        self.counts: collections.Counter = collections.Counter()
        self.real: dict = {}
        self._lock = threading.Lock()

    def wrap(self, module, attr: str, name: str, key_of, keep_args: bool = True):
        def make(real):
            def wrapped(*a):
                k = key_of(*a)
                with self._lock:
                    if keep_args:
                        self.args[name].setdefault(k, a)
                    self.counts[(name, k)] += 1
                return real(*a)

            return wrapped

        self.args[name] = {}
        self.real[name] = self.patch(module, attr, make)

    def k1_shapes(self) -> list:
        """[inverse, rows, shape, launches] of every K1 key recorded."""
        return sorted([k[0], list(k[1]), list(k[2]), n]
                      for (name, k), n in self.counts.items() if name == "k1")


def _k1_key(x, basis, rows, inverse=False):
    return bool(inverse), tuple(rows), tuple(x.shape)


def _k3_check(torch, C, kernels, name, replaces, ext, k0, k1, q, mu, logn, launch, reps, preps):
    """K3 (`launch`) against its plain version on ext [G, S, J, X, N] and
    keys [G, Bk, J, X, N]."""
    G, S, J, X, N = ext.shape
    Bk = k0.shape[1]
    nbytes = 4 * N * (G * S * J * X + 2 * G * Bk * J * X + 2 * G * S * Bk * X)
    macs = 2 * G * S * Bk * J * X * N
    _check(torch, kernels, name, "ks_digit_product", "sfgwas_tpu_torch/csrc/ks_digit.cu",
           replaces, [G, S, Bk, J, X, N], lambda: list(launch(ext, k0, k1, q, mu, logn)),
           lambda: list(C.ks_digit_product_plain(ext, k0, k1, q)), reps, preps, nbytes, 2 * macs)


# The port's callers of K3, innermost first where one calls another, each
# with the keyswitch of the reference it stands for and the line of that
# keyswitch's digit contraction in sfgwas_tpu/crypto/ckks.py.
K3_SITES = {
    "_keyswitch_decomposed_arr": ("keyswitch", 820),
    "keyswitch_decomposed_b": ("keyswitch, a key each", 875),
    "_relin_b": ("relinearisation", 628),
    "hoisted_rotations_all": ("hoisted", 993),
    "rotate_grouped_b": ("grouped rotations", 1050),
}


def _k3_site() -> str:
    """The caller of the K3 launch being recorded: the first K3_SITES name
    on the stack, in the table's order."""
    names, f = set(), sys._getframe(1)
    while f is not None and len(names) < 16:
        names.add(f.f_code.co_name)
        f = f.f_back
    for site in K3_SITES:
        if site in names:
            return site
    raise AssertionError(f"K3 launched from no known site: {sorted(names)}")


def _k2_check(torch, MM, kernels, name, launch, R0, R1, polys, runs, q, mu, logn, nacc: int,
              replaces="sfgwas_tpu/gwas/matmult.py:504"):
    """K2 (`launch`) against its plain version on one block row's baby
    rotations R0, R1 [nb, s, nmod, N], its diagonal polys and runs, into
    zeroed accumulators of nacc rows (timed in place, as the product runs
    it)."""
    nb, s, nmod, N = R0.shape
    dev = R0.device
    zeros = lambda: torch.zeros((nacc, s, nmod, N), dtype=torch.int32, device=dev)  # noqa: E731
    tacc0, tacc1 = zeros(), zeros()
    E = int(runs.run_start_host[-1])
    nbytes = 4 * (2 * nb * s * nmod * N  # R0, R1: the row's babies
                  + polys.shape[0] * nmod * N  # the diagonal polys
                  + 2 * 2 * runs.nruns * s * nmod * N)  # ACC rows read and written
    macs = 2 * E * s * nmod * N
    _check(
        torch, kernels, name, "mac_dense", "sfgwas_tpu_torch/csrc/mac_dense.cu", replaces,
        [runs.nruns, E, nb, s, nmod, N],
        lambda: launch(zeros(), zeros(), R0, R1, polys, runs, q, mu, logn),
        lambda: MM.mac_dense_plain(zeros(), zeros(), R0, R1, polys, runs, q),
        5, 1, nbytes, 2 * macs,
        timed=(lambda: launch(tacc0, tacc1, R0, R1, polys, runs, q, mu, logn),
               lambda: MM.mac_dense_plain(tacc0, tacc1, R0, R1, polys, runs, q)),
    )


def _k4_check(torch, C, kernels, q, mu, sd, idx, b, logn, launch):
    """K4 against its plain version on one draw's arguments; `launch` is the
    wrapper to time."""
    L, N = q.shape[0], 1 << logn
    n_out = b * L * N
    _check(torch, kernels, f"uniform_mod {[b, L, N]}", "uniform_mod",
           "sfgwas_tpu_torch/csrc/crp.cu", "sfgwas_tpu/crypto/ckks.py:1251", [b, L, N],
           lambda: [launch(q, mu, sd, idx, b, logn)],
           lambda: [C.uniform_mod_plain(q, sd, idx, b, N)],
           max(5, min(100, int(2e8 // (4 * n_out)))), 1,
           4 * n_out, n_out * (2 * THREEFRY_OPS + BARRETT_OPS))


def _k4_rows(torch, C, rec, basis, kernels, found=None) -> list:
    """K4 against its plain version at every (batch, rows) that `rec`
    recorded (or at those of `found`, a part of them), on the recorded
    arguments, each with its launches; returns the [batch, rows] of each."""
    shapes = []
    found = rec.args["uniform_mod"] if found is None else found
    for key, (q, mu, sd, idx, b, logn) in sorted(found.items()):
        _k4_check(torch, C, kernels, q, mu, sd, idx, b, logn, rec.real["uniform_mod"])
        kernels[-1]["launches_at_shape"] = rec.counts[("uniform_mod", key)]
        shapes.append([b, [basis.primes.index(int(v)) for v in q.view(-1).tolist()]])
    return shapes


def _bs_mask_call(PM, tl, tf, sd, idx, b, nwords, top, logn):
    """The tree's bs_mask on the tables tl, tf of _bs_tables (a tree from
    before the 32-bit fold takes the tables' entries one by one)."""
    if "tl" in inspect.signature(PM.bs_mask).parameters:
        return PM.bs_mask(tl, tf, sd, idx, b, nwords, top, logn)
    return PM.bs_mask(tl["pw"], tf["pw"], tl["q"], tf["q"], tl["mu"], tf["mu"], sd, idx, b,
                      nwords, top, logn)


def _bs_mask_variant(PM, tl, tf, nwords, logn) -> str:
    """The kernel the tree's bs_mask takes for these tables (a tree from
    before the variants split took the register kernel for 1-4 words on
    primes in (2^24, 2^28))."""
    if hasattr(PM, "bs_mask_variant"):
        return PM.bs_mask_variant(tl, tf, nwords, logn)
    return "register" if tl["fast"] and tf["fast"] and nwords <= 4 and logn >= 2 else "generic"


def _bs_mask_check(torch, PM, kernels, tl, tf, sd, idx, b, nwords, top, logn, launch):
    """bs_mask against its plain version; `launch` is the wrapper to time.
    The record names the kernel's variant (its device function: bs_mask
    for the register kernel, bs_mask_generic for the generic one)."""
    L, Lf, N = tl["q"].shape[0], tf["q"].shape[0], 1 << logn
    cols = b * N
    nbytes = 4 * (L + Lf) * cols
    variant = _bs_mask_variant(PM, tl, tf, nwords, logn)
    sym = "bs_mask" if variant == "register" else "bs_mask_generic"
    _check(torch, kernels, f"{sym} {[nwords, b, L, Lf, N]}", sym,
           "sfgwas_tpu_torch/csrc/bs_share.cu", "sfgwas_tpu/mpc/mhe.py:601",
           [nwords, b, L, Lf, N], lambda: list(launch(tl, tf, sd, idx, b, nwords, top, logn)),
           lambda: list(PM.bs_mask_plain(tl["pw"], tf["pw"], tl["q"], tf["q"], sd, idx, b,
                                         nwords, top, N)),
           max(5, min(100, int(2e8 // (nbytes + 1)))), 1, nbytes,
           cols * (nwords * (THREEFRY_OPS + 2) + (L + Lf) * (2 * nwords + BARRETT_OPS)))
    kernels[-1]["variant"] = variant
    if variant == "register" and hasattr(PM, "bs_mask_split"):
        kernels[-1]["split"] = PM.bs_mask_split(b, logn)


# K5's mask launches on each path, by word count: {path: {nwords: {"launches":
# n, "variants": the kernels that took them}}}
K5_BY_PATH: dict = {}


def _k5_by_nwords(PM, rec, path: str) -> None:
    """The bs_mask launches `rec` counted on a path, by word count, each with
    the variants that took them, into K5_BY_PATH."""
    out: dict = {}
    for (name, key), n in sorted(rec.counts.items()):
        if name != "bs_mask":
            continue
        tl, tf, _, _, _, nwords, _, logn = rec.args["bs_mask"][key]
        e = out.setdefault(str(nwords), {"launches": 0, "variants": []})
        e["launches"] += n
        v = _bs_mask_variant(PM, tl, tf, nwords, logn)
        if v not in e["variants"]:
            e["variants"].append(v)
    K5_BY_PATH[path] = dict(sorted(out.items(), key=lambda kv: int(kv[0])))
    _say(f"{path}: bs_mask launches by word count {json.dumps(K5_BY_PATH[path])}")


def _bs_mask_generic_off_path(torch, PM, rec, launches, path: str) -> dict:
    """The generic kernel, which no path of this preset launches (every
    mask here has at most BS_REG_WORDS words on primes within the lazy
    bound), held to its plain version and timed at the path's widest
    recorded mask, on its tables marked past the lazy bound (as a table of
    larger primes would be): off the path, with the path's count of its
    launches."""
    key = max(rec.args["bs_mask"], key=lambda k: (k[3], k[0]))
    tl, tf, sd, idx, b, nwords, top, logn = rec.args["bs_mask"][key]
    past = {"lazy": False}
    out: list = []
    _bs_mask_check(torch, PM, out, {**tl, **past}, {**tf, **past}, sd, idx, b, nwords, top, logn,
                   rec.real["bs_mask"])
    if out[-1]["variant"] != "generic":
        raise AssertionError(f"bs_mask took the {out[-1]['variant']} kernel past the lazy bound")
    out[-1].update(launches=launches["bs_mask_generic"], path=path, on_path=False)
    if not out[-1]["bit_equal"]:
        raise AssertionError(f"kernels differ from their plain versions: {out[-1]['name']}")
    _say(f"{path}: off the path {json.dumps(out[-1])}")
    return out[-1]


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def _sass(cuda_build, names, out_dir: str, tag: str) -> dict:
    """Static SASS of the current build of each named source (cuobjdump
    -sass): per kernel its instruction count and the count of each opcode
    (modifiers dropped, NOP padding left out); the listing goes to
    out_dir/sass_<tag>_<name>.txt."""
    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    out: dict = {}
    os.makedirs(out_dir, exist_ok=True)
    for name in names:
        text = subprocess.run([tool, "-sass", str(cuda_build._target(name))], capture_output=True,
                              text=True, timeout=300, check=True).stdout
        with open(os.path.join(out_dir, f"sass_{tag}_{name}.txt"), "w") as f:
            f.write(text)
        fn = None
        for line in text.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                fn = m.group(1)
                out[fn] = {"instructions": 0, "ops": collections.Counter()}
                continue
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if m and fn and m.group(1) != "NOP":
                out[fn]["instructions"] += 1
                out[fn]["ops"][m.group(1)] += 1
    return out


def _crt_input(torch, basis, src, M: int, seed: int, dev):
    """x [l, M]: the residues over the src primes of M centred values |v| <
    Q/8, Q the product of those primes, as the bootstrap bounds its masked
    decryption (K6's float step is exact below Q/4)."""
    qs = [int(basis.primes[r]) for r in src]
    Q = 1
    for q in qs:
        Q *= q
    rng = np.random.default_rng(seed)
    v = [int(a) * Q // (8 << 62) for a in rng.integers(-(1 << 62), 1 << 62, size=M)]
    x = np.array([[vv % q for vv in v] for q in qs], np.uint32)
    return torch.from_numpy(x.view(np.int32)).to(dev)


def _crt_check(torch, rns, kernels, x, t, run):
    """K6 (`run`) against its plain version on x with the tables t."""
    l, M = x.shape
    D = t["p"].shape[0]
    nbytes = 4 * M * (l + D)
    _check(torch, kernels, f"crt_lift {[l, D, M]}", "crt_lift",
           "sfgwas_tpu_torch/csrc/crt_lift.cu", "sfgwas_tpu/ops/rns.py:540", [l, D, M],
           lambda: [run(x, t)], lambda: [rns.crt_lift_plain(x, t)],
           max(5, min(100, int(2e8 // (nbytes + 1)))), 1,
           nbytes, M * (l * (3 + BARRETT_OPS) + D * (2 * l + 2 + BARRETT_OPS)))


def tree_only(torch, root: str, shapes_path: str) -> int:
    """Time K1, K4, bs_mask and K6 of the package under `root` at the shapes
    of a shapes.json, each against its plain version, and count the SASS of
    K4, K5 and K6; prints one JSON line.  K6 is timed at each recorded
    (src, dst, M), at src -> dst[:1] (the fixed cost beside the per-row
    slope) and, where the tree has crt_lift_group, at every rows-a-block
    count its rule gives for a cap of 1..CRT_LIFT_MAX_GROUP."""
    sys.path.insert(0, os.path.abspath(root))
    from sfgwas_tpu_torch.crypto import ckks as C
    from sfgwas_tpu_torch.crypto.params import get_params
    from sfgwas_tpu_torch.mpc import mhe as PM
    from sfgwas_tpu_torch.ops import cuda_build, cuda_ntt, rns

    smi = _smi()
    _say(smi)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cuda_build.build(["ntt", "crp", "bs_share", "crt_lift"])
    with open(shapes_path) as f:
        shapes = json.load(f)
    params = get_params(shapes["preset"])
    kernels: list = []
    total = _k1_rows(torch, cuda_ntt, rns, params.basis, shapes["k1"], dev, kernels)
    ctx = C.CkksContext(params, device=dev)
    for i, (b, rows) in enumerate(shapes["uniform_mod"]):
        rows = tuple(rows)
        _k4_check(torch, C, kernels, ctx._t(rows)["q"], rns.barrett_mu64(params.basis, rows, dev),
                  (i + 1, 2), i, b, params.logn, C.uniform_mod)
    for i, (b, rows, tgt, nwords, top) in enumerate(shapes["bs_mask"]):
        tl, tf = PM._bs_tables(ctx, tuple(rows), nwords), PM._bs_tables(ctx, tuple(tgt), nwords)
        _bs_mask_check(torch, PM, kernels, tl, tf, (i + 3, 4), i, b, nwords, top, params.logn,
                       lambda *a: _bs_mask_call(PM, *a))
    crt = shapes.get("crt_lift")
    if crt:
        grouped = hasattr(rns, "crt_lift_group")
        src0, dst0, M0 = crt[0]  # first with its first destination row alone: the fixed cost
        for i, (src, dst, M) in enumerate([[src0, dst0[:1], M0]] + crt):
            x = _crt_input(torch, params.basis, src, M, i, dev)
            t = rns._crt_tables(params.basis, tuple(src), tuple(dst), dev)
            _crt_check(torch, rns, kernels, x, t, rns.crt_lift)
            if not grouped:
                continue
            default, seen = rns.CRT_LIFT_GROUP, set()
            try:  # every rows-a-block count the wrapper's rule gives for a cap of 1..8
                for cap in range(1, rns.CRT_LIFT_MAX_GROUP + 1):
                    rns.CRT_LIFT_GROUP = cap
                    g = rns.crt_lift_group(len(dst))
                    if g not in seen:
                        seen.add(g)
                        _crt_check(torch, rns, kernels, x, t, rns.crt_lift)
                        kernels[-1].update(name=kernels[-1]["name"] + f" G={g}", group=g)
            finally:
                rns.CRT_LIFT_GROUP = default
            del x
    tag = os.path.basename(os.path.abspath(root))
    sass = _sass(cuda_build, ("crp", "bs_share", "crt_lift"),
                 os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out"), tag)
    bad = [k["name"] for k in kernels if not k["bit_equal"]]
    _say(json.dumps({"tree": os.path.abspath(root), "card": smi, "k1_total_ms": total,
                     "crt_lift": "timed" if crt else "skipped: the shapes file has no crt_lift "
                     "entry", "sass": sass, "kernels": kernels}))
    if bad:
        raise AssertionError(f"kernels differ from their plain versions: {bad}")
    return 0


def _collective_recorder(k3: bool = False) -> "_Recorder":
    """A recorder at the wrappers of the kernels the collective protocols
    launch: K1, K4, K5 (bs_mask, bs_combine) and K6, and K3 where asked."""
    from sfgwas_tpu_torch.crypto import ckks as C
    from sfgwas_tpu_torch.mpc import mhe as PM
    from sfgwas_tpu_torch.ops import cuda_ntt, rns

    rec = _Recorder()
    # K1 is checked on random residues of the recorded rows' primes
    rec.wrap(cuda_ntt, "ntt_b_kernel", "k1", _k1_key, keep_args=False)
    if k3:
        rec.wrap(C, "ks_digit_product", "ks_digit_product",
                 lambda ext, k0, k1, q, mu, logn: (_k3_site(),) + tuple(ext.shape)
                 + (k0.shape[1],))
    rec.wrap(C, "uniform_mod", "uniform_mod", lambda q, mu, sd, idx, b, logn: (b, q.shape[0]))
    rec.wrap(PM, "bs_mask", "bs_mask",
             lambda tl, tf, sd, idx, b, nwords, top, logn: (b, tl["q"].shape[0],
                                                            tf["q"].shape[0], nwords))
    rec.wrap(PM, "bs_combine", "bs_combine", lambda *a: tuple(a[0].shape) + (a[1].shape[1],))
    rec.wrap(rns, "crt_lift", "crt_lift", lambda x, t: (tuple(x.shape), t["p"].shape[0]))
    return rec


# (kernel, key) of every shape _collective_kernel_checks has held, so that a
# later phase can check only the shapes no earlier phase checked
CHECKED: set = set()


def _k1_shape_key(shape) -> tuple:
    inverse, rows, dims = shape[:3]
    return "k1", (bool(inverse), tuple(rows), tuple(dims))


def _collective_kernel_checks(torch, rec, launches, params, kernels, path: str,
                              new_only: bool = False, timed_per_kernel=None):
    """K1 (at every recorded direction, rows and shape, on random residues
    of the rows' primes), K4, K5 and K6 (on the recorded inputs) against
    their plain versions, each record tagged with `path` and its launches
    there; with new_only, only at the shapes no earlier call checked.  With
    timed_per_kernel = n, each kernel is timed at its n shapes of the most
    work (launches times elements) and only compared with its plain version
    at the others, which leave their counts in `equal_only` instead of a
    record.  Returns (K1's shapes, K1's total ms over the shapes timed, the
    shapes --tree times, equal_only)."""
    global TIMING
    from sfgwas_tpu_torch.mpc import mhe as PM

    counts = rec.counts
    _k5_by_nwords(PM, rec, path)
    # K1 at every recorded (direction, rows, shape)
    k1_shapes = rec.k1_shapes()
    del rec.args["k1"]  # K1 is checked on random residues of the rows' primes
    for sym, inv in (("ntt_fwd", False), ("ntt_inv", True)):
        if sum(n for i, _, _, n in k1_shapes if i == inv) != launches[sym]:
            raise AssertionError(f"K1 shapes recorded {k1_shapes} miss launches of {sym}")
    todo = [s for s in k1_shapes if not (new_only and _k1_shape_key(s) in CHECKED)]
    CHECKED.update(_k1_shape_key(s) for s in k1_shapes)
    for name, found in rec.args.items():
        for key in list(found):
            if new_only and (name, key) in CHECKED:
                del found[key]
            CHECKED.add((name, key))
    if timed_per_kernel is None:
        k1_total, tree_shapes = _kernel_rows(torch, rec, todo, rec.args, launches, params,
                                             kernels, path)
        return k1_shapes, k1_total, tree_shapes, {}

    def top(items, work):
        return sorted(items, key=work, reverse=True)[:timed_per_kernel]

    k1_top = {tuple(map(str, s)) for inv in (False, True) for s in
              top([s for s in todo if s[0] == inv], lambda s: s[3] * int(np.prod(s[2])))}
    sizes = {"ks_digit_product": lambda a: a[0].numel(), "uniform_mod": lambda a: a[4],
             "bs_mask": lambda a: a[4], "bs_combine": lambda a: a[0].numel(),
             "crt_lift": lambda a: a[0].numel()}
    heavy, light = {}, {}
    for name, found in rec.args.items():
        keep = set(top(found, lambda k: counts[(name, k)] * sizes[name](found[k])))
        heavy[name] = {k: v for k, v in found.items() if k in keep}
        light[name] = {k: v for k, v in found.items() if k not in keep}
    k1_total, tree_shapes = _kernel_rows(
        torch, rec, [s for s in todo if tuple(map(str, s)) in k1_top], heavy, launches, params,
        kernels, path)
    compared: list = []
    TIMING = False
    try:
        _kernel_rows(torch, rec, [s for s in todo if tuple(map(str, s)) not in k1_top], light,
                     launches, params, compared, path)
    finally:
        TIMING = True
    return k1_shapes, k1_total, tree_shapes, _equal_only(compared, path)


def _equal_only(compared: list, path: str) -> dict:
    """The records of the shapes compared without timing, counted by
    kernel (shapes, bit-equal shapes, launches at them); raises unless
    every one is bit-equal."""
    bad = [k["name"] for k in compared if not k["bit_equal"]]
    if bad:
        raise AssertionError(f"kernels differ from their plain versions on the {path} path: "
                             f"{bad}")
    equal_only = {}
    for k in compared:
        e = equal_only.setdefault(k["kernel"], {"shapes": 0, "bit_equal": 0,
                                                "launches_at_shapes": 0})
        e["shapes"] += 1
        e["bit_equal"] += k["bit_equal"]
        e["launches_at_shapes"] += k.get("launches_at_shape", 0)
    _say(f"{path}: compared without timing {json.dumps(equal_only)}")
    return equal_only


def _kernel_rows(torch, rec, todo, args, launches, params, kernels, path: str):
    """The checks of _collective_kernel_checks at K1's shapes `todo` and at
    the other kernels' recorded inputs `args` ({kernel: {key: arguments}}).
    Returns (K1's total ms, the shapes --tree times)."""
    from sfgwas_tpu_torch.crypto import ckks as C
    from sfgwas_tpu_torch.mpc import mhe as PM
    from sfgwas_tpu_torch.ops import cuda_ntt, rns

    real, counts = rec.real, rec.counts
    first = len(kernels)
    k1_total = _k1_rows(torch, cuda_ntt, rns, params.basis, todo, torch.device("cuda", 0),
                        kernels, per="launches_at_shape")
    for k in kernels[first:]:
        k["launches"], k["path"] = launches[k["kernel"]], path
    _say(f"K1 over the {path} path: {k1_total:.4f} ms (sum of launches x ms) at "
         f"{len(todo)} shapes")

    # K4, K5 and K6 at every recorded shape
    N = params.n
    first = len(kernels)
    k4_shapes = _k4_rows(torch, C, rec, params.basis, kernels, args["uniform_mod"])
    for k in kernels[first:]:
        k["launches"], k["path"] = launches["uniform_mod"], path
    for key, (ext, k0, k1, q, mu, logn) in sorted(args.get("ks_digit_product", {}).items()):
        site, line = K3_SITES[key[0]]
        _k3_check(torch, C, kernels, f"ks_digit_product ({site})",
                  f"sfgwas_tpu/crypto/ckks.py:{line}", ext, k0, k1, q, mu, logn,
                  real["ks_digit_product"], 10, 1)
        kernels[-1].update(launches=launches["ks_digit_product"], path=path,
                           launches_at_shape=counts[("ks_digit_product", key)])
    bs_shapes = []
    for key, a in sorted(args["bs_mask"].items()):
        tl, tf, sd, idx, b, nwords, top, logn = a
        _bs_mask_check(torch, PM, kernels, tl, tf, sd, idx, b, nwords, top, logn,
                       real["bs_mask"])
        kernels[-1].update(launches=launches[kernels[-1]["kernel"]], path=path,
                           launches_at_shape=counts[("bs_mask", key)])
        bs_shapes.append([b, tl["rows"].tolist(), tf["rows"].tolist(), nwords, top])
    for key, a in sorted(args["bs_combine"].items()):
        b, L, _, Lf = key
        nbytes = 4 * N * (4 * b * (L + Lf) + L + Lf)  # 3 inputs + 1 output per residue, sk rows
        _check(torch, kernels, f"bs_combine {[b, L, Lf, N]}", "bs_combine",
               "sfgwas_tpu_torch/csrc/bs_share.cu", "sfgwas_tpu/mpc/mhe.py:636", [b, L, Lf, N],
               lambda: list(real["bs_combine"](*a)), lambda: list(PM.bs_combine_plain(*a[:11])),
               max(5, min(100, int(2e8 // (nbytes + 1)))), 1, nbytes,
               b * N * (L * (4 + BARRETT_OPS) + Lf * (6 + 2 * BARRETT_OPS)))
        kernels[-1].update(launches=launches["bs_combine"], path=path,
                           launches_at_shape=counts[("bs_combine", key)])
    crt_shapes = []
    for key, (x, t) in sorted(args["crt_lift"].items()):
        _crt_check(torch, rns, kernels, x, t, real["crt_lift"])
        kernels[-1].update(launches=launches["crt_lift"], path=path,
                           launches_at_shape=counts[("crt_lift", key)])
        crt_shapes.append([[params.basis.primes.index(int(v)) for v in t[r].tolist()]
                           for r in ("q", "p")] + [x.shape[1]])
    return k1_total, {"uniform_mod": k4_shapes, "bs_mask": bs_shapes, "crt_lift": crt_shapes}


def mhe_phase(torch, seed: int, out_dir: str, kernels: list) -> dict:
    """Phase 6: the 3-party collective keygen, bootstrap and decrypt at
    PN14QP438 on the card, then K1, K4, K5 and K6 against their plain
    versions at every shape the phase launched them with.  Appends the
    kernels' records to `kernels` and returns the phase's record."""
    from sfgwas_tpu_torch.crypto import basics as B
    from sfgwas_tpu_torch.crypto.params import get_params
    from sfgwas_tpu_torch.mpc import mhe as PM
    from sfgwas_tpu_torch.ops import cuda_build
    from sfgwas_tpu_torch.parallel.simulate import run_network_parties
    from sfgwas_tpu_torch.utils import prof

    preset, nvec, low_nmod, reps = "PN14QP438", 8, 3, 3
    params = get_params(preset)
    band = params.mm_nmod
    two_n = 2 * params.n
    n_keys = len({pow(5, k, two_n) for k in PM.generate_rot_shifts(params.slots)} | {two_n - 1})
    rng = np.random.default_rng(seed + 1)
    data = {p: rng.normal(size=(nvec, params.slots)) for p in (1, 2)}
    want = data[1] + data[2]

    # the inputs of the first launch of every kernel at each shape, and the
    # launches per shape, recorded at the wrappers; launches made for the
    # comparisons below are not counted in the phase's counts, which are
    # read before them
    rec = _collective_recorder()

    keygen_done = threading.Barrier(3)
    data_sync = threading.Barrier(2)
    profiled: dict = {}

    def party(net):
        pid = net.pid
        cps = PM.collective_init(net, preset)
        torch.cuda.synchronize()
        setup = prof.totals()
        keygen_done.wait(timeout=600)
        if pid == 1:  # the spans synchronize: off for the timed runs
            prof.ENABLED, prof.SYNC = False, None
        keygen_done.wait(timeout=600)
        if pid == 0:
            return {"setup": setup, "rot_keys": len(cps.rot_keys)}
        ctx = cps.ctx
        cts = [B.encrypt_float_vector(cps, data[pid][i])[0] for i in range(nvec)]
        low = [ctx.drop_to(ct, low_nmod) for ct in PM.aggregate_cvec(net, cps, cts)]

        def timed(fn):
            fn()  # warm-up
            torch.cuda.synchronize()
            t0 = time.time()
            for _ in range(reps):
                out = fn()
            torch.cuda.synchronize()
            return out, (time.time() - t0) / reps * 1e3

        res_band, ms_band = timed(lambda: PM.collective_bootstrap_many(net, cps, low, -1, band))
        res_top, ms_top = timed(lambda: PM.collective_bootstrap_many(net, cps, low, -1))
        pts, ms_dec = timed(lambda: PM.collective_decrypt_many(net, cps, res_band, -1))
        pts = pts + PM.collective_decrypt_many(net, cps, res_top, -1)
        got = np.stack([ctx.decode(pt) for pt in pts])
        errs = [float(np.abs(got[:nvec] - want).max()), float(np.abs(got[nvec:] - want).max())]
        # one band bootstrap traced over all threads
        data_sync.wait(timeout=600)
        if pid == 1:
            box = {}

            def traced():
                data_sync.wait(timeout=600)
                box["out"] = PM.collective_bootstrap_many(net, cps, low, -1, band)
                data_sync.wait(timeout=600)

            profiled.update(_profile(torch, traced, os.path.join(out_dir, "bs_profile.txt"),
                                     all_threads=True))
        else:
            data_sync.wait(timeout=600)
            PM.collective_bootstrap_many(net, cps, low, -1, band)
            data_sync.wait(timeout=600)
        return {
            "setup": setup, "rot_keys": len(cps.rot_keys), "decode_err": errs,
            "levels": [res_band[0].nmod, res_top[0].nmod],
            "scales_exact": all(ct.scale == params.scale for ct in res_band),
            "ms_bootstrap_band": ms_band, "ms_bootstrap_top": ms_top, "ms_decrypt": ms_dec,
        }

    cuda_build.reset_launch_counts()
    prof.reset()
    prof.ENABLED, prof.SYNC = True, torch.cuda.synchronize
    t0 = time.time()
    try:
        res = run_network_parties(3, party, timeout=900)
    finally:
        prof.ENABLED, prof.SYNC = False, None
        rec.restore()
    torch.cuda.synchronize()
    t_phase = time.time() - t0
    launches = {k: v.launches for k, v in cuda_build.REGISTRY.items()}
    hub = res[1]
    setup_s = {k: hub["setup"][k][0] for k in ("ckg", "rkg", "rtg")}
    _say(f"mhe set-up (party 1, s): public key {setup_s['ckg']:.3f}, relinearisation key "
         f"{setup_s['rkg']:.3f}, rotation keys ({hub['rot_keys']}) {setup_s['rtg']:.3f}; "
         f"whole phase {t_phase:.1f} s")
    for pid in (1, 2):
        r = res[pid]
        _say(f"mhe party {pid}: bootstrap of {nvec} to nmod {r['levels'][0]} (scale reset) "
             f"{r['ms_bootstrap_band']:.3f} ms, to nmod {r['levels'][1]} "
             f"{r['ms_bootstrap_top']:.3f} ms, decrypt of {nvec} {r['ms_decrypt']:.3f} ms; "
             f"decode vs numpy sum max abs err {r['decode_err']}")
        bad = max(r["decode_err"])
        if not np.isfinite(bad) or bad >= 1e-3:
            raise AssertionError(f"party {pid}: collective decode off by {r['decode_err']}")
        if r["levels"] != [band, params.nq] or not r["scales_exact"]:
            raise AssertionError(f"party {pid}: refreshed to {r['levels']}, exact scale "
                                 f"{r['scales_exact']}")
        if r["rot_keys"] != n_keys:
            raise AssertionError(f"party {pid}: {r['rot_keys']} rotation keys")
    _say(f"launches: mhe path {json.dumps(launches)}")
    missing = [k for k in MHE_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the mhe path: {missing}")
    _say(f"profile of one bootstrap of {nvec}: {json.dumps(profiled)}")
    if profiled["host_threads"] < 2:
        raise AssertionError("the bootstrap's profile traced one thread: party 2's host "
                             "operations are missing")
    if profiled["host_readbacks"]:
        raise AssertionError(f"the bootstrap read {profiled['host_readbacks']} device values "
                             "back to the host")

    k1_shapes, k1_total, tree_shapes, _ = _collective_kernel_checks(
        torch, rec, launches, params, kernels, "mhe")
    return {
        "preset": preset, "parties": 3, "vectors": nvec, "low_nmod": low_nmod,
        "setup_s": setup_s, "rotation_keys": hub["rot_keys"], "phase_s": t_phase,
        "parties_out": {str(p): {k: v for k, v in res[p].items() if k != "setup"} for p in (1, 2)},
        "launches": launches, "profile": profiled, "k1_total_ms": k1_total,
        "shapes": {name: [list(k) for k in r] for name, r in rec.args.items()},
        "k1_shapes": k1_shapes, "tree_shapes": tree_shapes,
    }


# ---------------------------------------------------------------------------
# 7. the secret-sharing domain and the SS<->HE bridge


class _HostTimer(_Patches):
    """A host profile of one thread: wall seconds spent inside wrapped
    callables, by category, counted for calls made by `thread` alone (the
    other party threads run the same code at the same time) and for the
    outermost call of a category (a nested call of the same category is not
    counted twice).  cProfile cannot do this: on Python 3.12 it sees the
    calls of every thread at once."""

    def __init__(self, thread: int):
        super().__init__()
        self.thread = thread
        self.secs: collections.Counter = collections.Counter()
        self.calls: collections.Counter = collections.Counter()
        self._depth: collections.Counter = collections.Counter()

    def timed(self, fn, cat: str):
        def call(*a, **k):
            if threading.get_ident() != self.thread or self._depth[cat]:
                return fn(*a, **k)
            self._depth[cat] += 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.secs[cat] += time.perf_counter() - t0
                self.calls[cat] += 1
                self._depth[cat] -= 1

        return call

    def wrap(self, owner, attr: str, cat: str):
        self.patch(owner, attr, lambda real: self.timed(real, cat))


class _TimedEngine:
    """Stands in for the native ring engine: each entry point is timed by a
    _HostTimer under "native_engine"."""

    def __init__(self, lib, timer: _HostTimer):
        self._lib, self._timer = lib, timer

    def __getattr__(self, name):
        return self._timer.timed(getattr(self._lib, name), "native_engine")


def _sqrt_host_profile(fn):
    """fn() under a host profile of the calling thread: the seconds in the
    native engine, in the ring kernels' wrappers (device mode: the host's
    side of their launches), in Beaver partitions, in reveals, in the ring
    draws and waiting in the transport's receive, and each as a share of
    fn's wall time (the categories overlap: a partition's time holds its
    draws, its reveal and its waits).  Returns (fn's result, the profile)."""
    from sfgwas_tpu_torch.mpc.mpc import MPC
    from sfgwas_tpu_torch.ops import cuda_ring, native_ring
    from sfgwas_tpu_torch.ops import ring as R
    from sfgwas_tpu_torch.parallel.transport import LocalTransport

    timer = _HostTimer(threading.get_ident())
    for owner, attr, cat in (
        *((cuda_ring, attr, "ring_kernel_calls") for attr in RING_KERNELS),
        (MPC, "reveal_sym", "reveals"),
        (MPC, "beaver_partition", "beaver_partitions"),
        (MPC, "beaver_partition_many", "beaver_partitions"),
        (R.Ring, "rand", "ring_rand"), (R.Ring, "rand_bits", "ring_rand"),
        (R.SmallField, "rand", "ring_rand"), (R.GF2Ring, "rand", "ring_rand"),
        (LocalTransport, "recv_obj", "transport_waits"),
    ):
        timer.wrap(owner, attr, cat)
    engine = native_ring.lib()
    native_ring._LIB = _TimedEngine(engine, timer)
    t0 = time.perf_counter()
    try:
        out = fn()
    finally:
        wall = time.perf_counter() - t0
        native_ring._LIB = engine
        timer.restore()
    return out, {"wall_s": wall, "seconds": dict(timer.secs), "calls": dict(timer.calls),
                 "shares": {k: v / wall for k, v in timer.secs.items()}}


def _cpu_model() -> str:
    """The host CPU's model name from /proc/cpuinfo; where that says unknown
    (a sandboxed host may hide it), its vendor, family, model and
    stepping."""
    info: dict = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            if ":" in line:
                k, v = line.split(":", 1)
                info.setdefault(k.strip(), v.strip())
    name = info.get("model name", "unknown")
    if name.lower() != "unknown":
        return name
    ids = [f"{k} {info[k]}" for k in ("vendor_id", "cpu family", "model", "stepping")
           if k in info]
    return "model name unknown; " + ", ".join(ids)


def _ss_parties(torch, seed: int, n_var: int, warm_n: int, out_dir: str, device=None):
    """The SS phase's protocol: three parties (dealer 0, data parties 1 and
    2, hub 1) through the port's run_parties (256-bit field, 60 data bits,
    30 fraction bits, boolean shares, native engine) under collective keys
    (an empty shift set: the conjugation key alone).  A std-inverse round
    trip as sfgwas_tpu/gwas/assoc.py:383-410 runs it, first at warm_n
    values, then at n_var (its launches counted and recorded at the
    kernels' wrappers, party 1's stages timed by synchronized spans,
    its square root under a host profile and the round trip under
    torch.profiler), then chol_whiten of a 6 x 6 Gram.  Returns the
    parties' results, the state party 1 kept (the recorder, the launch
    counts, its host profile), the variances and the Gram.  device=None is
    the card; device="cpu" rehearses the protocol at a small n_var."""
    from sfgwas_tpu_torch.crypto import basics as B
    from sfgwas_tpu_torch.mpc import linalg as LA
    from sfgwas_tpu_torch.mpc import mhe as PM
    from sfgwas_tpu_torch.mpc import ss_he as SH
    from sfgwas_tpu_torch.mpc.mpc import MPC
    from sfgwas_tpu_torch.ops import cuda_build
    from sfgwas_tpu_torch.parallel.simulate import make_shares, reveal_ints, run_parties
    from sfgwas_tpu_torch.utils import prof

    preset, low_nmod, frac = "PN14QP438", 3, 30
    rng = np.random.default_rng(seed + 2)
    var = rng.uniform(0.01, 4.0, size=n_var)  # n_var - 1 SNP variances, the phenotype's last
    # the example's 5 covariates and the ones column (tests/test_mpc_linalg.py:87-105)
    Bm = rng.normal(size=(40, 6)) * np.array([1.0, 30.0, 0.05, 3.0, 0.5, 10.0])
    Bm[:, 0] = 1.0
    gram = Bm.T @ Bm / 40
    gate = threading.Barrier(3)
    cuda = device is None or torch.device(device).type == "cuda"
    state: dict = {}

    def std_inv(mpc, cps, m: int):
        """The round trip for the first m SNP variances and the phenotype's:
        encrypt (each data party its half), aggregate, drop to nmod 3, then
        cvec_to_ss / ciphertext_to_ss (the guard refreshes first),
        sqrt_and_sqrt_inverse, ss_to_cmat / ss_to_ciphertext; returns the
        ciphertexts of 1/sqrt."""
        slots = cps.slots
        nct = -(-m // slots)
        if mpc.pid > 0:
            ctx = cps.ctx
            x = np.zeros(m)
            part = slice(0, m // 2) if mpc.pid == 1 else slice(m // 2, m)
            x[part] = var[part]
            y = var[-1] if mpc.pid == 1 else 0.0
            cts = B.encrypt_float_vector(cps, x) + B.encrypt_float_vector(cps, [y])
            cts = [ctx.drop_to(ct, low_nmod) for ct in PM.aggregate_cvec(mpc.net, cps, cts)]
            varx, vary = cts[:-1], cts[-1]
        else:
            varx, vary = [None] * nct, None

        def body():
            varx_ss = SH.cvec_to_ss(mpc, cps, varx, -1, slots * nct)
            vary_ss = SH.ciphertext_to_ss(mpc, cps, vary, -1, 1)
            var_ss = np.concatenate([varx_ss[:m], vary_ss[:1]])
            if mpc.pid == 1 and "profile" in state:
                stdinv, state["host"] = _sqrt_host_profile(
                    lambda: mpc.sqrt_and_sqrt_inverse(var_ss)[1])
            else:
                stdinv = mpc.sqrt_and_sqrt_inverse(var_ss)[1]
            stdinvx = mpc.ring.zeros((slots * nct,))
            stdinvx[:m] = stdinv[:m]
            cv = SH.ss_to_cmat(mpc, cps, stdinvx[None])
            cy = SH.ss_to_ciphertext(mpc, cps, stdinv[m : m + 1][None])
            return (cv[0] + [cy]) if mpc.pid > 0 else None

        return body

    def decode(mpc, cps, cts, m: int):
        pts = PM.collective_decrypt_many(mpc.net, cps, cts, -1)
        got = np.concatenate([cps.ctx.decode(pt) for pt in pts[:-1]])[:m]
        return np.concatenate([got, cps.ctx.decode(pts[-1])[:1]])

    def party(mpc):
        cps = PM.collective_init(mpc.net, preset, shifts_override=[], device=device)
        out: dict = {}
        if mpc.pid > 0:  # the warm-up
            out["warm"] = decode(mpc, cps, std_inv(mpc, cps, warm_n - 1)(), warm_n - 1)
        else:
            std_inv(mpc, cps, warm_n - 1)()
        gate.wait(timeout=900)
        if mpc.pid == 1:
            state["profile"] = True
            state["rec"] = _collective_recorder()
            state["sqrt_calls"] = _FirstCalls(MPC, "sqrt_and_sqrt_inverse")  # for phase 16
            cuda_build.reset_launch_counts()
        gate.wait(timeout=900)
        prof.reset()
        body = std_inv(mpc, cps, n_var - 1)
        if mpc.pid == 1 and cuda:
            box = {}

            def traced():
                gate.wait(timeout=900)
                t0 = time.time()
                box["cts"] = body()
                box["wall"] = time.time() - t0
                gate.wait(timeout=900)

            out["profile"] = _profile(torch, traced, os.path.join(out_dir, "ss_profile.txt"),
                                      all_threads=True)
            cts, out["round_trip_s"] = box["cts"], box["wall"]
        else:
            gate.wait(timeout=900)
            t0 = time.time()
            cts = body()
            out["round_trip_s"] = time.time() - t0
            gate.wait(timeout=900)
        if mpc.pid > 0:
            t0 = time.time()
            with prof.span("decrypt"):
                out["got"] = decode(mpc, cps, cts, n_var - 1)
            out["decrypt_s"] = time.time() - t0
        out["spans"] = prof.totals()
        gate.wait(timeout=900)
        if mpc.pid == 1:
            if cuda:
                torch.cuda.synchronize()
            state["launches"] = {k: v.launches for k, v in cuda_build.REGISTRY.items()}
            state["rec"].restore()
            state["sqrt_calls"].restore()
        gate.wait(timeout=900)
        # chol_whiten of the covariates' Gram
        sh = make_shares(mpc, [int(round(v * (1 << frac))) for v in gram.reshape(-1)])
        W = LA.chol_whiten(mpc, sh.reshape(6, 6, -1))
        rev = reveal_ints(mpc, W.reshape(36, -1))
        if mpc.pid > 0:
            p = mpc.ring.modulus
            out["W"] = np.array([(int(v) - p if int(v) > p // 2 else int(v)) / (1 << frac)
                                 for v in rev]).reshape(6, 6)
        return out

    prof.ENABLED, prof.SYNC = True, (torch.cuda.synchronize if cuda else None)
    try:
        res = run_parties(3, party, timeout=1500)
    finally:
        prof.ENABLED, prof.SYNC = False, None
        for k in ("rec", "sqrt_calls"):
            if k in state:
                state[k].restore()
    return res, state, var, gram


def ss_phase(torch, seed: int, out_dir: str, kernels: list):
    """Phase 7: the SS domain and the SS<->HE bridge at PN14QP438 on the
    card, at the example's std-inverse size (n = 99,337: 99,336 SNP
    variances and the phenotype's), then K1, K4, K5 and K6 against their
    plain versions at every shape the round trip launched them with.
    Appends the kernels' records to `kernels`; returns the phase's record
    and, for phase 16, what each party's timed square root started from
    and gave (_FirstCalls)."""
    from sfgwas_tpu_torch.crypto.params import get_params

    n_var, warm_n = 99_337, 8_192
    params = get_params("PN14QP438")
    t0 = time.time()
    res, state, var, gram = _ss_parties(torch, seed, n_var, warm_n, out_dir)
    t_phase = time.time() - t0
    rec, launches, host = state["rec"], state["launches"], state["host"]
    want = 1 / np.sqrt(var)
    errs, werrs, tri, ortho = {}, {}, {}, {}
    for pid in (1, 2):
        r = res[pid]
        errs[pid] = float(np.max(np.abs(r["got"] - want) / np.maximum(1, want)))
        wv = np.concatenate([var[: warm_n - 1], var[-1:]])
        wwant = 1 / np.sqrt(wv)
        werrs[pid] = float(np.max(np.abs(r["warm"] - wwant) / np.maximum(1, wwant)))
        W = r["W"]
        tri[pid] = float(np.abs(W - np.triu(W)).max())
        ortho[pid] = float(np.abs(W.T @ gram @ W - np.eye(6)).max())
    hub = res[1]
    spans = {k: v[0] for k, v in hub["spans"].items()}  # seconds, synchronized
    profiled = hub["profile"]
    cpu = f"{_cpu_model()}, {os.cpu_count()} logical cores"
    line = {
        "n": n_var, "max_rel_err": errs, "warm_up": {"n": warm_n, "max_rel_err": werrs},
        "stage_s_party1": spans, "round_trip_s": hub["round_trip_s"],
        "decrypt_s": hub["decrypt_s"], "sqrt_host_profile_party1": host,
        "device_busy_ms": profiled["device_busy_ms"], "window_ms": profiled["window_ms"],
        "idle_share": profiled["idle_share"], "host_readbacks": profiled["host_readbacks"],
        "device_to_host_copies": profiled["dtoh_copies"],
        "chol_whiten": {"upper_err": tri, "whiten_err": ortho}, "host_cpu": cpu,
        "phase_s": t_phase,
    }
    _say(f"ss phase: {json.dumps(line)}")
    _say(f"launches: ss path {json.dumps(launches)}")
    for pid in (1, 2):
        if not np.isfinite(errs[pid]) or errs[pid] > 1e-4 or werrs[pid] > 1e-4:
            raise AssertionError(f"party {pid}: 1/sqrt off by {errs[pid]} (warm-up {werrs[pid]})")
        if tri[pid] > 1e-6 or not ortho[pid] <= 2e-2:
            raise AssertionError(f"party {pid}: chol_whiten upper {tri[pid]}, W^T G W - I "
                                 f"{ortho[pid]}")
    missing = [k for k in MHE_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the ss path: {missing}")
    if profiled["host_readbacks"]:
        raise AssertionError(f"the round trip read {profiled['host_readbacks']} device values "
                             "back to the host")
    # the hub's he2ss_pull is the one sanctioned read-back: one a converted ciphertext
    if profiled["dtoh_copies"] > -(-(n_var - 1) // params.slots) + 1:
        raise AssertionError(f"the round trip copied {profiled['dtoh_copies']} tensors to the host")
    k1_shapes, k1_total, tree_shapes, _ = _collective_kernel_checks(
        torch, rec, launches, params, kernels, "ss")
    line.update(launches=launches, profile=profiled, k1_total_ms=k1_total, k1_shapes=k1_shapes,
                tree_shapes=tree_shapes)
    return line, state["sqrt_calls"].snaps


# ---------------------------------------------------------------------------
# 16. the SS domain's device mode (K8 and its fused entries, K9-K11)

# each ring wrapper of ops/cuda_ring.py: its kernel and the reference's
# device program it replaces (K8's fused entries: every program they stand
# for under "replaces_all")
RING_KERNELS = {
    "reduce": ("ring_reduce", "sfgwas_tpu/ops/ring.py:389"),
    "combine": ("ring_combine", "sfgwas_tpu/ops/ring.py:475"),
    "sum_axis": ("ring_sum", "sfgwas_tpu/ops/ring.py:671"),
    "from_i32": ("ring_from_i32", "sfgwas_tpu/ops/ring.py:285"),
    "mul": ("ring_mul", "sfgwas_tpu/ops/ring.py:522"),
    "matmul": ("ring_matmul", "sfgwas_tpu/ops/ring.py:590"),
    "dot": ("ring_dot", "sfgwas_tpu/ops/ring.py:653"),
}
RING_REPLACES_ALL = {
    "combine": ["sfgwas_tpu/ops/ring.py:475 _add_dev", "sfgwas_tpu/ops/ring.py:488 _sub_dev",
                "sfgwas_tpu/ops/ring.py:507 _neg_dev",
                "sfgwas_tpu/ops/ring.py:555 mul_int's reduce of a * v"],
    "sum_axis": ["sfgwas_tpu/ops/ring.py:671 _sum_dev"],
    "from_i32": ["sfgwas_tpu/ops/ring.py:285-290 from_i32's device branch"],
}
# the kernels phase 16's replays launch; K8's digit entry (reduce) and its
# from_i32 entry have no caller there (every add, sub, neg, small mul_int
# and sum is a fused entry's launch; from_i32 runs on host arrays in both
# packages), so they are held to their plain versions and timed at the
# path's shapes apart, off the path
SS_DEVICE_PATH = ("ring_combine", "ring_sum", "ring_mul", "ring_matmul", "ring_dot")
# timed shapes a kernel: its most work and its most launches; the rest only compared
RING_TIMED_SHAPES = 2


def _ring_key(name):
    def key(ring, *xs):
        return (ring.name,) + tuple(tuple(x.shape) if hasattr(x, "shape") else x for x in xs)

    return key


def _rows_of(shape) -> int:
    return int(np.prod(shape[:-1])) if shape else 0


def _ring_work(name: str, key) -> tuple:
    """(bytes, operations) of one launch at a recorded key: each input read
    once (an operand broadcast in place: its own rows once), each output
    written once; a 32 x 32 -> 64-bit word product counts as two operations
    (a multiply-add), W^2 of them a product of W-word elements; K8 and its
    entries one operation a digit in and out."""
    ring_name, *args = key
    L = 32 if ring_name in ("LElem256", "LElem2N256") else 16
    W = L // 4
    if name == "reduce":
        (xs,) = args
        n = int(np.prod(xs[:-1]))
        return 4 * n * (xs[-1] + L), n * (xs[-1] + L)
    if name in ("combine", "mul"):
        shapes = [s for s in args[:2] if isinstance(s, tuple)]
        n = int(np.prod(np.broadcast_shapes(*[s[:-1] for s in shapes])))
        rows = sum(_rows_of(s) for s in shapes) + n
        return 4 * L * rows, (L * rows if name == "combine" else 2 * W * W * n)
    if name == "sum_axis":
        shape, axis = args
        rows = _rows_of(shape)
        n = rows // shape[axis]
        return 4 * L * (rows + n), L * (rows + n)
    if name == "from_i32":
        (shape,) = args
        n = int(np.prod(shape))
        return 4 * n * (1 + L), n * (1 + L)
    if name == "matmul":
        (r, k, _), (_, c, _) = args
        return 4 * L * (r * k + k * c + r * c), 2 * W * W * r * k * c
    (a, cf) = args
    n, k = int(np.prod(a[:-2])), cf[0]
    return 4 * L * (n * k + k + n), 2 * W * W * n * k


def _timed_keys(counts: dict, name: str, keys) -> list:
    """The keys of one ring kernel that phase 16 times: its shape of most
    work (launches x bytes), then its shape of most launches, to
    RING_TIMED_SHAPES."""
    by_work = sorted(keys, key=lambda k: counts[(name, k)] * _ring_work(name, k)[0], reverse=True)
    by_launches = sorted(keys, key=lambda k: counts[(name, k)], reverse=True)
    out: list = []
    for k in by_work[:1] + by_launches[:1]:
        if k not in out and len(out) < RING_TIMED_SHAPES:
            out.append(k)
    return out


class _FirstCalls(_Patches):
    """Wraps a protocol function `fn(mpc, x, ...)` that the parties look up
    at call time and keeps, at each party, what its first call started
    from and gave: a copy of the party's PRG table, the input on the host,
    the MPC's parameters, the outputs on the host and the seconds it took.
    Phase 16 replays that call in device mode from the same state."""

    def __init__(self, owner, attr: str):
        super().__init__()
        from sfgwas_tpu_torch.ops import ring as R

        self.snaps: dict = {}
        lock = threading.Lock()

        def make(real):
            def wrapped(mpc, x, *a, **k):
                with lock:
                    first = mpc.pid not in self.snaps
                    if first:
                        self.snaps[mpc.pid] = None  # taken
                if not first:
                    return real(mpc, x, *a, **k)
                snap = {"rand": copy.deepcopy(mpc.rand), "x": R.to_host(x).copy(),
                        "args": (a, k), "mpc": {
                            "ring": mpc.ring, "data_bits": mpc.data_bits,
                            "frac_bits": mpc.frac_bits, "boolean_shares": mpc.boolean_shares,
                            "hub_pid": mpc.hub_pid, "div_sqrt_max_len": mpc.div_sqrt_max_len}}
                t0 = time.perf_counter()
                out = real(mpc, x, *a, **k)
                snap["s"] = time.perf_counter() - t0
                snap["out"] = [R.to_host(v) for v in (out if isinstance(out, tuple) else (out,))]
                with lock:
                    self.snaps[mpc.pid] = snap
                return out

            return wrapped

        self.patch(owner, attr, make)


def _device_trace(torch, fn) -> tuple:
    """fn() with the device's work traced by torch.profiler, device
    activity alone (the host's calls are not recorded, so fn's wall time
    stays close to its own): (fn's result, a record: fn's seconds to the
    device's end, the device's busy ms, its idle share of that time, its
    events and kernels (the events that are no copy or fill), device ms by
    name, the largest)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = _trace_rows(torch, prof)
    summary = trace_summary(rows)
    if not summary["kernels"]:
        raise AssertionError("torch.profiler traced no device work")
    busy = summary["device_busy_ms"]
    kernels = sum(1 for r in rows if r[1] and not r[0].startswith(("Memcpy", "Memset")))
    return out, {"run_s": wall, "device_busy_ms": busy, "idle_share": 1 - busy / (wall * 1e3),
                 "device_events": summary["kernels"], "device_kernels": kernels,
                 "device_top_ms": summary["top_ms"][:10]}


def ss_device_replay(torch, snaps: dict, call, device, trace: bool = False) -> dict:
    """Replays at three parties (run_parties with the snapshots' MPC
    parameters) a call that _FirstCalls kept, in device mode: LElem256's
    `host` False, each party's input a tensor on `device`, its PRG table
    the kept one.  Party 1's call is timed under a host profile (and, with
    trace, the device's work during it traced: every party's).  Returns each
    party's outputs on the host, whether they equal the kept ones, and party
    1's record (with trace, its seconds are the call's to the device's end,
    and trace_s those spent reading the trace after it)."""
    from sfgwas_tpu_torch.ops import ring as R
    from sfgwas_tpu_torch.parallel.simulate import run_parties

    if sorted(snaps) != [0, 1, 2] or any(s is None for s in snaps.values()):
        raise AssertionError(f"no kept call at every party: {sorted(snaps)}")
    gate = threading.Barrier(3)
    dev_type = torch.device(device).type
    cuda = dev_type == "cuda"

    def party(mpc):
        snap = snaps[mpc.pid]
        mpc.rand = copy.deepcopy(snap["rand"])
        x = torch.as_tensor(snap["x"], device=device)
        a, k = snap["args"]
        run = lambda: call(mpc, x, *a, **k)  # noqa: E731
        out: dict = {}
        gate.wait(timeout=900)
        t0 = time.perf_counter()
        if mpc.pid == 1 and trace and cuda:
            (res, out["host_profile"]), traced = _device_trace(
                torch, lambda: _sqrt_host_profile(run))
            out.update(traced)
        elif mpc.pid == 1:
            res, out["host_profile"] = _sqrt_host_profile(run)
        else:
            res = run()
        if cuda:
            torch.cuda.synchronize()
        out["s"] = time.perf_counter() - t0
        if "run_s" in out:  # the call's own seconds; the rest read the trace
            out["s"], out["trace_s"] = out["run_s"], out["s"] - out["run_s"]
        res = res if isinstance(res, tuple) else (res,)
        out["tensors"] = [isinstance(v, torch.Tensor) and v.device.type == dev_type
                          for v in res]
        out["equal"] = all(np.array_equal(R.to_host(v), w) for v, w in zip(res, snap["out"]))
        return out

    ring = snaps[1]["mpc"]["ring"]
    saved = ring.host
    try:
        ring.host = False
        return run_parties(3, party, timeout=1500, **snaps[1]["mpc"])
    finally:
        ring.host = saved


def ss_device_runs(torch, sqrt_snaps: dict, inv_snaps: dict, device="cuda") -> dict:
    """Phase 16's replays in device mode, their launches counted (set to 0
    first) and recorded at the ring kernels' wrappers: (a) the square root
    sqrt_snaps kept, its device work traced on the card, (b) the inverse
    inv_snaps kept, not traced (reading back the trace of its ~256,000
    device events took 19-25 s on an H100's host).  On the CPU
    (device="cpu") the plain versions run.  Also returns the operands copied
    out before a launch (cuda_ring.OPERAND_COPIES over the replays)."""
    from sfgwas_tpu_torch.mpc import linalg as LA
    from sfgwas_tpu_torch.mpc.mpc import MPC
    from sfgwas_tpu_torch.ops import cuda_build, cuda_ring

    rec = _Recorder()
    for attr in RING_KERNELS:
        rec.wrap(cuda_ring, attr, attr, _ring_key(attr))
    cuda_build.reset_launch_counts()
    copies = cuda_ring.OPERAND_COPIES
    try:
        runs = {"sqrt": ss_device_replay(torch, sqrt_snaps, MPC.sqrt_and_sqrt_inverse, device,
                                         trace=True),
                "inverse": ss_device_replay(torch, inv_snaps, LA.matrix_inverse_sqrt_svd,
                                            device)}
    finally:
        rec.restore()
    launches = {sym: cuda_build.REGISTRY[sym].launches for sym, _ in RING_KERNELS.values()}
    return {"runs": runs, "launches": launches, "rec": rec,
            "operand_copies": cuda_ring.OPERAND_COPIES - copies}


def _device_total_ms(torch, fn, reps: int) -> tuple:
    """(device ms per call of fn, device events per call): every device
    event's duration in a torch.profiler trace of reps calls, after one; a
    trace with no device event is taken again with more calls, as
    _device_ms does, and after PROFILE_TRIES such traces both are None."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_TRIES + 1):
        calls = reps * attempt
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        ev = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
        if ev:
            return sum(e.end_ns() - e.start_ns() for e in ev) / calls / 1e6, len(ev) / calls
        print(f"chip_smoke: torch.profiler traced no device event in try {attempt} of "
              f"{PROFILE_TRIES}: {calls} calls", file=sys.stderr, flush=True)
    return None, None


def _ring_pairs(torch, cuda_ring):
    """Each K8 entry's launches on the card before it was fused (the
    torch expression ops/ring.py ran, then K8 on its int32 digits), from
    the entry's arguments."""
    def combine(ring, a, b, sa, sb):
        if b is None:
            x = -a if sa == -1 else a * sa  # neg, mul_int
        elif sa == 1 and sb in (1, -1):
            x = a + b if sb == 1 else a - b  # add, sub
        else:
            x = a * sa + b * sb
        return cuda_ring.reduce(ring, x)

    def sum_axis(ring, a, axis):
        return cuda_ring.reduce(ring, torch.sum(a, dim=axis, dtype=torch.int32))

    def from_i32(ring, v):
        v = v.to(torch.int32)
        x = torch.stack([(v >> (8 * i)) & 0xFF for i in range(4)], dim=-1)
        return cuda_ring.reduce(ring, torch.nn.functional.pad(x, (0, ring.nlimb - 4)))

    return {"combine": combine, "sum_axis": sum_axis, "from_i32": from_i32}


def _ring_record_extras(torch, record, name, args, pair, reps):
    """A K8 entry's record: the programs it stands for, and the device ms,
    kernels and call ms of its unfused launch pair on the same inputs."""
    record["replaces_all"] = RING_REPLACES_ALL[name]
    if record.get("ms") is not None:
        pms, pk = _device_total_ms(torch, lambda: pair(*args), reps)
        record.update(pair_ms=pms, pair_kernels=pk,
                      pair_call_ms=_time_ms(torch, lambda: pair(*args), reps))


def ss_device_phase(torch, sqrt_snaps: dict, inv_snaps: dict, kernels: list) -> dict:
    """Phase 16: the SS domain's device mode on the card, after phase 13.
    (a) phase 7's sqrt_and_sqrt_inverse over its n = 99,337 shares and (b)
    phase 13's first matrix_inverse_sqrt_svd (the 6 x 6 inverse of the
    first Newton epoch's near-scalar Z^T W Z), each replayed at three
    parties in device mode (the shares on the card, K8's entries and
    K9-K11 launched by the ring) from the PRG tables and inputs those
    phases started it from, and bit-equal to their host-mode outputs at
    every party; party 1 timed under a host profile against its host-mode
    seconds, (a)'s device work traced (busy and idle share, its device
    events and kernels); the launch counts set to 0 before the
    replays and read after them; then (c) every kernel against its plain
    version at every shape the replays launched it with (each timed at its
    shape of the most work and of the most launches; a K8 entry beside its
    unfused launch pair), and (d) the entries the replays do not launch,
    K8's digit entry and from_i32, held to their plain versions and timed
    at the path's shapes.  Appends the timed records of the path's kernels
    to `kernels`."""
    global TIMING
    from sfgwas_tpu_torch.ops import cuda_ring

    t_phase = time.time()
    res = ss_device_runs(torch, sqrt_snaps, inv_snaps)
    runs, launches, rec = res["runs"], res["launches"], res["rec"]
    line = {"sqrt_n": int(sqrt_snaps[1]["x"].shape[0]),
            "inverse_shape": list(inv_snaps[1]["x"].shape[:2]), "launches": launches,
            "operand_copies": res["operand_copies"]}
    for name, snaps in (("sqrt", sqrt_snaps), ("inverse", inv_snaps)):
        r = runs[name]
        line[name] = {"host_mode_s_party1": snaps[1]["s"], "device_mode_s_party1": r[1]["s"],
                      "bit_equal": {pid: r[pid]["equal"] for pid in range(3)},
                      "device_tensors": {pid: r[pid]["tensors"] for pid in (1, 2)},
                      "device_mode_host_profile_party1": r[1]["host_profile"]}
        for k in ("trace_s", "device_busy_ms", "idle_share", "device_events", "device_kernels",
                  "device_top_ms"):
            if k in r[1]:
                line[name][k] = r[1][k]
    _say(f"ss device phase: {json.dumps(line)}")
    for name in ("sqrt", "inverse"):
        if not all(line[name]["bit_equal"].values()):
            raise AssertionError(f"{name} in device mode differs from host mode: "
                                 f"{line[name]['bit_equal']}")
        if not all(all(v) for v in line[name]["device_tensors"].values()):
            raise AssertionError(f"{name}: device-mode outputs not tensors on the card: "
                                 f"{line[name]['device_tensors']}")
    missing = [k for k in SS_DEVICE_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the ss device path: {missing}")
    recorded = {RING_KERNELS[name][0]: sum(n for (nm, _), n in rec.counts.items() if nm == name)
                for name in RING_KERNELS}
    if recorded != launches:
        raise AssertionError(f"ring launches {launches}, recorded at the wrappers {recorded}")
    plain = {"reduce": cuda_ring.reduce_plain, "combine": cuda_ring.combine_plain,
             "sum_axis": cuda_ring.sum_plain, "from_i32": cuda_ring.from_i32_plain,
             "mul": cuda_ring.mul_plain, "matmul": cuda_ring.matmul_plain,
             "dot": cuda_ring.dot_plain}
    pairs = _ring_pairs(torch, cuda_ring)
    compared: list = []

    def check(target, name, key, a, reps):
        sym, replaces = RING_KERNELS[name]
        nbytes, ops = _ring_work(name, key)
        _check(torch, target, f"{sym} {list(key)}", sym, "sfgwas_tpu_torch/csrc/ring.cu",
               replaces, list(key), lambda: [real(*a)], lambda: [plain[name](*a)], reps, 1,
               nbytes, ops)
        if name in pairs:
            _ring_record_extras(torch, target[-1], name, a, pairs[name], reps)

    for name, found in rec.args.items():
        real = rec.real[name]
        timed = _timed_keys(rec.counts, name, found)
        for key in sorted(found, key=lambda k: k not in timed):
            nbytes, _ = _ring_work(name, key)
            TIMING = key in timed
            try:
                check(kernels if TIMING else compared, name, key, found[key],
                      max(5, min(100, int(2e8 // (nbytes + 1)))))
            finally:
                TIMING = True
            (kernels if key in timed else compared)[-1].update(
                launches=launches[RING_KERNELS[name][0]], path="ss_device",
                launches_at_shape=rec.counts[(name, key)])
    # (d) the entries off the path, at the path's shapes: K8 on [2n, L]
    # digits in [0, 510] (an add's unfused intermediate at the square root's
    # stacked g and h), from_i32 on the square root's n values
    off_path: list = []
    ring, n = sqrt_snaps[1]["mpc"]["ring"], line["sqrt_n"]
    gen = np.random.default_rng(16)
    digits = torch.as_tensor(gen.integers(0, 511, size=(2 * n, ring.nlimb)).astype(np.int32),
                             device="cuda")
    v = torch.as_tensor(gen.integers(-(2**31), 2**31 - 1, size=n).astype(np.int32),
                        device="cuda")
    for name, args in (("reduce", (ring, digits)), ("from_i32", (ring, v))):
        real = rec.real[name]
        check(off_path, name, _ring_key(name)(*args), args, 100)
        off_path[-1].update(launches=launches[RING_KERNELS[name][0]], path="ss_device",
                            on_path=False)
    del rec
    line.update(compared_without_timing=_equal_only(compared, "ss_device"),
                off_path=off_path, phase_s=time.time() - t_phase)
    bad = [k["name"] for k in off_path if not k["bit_equal"]]
    if bad:
        raise AssertionError(f"kernels differ from their plain versions: {bad}")
    _say(f"ss device off the path: {json.dumps(off_path)}")
    return line


# ---------------------------------------------------------------------------
# 8. the CholeskyQR2 covariate basis

QR_PATH = ("ntt_fwd", "ntt_inv", "ks_digit_product", "uniform_mod", "bs_mask", "bs_combine",
           "crt_lift")
# the plain-torch programs of the QR path, labelled in its profile: (owner
# module path, attribute, label); ROADMAP B12-B14
PLAIN_PROGRAMS = (
    ("sfgwas_tpu_torch.crypto.ckks:CkksContext", "_tensor_product", "B12 tensor product"),
    ("sfgwas_tpu_torch.crypto.ckks:CkksContext", "_extend_multi", "B12 ModUp basis extension"),
    ("sfgwas_tpu_torch.crypto.ckks:CkksContext", "_extend",
     "B12 ModDown/rescale basis extension"),
    ("sfgwas_tpu_torch.crypto.ckks:CkksContext", "mul_plain_many_b", "B13 mul_plain_many_b"),
    ("sfgwas_tpu_torch.crypto.ckks:CkksContext", "mul_plain_pairs_sum",
     "B13 mul_plain_pairs_sum"),
    ("sfgwas_tpu_torch.crypto.basics", "_segsum_mod", "B14 _segsum_mod"),
)


class _Labelled(_Patches):
    """Wraps the PLAIN_PROGRAMS in torch.profiler.record_function ranges
    while it is entered, so a trace attributes their device time."""

    def __init__(self, torch):
        super().__init__()
        self.torch = torch

    def __enter__(self):
        import importlib

        for owner_path, attr, label in PLAIN_PROGRAMS:
            mod, _, cls = owner_path.partition(":")
            owner = importlib.import_module(mod)
            owner = getattr(owner, cls) if cls else owner

            def make(real, _label=label):
                def wrapped(*a, **k):
                    with self.torch.profiler.record_function(_label):
                        return real(*a, **k)

                return wrapped

            self.patch(owner, attr, make)
        return self

    def __exit__(self, *exc):
        self.restore()


def _qr_parties(torch, seed: int, out_dir: str, n_loc: int = 1000, preset: str = "PN14QP438",
                device=None):
    """The QR phase's protocol: three parties (dealer 0, data parties 1 and
    2, hub 1) through the port's run_parties (256-bit field, 60 data bits,
    30 fraction bits, boolean shares, native engine) under collective keys
    at `preset` with the default shift set and the relinearisation key.
    Each data party holds n_loc individuals with 5 covariates drawn from
    the seed at column scales 1, 20, 0.1, 50 and 0.3; compute_combined_q
    (cholqr2, with the ones column) runs once as a warm-up, once timed
    (every launch count set to 0 just before, read right after, the
    kernels' inputs recorded at their wrappers, party 1's spans
    synchronized) and once under torch.profiler over all threads with the
    plain-torch programs labelled; then each data party's rows of the timed
    Q are decrypted collectively.  Then the Householder QR of each of
    householder_inputs' matrices, timed once (launch counts set to 0 just
    before and read right after each, the kernels' inputs recorded at
    their wrappers during each, party 1's spans synchronized), each Q
    decrypted collectively.
    Returns the parties' results, the state party 1 kept, the covariates
    and the Householder inputs.  device=None is the card; device="cpu"
    rehearses the protocol (at a small preset)."""
    from sfgwas_tpu_torch.crypto import basics as B
    from sfgwas_tpu_torch.gwas.assoc import compute_combined_q
    from sfgwas_tpu_torch.gwas.qrfact import net_qr
    from sfgwas_tpu_torch.mpc import mhe as PM
    from sfgwas_tpu_torch.ops import cuda_build
    from sfgwas_tpu_torch.parallel.simulate import run_parties
    from sfgwas_tpu_torch.utils import prof

    ncov = 5
    rng = np.random.default_rng(seed + 3)
    cov = rng.normal(size=(2 * n_loc, ncov)) * np.array([1.0, 20.0, 0.1, 50.0, 0.3])
    nrows_all = [0, n_loc, n_loc]
    hh_inputs = householder_inputs(seed, cov)
    gate = threading.Barrier(3)
    cuda = device is None or torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    state: dict = {}

    def basis(mpc, cps):
        c = cov[(mpc.pid - 1) * n_loc : mpc.pid * n_loc] if mpc.pid > 0 else ncov
        return compute_combined_q(mpc, cps, c, None, nrows_all, False, qr_method="cholqr2")[0]

    def party(mpc):
        pid = mpc.pid
        t0 = time.time()
        cps = PM.collective_init(mpc.net, preset, device=device)
        sync()
        out: dict = {"keygen_s": time.time() - t0, "rot_keys": len(cps.rot_keys)}
        t0 = time.time()
        basis(mpc, cps)  # the warm-up
        sync()
        out["warm_up_s"] = time.time() - t0
        gate.wait(timeout=900)
        if pid == 1:
            state["rec"] = _collective_recorder(k3=True)
            cuda_build.reset_launch_counts()
            prof.ENABLED, prof.SYNC = True, (torch.cuda.synchronize if cuda else None)
        gate.wait(timeout=900)
        prof.reset()
        t0 = time.time()
        Q = basis(mpc, cps)
        sync()
        out["call_s"] = time.time() - t0
        out["spans"] = prof.totals()
        gate.wait(timeout=900)
        if pid == 1:
            state["launches"] = {k: v.launches for k, v in cuda_build.REGISTRY.items()}
            state["rec"].restore()
            prof.ENABLED, prof.SYNC = False, None
        gate.wait(timeout=900)
        # the traced call
        if pid == 1 and cuda:
            def traced():
                gate.wait(timeout=900)
                basis(mpc, cps)
                gate.wait(timeout=900)

            with _Labelled(torch):
                out["profile"] = _profile(torch, traced, os.path.join(out_dir, "qr_profile.txt"),
                                          all_threads=True, labels=[p[2] for p in PLAIN_PROGRAMS])
        else:
            gate.wait(timeout=900)
            basis(mpc, cps)
            gate.wait(timeout=900)
        def decrypted(Q):
            """Each data party's rows of Q, decrypted collectively."""
            blocks = []
            for p in (1, 2):
                nct = -(-nrows_all[p] // cps.slots)
                cts = [ct for col in Q for ct in col] if pid == p else [None] * (len(Q) * nct)
                pts = PM.collective_decrypt_many(mpc.net, cps, cts, p)
                vals = np.stack([cps.ctx.decode(pt) for pt in pts]).reshape(len(Q), -1)
                blocks.append(vals[:, : nrows_all[p]].T)
            return np.concatenate(blocks)

        if pid > 0:
            out["levels"] = sorted({(ct.nmod, ct.scale) for col in Q for ct in col})
            out["ncols"] = len(Q)
            out["Q"] = decrypted(Q)
        # the Householder QR of each input, timed once: every launch count
        # set to 0 just before and read right after, the kernels' inputs
        # recorded at their wrappers over both calls, party 1's spans
        # synchronized
        out["householder"] = {}
        for name, mat in hh_inputs.items():
            k = mat.shape[1]
            loc = mat[(pid - 1) * n_loc : pid * n_loc] if pid > 0 else None
            A = ([B.encrypt_float_vector(cps, loc[:, j]) for j in range(k)] if pid > 0
                 else [None] * k)
            sync()
            gate.wait(timeout=900)
            if pid == 1:
                state.setdefault("hh_rec", {})[name] = _collective_recorder(k3=True)
                cuda_build.reset_launch_counts()
                prof.ENABLED, prof.SYNC = True, (torch.cuda.synchronize if cuda else None)
            gate.wait(timeout=900)
            prof.reset()
            t0 = time.time()
            Q = net_qr(cps, mpc, A, nrows_all, method="householder")
            sync()
            hh = {"call_s": time.time() - t0, "spans": prof.totals()}
            gate.wait(timeout=900)
            if pid == 1:
                state.setdefault("hh_launches", {})[name] = {
                    kk: v.launches for kk, v in cuda_build.REGISTRY.items()}
                state["hh_rec"][name].restore()
                prof.ENABLED, prof.SYNC = False, None
            gate.wait(timeout=900)
            if pid > 0:
                hh["levels"] = sorted({(ct.nmod, ct.scale) for col in Q for ct in col})
                hh["ncols"] = len(Q)
                hh["Q"] = decrypted(Q)
            out["householder"][name] = hh
        return out

    try:
        res = run_parties(3, party, timeout=1500)
    finally:
        prof.ENABLED, prof.SYNC = False, None
        for rec in [state.get("rec")] + list(state.get("hh_rec", {}).values()):
            if rec is not None:
                rec.restore()
    return res, state, cov, hh_inputs


# Phase 8's limit on |Q^T Q - I| and |Q - numpy's Q|.  An entry of Q is
# about 1/sqrt(2000) = 0.022, so the reference tests' 2e-2 would pass a Q
# off in scale by a percent; CKKS at PN14QP438 leaves errors near 1e-8, and
# 1e-5 still fails a scale error of a permille (2.2e-5 an entry).
QR_TOL = 1e-5


# Phase 8's limit for the Householder QR (the reference's contract is 2e-2)
HH_TOL = 1e-4
# the width of phase 8's second Householder input: PCA's kp at
# config/configGlobal.toml's 5 PCs and 10 oversampling columns
HH_COLS = 15
# The Householder QR launches each kernel at hundreds of shapes (its batches
# shrink a column at a time): each kernel is timed at this many of its new
# shapes, those of the most work, and compared with its plain version at
# every other new shape (the whole script runs within its 1,200 s)
HH_TIMED_SHAPES = 1
# party 1's spans of the Householder QR (gwas/qrfact.py::net_dqr_enc)
HH_SPANS = ("qr_sqsum", "qr_aggz", "qr_ispos", "qr_ss2he", "qr_uvec_mul", "qr_dcmm",
            "qr_backward")


def householder_inputs(seed: int, cov: np.ndarray) -> dict:
    """Phase 8's two Householder inputs over all 2 x n_loc rows: [ones |
    covariates] (the combined basis' input) and a N(0,1) matrix of HH_COLS
    columns from the seed."""
    n = cov.shape[0]
    rng = np.random.default_rng(seed + 4)
    return {"basis": np.column_stack([np.ones(n), cov]),
            "gaussian": rng.normal(size=(n, HH_COLS))}


def householder_check(Qn: np.ndarray, a: np.ndarray) -> dict:
    """A Householder Q (scaled by sqrt(N)) against numpy's QR of a: Q^T Q /
    N - I and Q / sqrt(N) - numpy's Q, each column of numpy's given the sign
    of the Householder one (the QR of a full-rank matrix is unique up to
    those signs)."""
    n = a.shape[0]
    q, _ = np.linalg.qr(a)
    Q = Qn / np.sqrt(n)
    sign = np.where(np.sum(Q * q, axis=0) < 0, -1.0, 1.0)
    return {"ortho_err": float(np.abs(Q.T @ Q - np.eye(Q.shape[1])).max()),
            "qr_err": float(np.abs(Q - q * sign).max()), "finite": bool(np.isfinite(Q).all()),
            "negated_columns": int((sign < 0).sum())}


def qr_check(res, cov) -> dict:
    """The covariate basis against numpy at each data party: Q^T Q - I and
    Q - numpy's QR of [ones | covariates] (diag(R) > 0), Q scaled back by
    1/sqrt(N), and the (level, scale) pairs of Q's ciphertexts."""
    n = cov.shape[0]
    q, r = np.linalg.qr(np.column_stack([np.ones(n), cov]))
    q = q * np.sign(np.diag(r))
    out = {}
    for pid in (1, 2):
        Q = res[pid]["Q"] / np.sqrt(n)
        out[pid] = {
            "ortho_err": float(np.abs(Q.T @ Q - np.eye(Q.shape[1])).max()),
            "qr_err": float(np.abs(Q - q).max()), "finite": bool(np.isfinite(Q).all()),
            "levels": res[pid]["levels"], "ncols": res[pid]["ncols"],
        }
    return out


def qr_phase(torch, seed: int, out_dir: str, kernels: list) -> dict:
    """Phase 8: the CholeskyQR2 covariate basis (compute_combined_q) at
    PN14QP438 for three parties on the card at the example's size, then K1,
    K3, K4, K5 and K6 against their plain versions at every shape the timed
    call launched them with; then the two Householder QRs, held to numpy,
    and the kernels at their new shapes.  Appends the kernels' records to `kernels`;
    returns the phase's record."""
    from sfgwas_tpu_torch.crypto.params import get_params
    from sfgwas_tpu_torch.mpc import mhe as PM

    params = get_params("PN14QP438")
    t0 = time.time()
    res, state, cov, hh_inputs = _qr_parties(torch, seed, out_dir)
    t_phase = time.time() - t0
    rec, launches = state["rec"], state["launches"]
    hub = res[1]
    checks = qr_check(res, cov)
    spans = {k: v[0] for k, v in hub["spans"].items()}  # seconds, synchronized
    profiled = hub["profile"]
    line = {
        "individuals": cov.shape[0], "covariates": cov.shape[1], "checks": checks,
        "keygen_s": hub["keygen_s"], "rotation_keys": hub["rot_keys"],
        "warm_up_s": hub["warm_up_s"], "call_s_party1": hub["call_s"],
        "call_s_party2": res[2]["call_s"], "span_s_party1": spans,
        "device_busy_ms": profiled["device_busy_ms"], "window_ms": profiled["window_ms"],
        "idle_share": profiled["idle_share"], "host_readbacks": profiled["host_readbacks"],
        "device_to_host_copies": profiled["dtoh_copies"], "labelled_ms": profiled["labelled_ms"],
        "phase_s": t_phase,
    }
    _say(f"qr phase: {json.dumps(line)}")
    _say(f"launches: qr path {json.dumps(launches)}")
    for pid in (1, 2):
        c = checks[pid]
        if not c["finite"] or not c["ortho_err"] <= QR_TOL or not c["qr_err"] <= QR_TOL:
            raise AssertionError(f"party {pid}: Q^T Q - I {c['ortho_err']}, Q - numpy "
                                 f"{c['qr_err']}")
        if len(c["levels"]) != 1 or c["ncols"] != 6:
            raise AssertionError(f"party {pid}: {c['ncols']} columns at (nmod, scale) "
                                 f"{c['levels']}")
    missing = [k for k in QR_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the qr path: {missing}")
    if profiled["host_threads"] < 2:
        raise AssertionError("the QR's profile traced one thread: party 2's host operations "
                             "are missing")
    k1_shapes, k1_total, tree_shapes, _ = _collective_kernel_checks(
        torch, rec, launches, params, kernels, "qr")
    line.update(launches=launches, profile=profiled, k1_total_ms=k1_total, k1_shapes=k1_shapes,
                tree_shapes=tree_shapes,
                bs_mask_generic_off_path=_bs_mask_generic_off_path(torch, PM, rec, launches,
                                                                   "qr"))

    # the Householder QRs: each within HH_TOL of numpy, then every kernel at
    # each shape of the two calls that no earlier check held
    hh_launches = state["hh_launches"]
    hh_line = {}
    for name, a in hh_inputs.items():
        spans = {k: v[0] for k, v in hub["householder"][name]["spans"].items()}
        hh_line[name] = {
            "columns": a.shape[1], "call_s_party1": hub["householder"][name]["call_s"],
            "call_s_party2": res[2]["householder"][name]["call_s"],
            "span_s_party1": {k: spans.get(k, 0.0) for k in HH_SPANS},
            "other_span_s_party1": {k: v for k, v in spans.items() if k not in HH_SPANS},
            "launches": hh_launches[name],
            "checks": {pid: dict(householder_check(res[pid]["householder"][name]["Q"], a),
                                 levels=res[pid]["householder"][name]["levels"],
                                 ncols=res[pid]["householder"][name]["ncols"])
                       for pid in (1, 2)},
        }
    _say(f"qr phase, householder: {json.dumps(hh_line)}")
    for name, h in hh_line.items():
        for pid, c in h["checks"].items():
            if (not c["finite"] or not c["ortho_err"] <= HH_TOL or not c["qr_err"] <= HH_TOL
                    or c["ncols"] != h["columns"]):
                raise AssertionError(f"householder {name}, party {pid}: {c}")
        missing = [k for k in QR_PATH if h["launches"][k] == 0]
        if missing:
            raise AssertionError(f"kernels not launched by the householder QR ({name}): "
                                 f"{missing}")
    for name in hh_inputs:
        hk1_shapes, hk1_total, hh_tree, equal_only = _collective_kernel_checks(
            torch, state["hh_rec"].pop(name), hh_launches[name], params, kernels,
            f"qr_householder_{name}", new_only=True, timed_per_kernel=HH_TIMED_SHAPES)
        for key, found in hh_tree.items():
            tree_shapes[key] += [x for x in found if x not in tree_shapes[key]]
        hh_line[name].update(k1_new_shapes_timed_total_ms=hk1_total, k1_shapes=hk1_shapes,
                             compared_without_timing=equal_only)
    line["householder"] = hh_line
    return line


# ---------------------------------------------------------------------------
# 9. the linear association phase

ASSOC_PATH = ("ntt_fwd", "ntt_inv", "mac_dense", "ks_digit_product", "uniform_mod", "bs_mask",
              "bs_combine", "crt_lift")
# config/configGlobal.toml: maf_lb, hwe_ub, gmiss, imiss_ub, het_lb, het_ub
ASSOC_FILTER = (0.1, 28.374, 0.1, 0.05, 0.2, 0.5)
ASSOC_STAT_TOL = 2e-2  # tests/test_e2e_gwas.py:159-162
ASSOC_MIN_CORR = 0.999
# the example's SNP axis (99,336 SNPs in 22 blocks), cut to 1 of its blocks in phase 9
EXAMPLE_SNPS = 99_336


def _assoc_data(seed: int, n_loc: int, m_block: int, nblocks: int, ncov: int = 5):
    """The phase's data from the seed, per data party: genotypes [n_loc,
    nblocks * m_block] in {0, 1, 2} with about 1% missing (-1), each SNP's
    minor allele frequency uniform in [0.02, 0.5]; 5 covariates at phase
    8's column scales; a phenotype with 5 planted effects on the dosages
    (missing read as 0)."""
    rng = np.random.default_rng(seed + 4)
    m = nblocks * m_block
    maf = rng.uniform(0.02, 0.5, size=m)
    planted = rng.choice(m, 5, replace=False)
    out = {}
    for pid in (1, 2):
        g = rng.binomial(2, maf[None, :], size=(n_loc, m)).astype(np.int8)
        g[rng.uniform(size=(n_loc, m)) < 0.01] = -1
        cov = rng.normal(size=(n_loc, ncov)) * np.array([1.0, 20.0, 0.1, 50.0, 0.3])[:ncov]
        pheno = rng.normal(size=n_loc) + 0.3 * np.maximum(g[:, planted], 0).sum(1)
        out[pid] = (g, pheno, cov)
    return out


def _count_file(g: np.ndarray, path: str):
    """plink2's --geno-counts layout as the reference reads it
    (read_geno_stats_file): 6 x m little-endian uint32 rows of hom-ref,
    het and hom-alt counts, two rows the reader derives itself (zeros
    here), and the missing count."""
    raw = np.zeros((6, g.shape[1]), "<u4")
    for k in range(3):
        raw[k] = (g == k).sum(0)
    raw[5] = (g < 0).sum(0)
    raw.tofile(path)


def assoc_qc_oracle(data, fp, n_loc: int) -> np.ndarray:
    """Plaintext mirror of snp_filter_with_precomputed_stats over the pooled
    counts: missingness, then MAF in exact integers (the protocol's 20-bit
    bound) and the HWE chi-square in floats."""
    maf_lower, hwe_upper, geno_miss = fp[:3]
    g = np.concatenate([data[1][0], data[2][0]])
    nonmiss = (g >= 0).sum(0)
    keep = nonmiss >= int((1 - geno_miss) * 2 * n_loc)
    gobs = np.stack([(g == k).sum(0) for k in range(3)]).astype(np.float64)
    s = gobs[1] + 2 * gobs[2]
    c = 2 * nonmiss
    bound = int(round(((2 * maf_lower - 1.0) ** 2) * (1 << 20)))
    maf_ok = np.array([int(ci) ** 2 * bound - (2 * int(si) - int(ci)) ** 2 * (1 << 20) > 0
                       for si, ci in zip(s, c)])
    a, b = s, c.astype(np.float64)
    exp = [(b - a) ** 2, 2 * a * (b - a), a ** 2]
    chi = sum((2 * b * gobs[i] - exp[i]) ** 2 / exp[i] for i in range(3))
    return keep & maf_ok & (chi < 2 * b * hwe_upper)


def assoc_stat_oracle(data, keep: np.ndarray, pcs=None) -> np.ndarray:
    """tests/test_e2e_gwas.py's oracle: each kept SNP's Pearson statistic
    against the phenotype, both projected off [ones | covariates] (and the
    columns of pcs where given; missing dosages read as 0)."""
    G = np.concatenate([data[1][0], data[2][0]])[:, keep].astype(np.float64)
    G[G < 0] = 0.0
    y = np.concatenate([data[1][1], data[2][1]])
    C = np.concatenate([data[1][2], data[2][2]])
    cols = [np.ones(len(y)), C] + ([] if pcs is None else [pcs])
    Qm, _ = np.linalg.qr(np.column_stack(cols))
    yt = y - Qm @ (Qm.T @ y)
    Gt = G - Qm @ (Qm.T @ G)
    return (yt @ G) / np.sqrt((Gt * Gt).sum(0)) / np.sqrt(yt @ yt)


def _k2_recorder(rec: "_Recorder"):
    """Adds K2 (mac_dense, which its caller passes mu and logn by keyword)
    to a recorder: the first launch's inputs at each shape, and the
    launches at each."""
    from sfgwas_tpu_torch.gwas import matmult as MM

    rec.args["mac_dense"] = {}

    def make(real):
        def wrapped(ACC0, ACC1, R0, R1, polys, runs, q, mu, logn):
            key = (runs.nruns, int(runs.run_start_host[-1]), tuple(R0.shape), ACC0.shape[0])
            with rec._lock:
                rec.args["mac_dense"].setdefault(key, (R0, R1, polys, runs, q, mu, logn))
                rec.counts[("mac_dense", key)] += 1
            return real(ACC0, ACC1, R0, R1, polys, runs, q, mu=mu, logn=logn)

        return wrapped

    rec.real["mac_dense"] = rec.patch(MM, "mac_dense", make)


def _assoc_parties(torch, seed: int, out_dir: str, n_loc: int = 1000, m_block: int = 4546,
                   nblocks: int = 2, preset: str = "PN14QP438", device=None):
    """The association phase's protocol, phases 1 and 3 of
    sfgwas_tpu/gwas/protocol.py driven by hand: three parties (dealer 0,
    data parties 1 and 2, hub 1) through the port's run_parties (256-bit
    field, 60 data bits, 30 fraction bits, boolean shares, native engine)
    under collective keys at `preset` (default shift set, relinearisation
    key).  Each data party holds n_loc individuals, 5 covariates and
    nblocks genotype files of m_block SNPs with their plink2 count file,
    made from the seed in a temporary directory.  QC from the counts
    (snp_filter_with_precomputed_stats), the column filters on the blocks'
    streams with missing read as 0, then get_association_stats (one
    prefetch thread) runs twice: once under torch.profiler over all threads
    with the plain-torch programs labelled (it also warms up, and its peak
    device memory is read), then timed, with every launch count set to 0
    just before and read right after it, the kernels' inputs recorded at
    their wrappers and party 1's spans synchronized; the timed statistics
    are decrypted collectively.  Returns the parties' results, the state
    party 1 kept and the data.  device=None is the card; device="cpu"
    rehearses the protocol (at a small preset and size)."""
    import shutil
    import tempfile

    from sfgwas_tpu_torch.gwas import filestream as FS
    from sfgwas_tpu_torch.gwas.assoc import get_association_stats
    from sfgwas_tpu_torch.gwas.params import FilterParams
    from sfgwas_tpu_torch.gwas.qc import snp_filter_with_precomputed_stats
    from sfgwas_tpu_torch.mpc import mhe as PM
    from sfgwas_tpu_torch.ops import cuda_build
    from sfgwas_tpu_torch.parallel.simulate import run_parties
    from sfgwas_tpu_torch.utils import prof

    ncov, m = 5, nblocks * m_block
    data = _assoc_data(seed, n_loc, m_block, nblocks, ncov)
    nrows_all = [0, n_loc, n_loc]
    fp = FilterParams(*ASSOC_FILTER)
    gate = threading.Barrier(3)
    cuda = device is None or torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    state: dict = {}
    tmp = tempfile.mkdtemp(prefix="sfgwas_assoc_")
    try:
        for pid in (1, 2):
            g = data[pid][0]
            for b in range(nblocks):
                FS.write_geno_file(os.path.join(tmp, f"p{pid}_geno.{b}.bin"),
                                   g[:, b * m_block : (b + 1) * m_block])
            _count_file(g, os.path.join(tmp, f"p{pid}_gcount.bin"))

        def blocks(pid, keep):
            """The phase-3 view: each block's stream column-filtered by the
            QC filter, missing read as 0, lazy."""
            out = []
            for b in range(nblocks):
                st = FS.GenoFileStream(os.path.join(tmp, f"p{pid}_geno.{b}.bin"), n_loc, m_block,
                                       replace_missing=False)
                st.update_col_filt(keep[b * m_block : (b + 1) * m_block])
                st.replace_missing = True
                if st.num_cols_to_keep() > 0:
                    out.append(FS.LazyBlock(st))
            return out

        def party(mpc):
            pid = mpc.pid
            t0 = time.time()
            cps = PM.collective_init(mpc.net, preset, device=device)
            sync()
            out: dict = {"keygen_s": time.time() - t0, "rot_keys": len(cps.rot_keys)}
            gate.wait(timeout=900)
            if pid == 1:
                prof.ENABLED, prof.SYNC = True, (torch.cuda.synchronize if cuda else None)
            gate.wait(timeout=900)
            prof.reset()
            t0 = time.time()
            with prof.span("qc"):
                if pid > 0:
                    ac, gc, miss = FS.read_geno_stats_file(
                        os.path.join(tmp, f"p{pid}_gcount.bin"), m)
                else:
                    ac, gc, miss = np.zeros((2, m)), np.zeros((3, m)), np.zeros(m)
                keep = snp_filter_with_precomputed_stats(
                    mpc, ac, gc, miss, n_loc if pid > 0 else 0, 2 * n_loc, fp)
            out["qc_s"] = time.time() - t0
            out["qc_spans"] = prof.totals()
            if pid > 0:
                out["keep"] = keep
            gate.wait(timeout=900)
            if pid == 1:
                prof.ENABLED, prof.SYNC = False, None

            def call():
                if pid > 0:
                    g, pheno, cov = data[pid]
                    return get_association_stats(mpc, cps, blocks(pid, keep), pheno, cov, None,
                                                 nrows_all, num_blocks_parallel=1)
                return get_association_stats(mpc, cps, None, None, ncov, None, nrows_all)

            # the traced call (also the warm-up)
            gate.wait(timeout=900)
            if pid == 1 and cuda:
                def traced():
                    gate.wait(timeout=900)
                    t0 = time.time()
                    call()
                    out["traced_call_s"] = time.time() - t0
                    gate.wait(timeout=900)

                torch.cuda.reset_peak_memory_stats()
                with _Labelled(torch):
                    out["profile"] = _profile(
                        torch, traced, os.path.join(out_dir, "assoc_profile.txt"),
                        all_threads=True, labels=[p[2] for p in PLAIN_PROGRAMS])
                out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
            else:
                gate.wait(timeout=900)
                call()
                gate.wait(timeout=900)
            sync()
            # the timed call
            gate.wait(timeout=900)
            if pid == 1:
                state["rec"] = _collective_recorder(k3=True)
                _k2_recorder(state["rec"])
                cuda_build.reset_launch_counts()
                prof.ENABLED, prof.SYNC = True, (torch.cuda.synchronize if cuda else None)
            gate.wait(timeout=900)
            prof.reset()
            t0 = time.time()
            stats, filt = call()
            sync()
            out["call_s"] = time.time() - t0
            gate.wait(timeout=900)
            if pid == 1:
                state["launches"] = {k: v.launches for k, v in cuda_build.REGISTRY.items()}
                state["rec"].restore()
            gate.wait(timeout=900)
            if pid > 0:
                with prof.span("decrypt"):
                    pts = PM.collective_decrypt_many(mpc.net, cps, stats, -1)
                    vals = np.concatenate([cps.ctx.decode(pt) for pt in pts])
                out["stats"] = vals[: len(filt)][filt]
                out["filter"] = filt
                out["levels"] = sorted({(ct.nmod, ct.scale) for ct in stats})
            out["spans"] = prof.totals()
            gate.wait(timeout=900)
            if pid == 1:
                prof.ENABLED, prof.SYNC = False, None
            return out

        try:
            res = run_parties(3, party, timeout=1500)
        finally:
            prof.ENABLED, prof.SYNC = False, None
            if "rec" in state:
                state["rec"].restore()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res, state, data


def assoc_check(res, data, n_loc: int) -> dict:
    """The revealed SNP filter against the plaintext QC oracle (exactly) and
    the statistics against the plaintext oracle at each data party."""
    want_keep = assoc_qc_oracle(data, ASSOC_FILTER, n_loc)
    want = assoc_stat_oracle(data, want_keep)
    out = {"snps": int(len(want_keep)), "kept": int(want_keep.sum())}
    for pid in (1, 2):
        r = res[pid]
        got = r["stats"]
        same_keep = bool(np.array_equal(r["keep"], want_keep))
        ok_shape = got.shape == want.shape
        out[pid] = {
            "filter_equal": same_keep, "finite": bool(np.isfinite(got).all()),
            "max_abs_err": float(np.abs(got - want).max()) if ok_shape else None,
            "corr": float(np.corrcoef(got, want)[0, 1]) if ok_shape else None,
            "stats": int(got.size), "levels": r["levels"],
        }
    return out


def assoc_phase(torch, seed: int, out_dir: str, kernels: list) -> dict:
    """Phase 9: the linear association phase (QC from precomputed counts,
    then get_association_stats with the std inverse) at PN14QP438 for three
    parties on the card at the example's block size, then every kernel of
    the timed call against its plain version at every shape it launched it
    with.  Appends the kernels' records to `kernels`; returns the phase's
    record."""
    from sfgwas_tpu_torch.crypto.params import get_params
    from sfgwas_tpu_torch.gwas import matmult as MM

    params = get_params("PN14QP438")
    n_loc, m_block, nblocks = 1000, 4546, 1
    t0 = time.time()
    res, state, data = _assoc_parties(torch, seed, out_dir, n_loc, m_block, nblocks)
    t_calls = time.time() - t0
    rec, launches = state["rec"], state["launches"]
    hub = res[1]
    checks = assoc_check(res, data, n_loc)
    # seconds, synchronized: QC's, then the timed call's and the decrypt's
    spans = {k: v[0] for k, v in {**hub["qc_spans"], **hub["spans"]}.items()}
    profiled = hub["profile"]
    keep = assoc_qc_oracle(data, ASSOC_FILTER, n_loc)
    nkept_blocks = sum(1 for b in range(nblocks) if keep[b * m_block : (b + 1) * m_block].any())
    line = {
        "individuals": [0, n_loc, n_loc], "covariates": 5, "blocks": nblocks,
        "block_snps": m_block, "checks": checks,
        "reduced": {"snps": [EXAMPLE_SNPS, nblocks * m_block],
                    "why": "time: one block's host encode takes seconds, and phase 7 holds the "
                           "std inverse at the example's n"},
        "keygen_s": hub["keygen_s"], "rotation_keys": hub["rot_keys"],
        "qc_s_party1": hub["qc_s"], "call_s_party1": hub["call_s"],
        "call_s_party2": res[2]["call_s"], "traced_call_s_party1": hub["traced_call_s"],
        "span_s_party1": spans, "peak_mem_bytes": hub["peak_mem_bytes"],
        "device_busy_ms": profiled["device_busy_ms"], "window_ms": profiled["window_ms"],
        "idle_share": profiled["idle_share"], "host_readbacks": profiled["host_readbacks"],
        "device_to_host_copies": profiled["dtoh_copies"],
        "port_kernel_ms": profiled["port_kernel_ms"], "labelled_ms": profiled["labelled_ms"],
        "host_cpu": f"{_cpu_model()}, {os.cpu_count()} logical cores",
    }
    _say(f"assoc phase: {json.dumps(line)}")
    _say(f"launches: assoc path {json.dumps(launches)}")
    for pid in (1, 2):
        c = checks[pid]
        if not c["filter_equal"]:
            raise AssertionError(f"party {pid}: the revealed SNP filter differs from the oracle")
        if (not c["finite"] or c["max_abs_err"] is None or not c["max_abs_err"] <= ASSOC_STAT_TOL
                or not c["corr"] > ASSOC_MIN_CORR):
            raise AssertionError(f"party {pid}: statistics off: max abs err {c['max_abs_err']}, "
                                 f"corr {c['corr']}, finite {c['finite']}")
    missing = [k for k in ASSOC_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the assoc path: {missing}")
    # one block row a block: K2 once per kept block at each data party
    if launches["mac_dense"] != 2 * nkept_blocks:
        raise AssertionError(f"K2 launched {launches['mac_dense']} times for {nkept_blocks} "
                             "blocks at 2 data parties")
    if profiled["host_readbacks"]:
        raise AssertionError(f"the assoc call read {profiled['host_readbacks']} device values "
                             "back to the host")
    if profiled["host_threads"] < 2:
        raise AssertionError("the assoc profile traced one thread")
    # K2 at every recorded shape (each record freed once checked), then the
    # collective kernels
    k2 = rec.args.pop("mac_dense")
    for key in sorted(k2):
        _k2_check(torch, MM, kernels, f"mac_dense (assoc) {list(key[:2])}", rec.real["mac_dense"],
                  *k2.pop(key), key[3])
        kernels[-1].update(launches=launches["mac_dense"], path="assoc",
                           launches_at_shape=rec.counts[("mac_dense", key)])
        torch.cuda.empty_cache()
    k1_shapes, k1_total, tree_shapes, _ = _collective_kernel_checks(
        torch, rec, launches, params, kernels, "assoc")
    line.update(launches=launches, profile=profiled, k1_total_ms=k1_total, k1_shapes=k1_shapes,
                tree_shapes=tree_shapes, phase_s=time.time() - t0, calls_s=t_calls)
    return line


# ---------------------------------------------------------------------------
# 10. the study through the CLI

# config/configGlobal.toml's SNP axis: 100,000 SNPs in 22 blocks, 21 of 4,546
STUDY_BLOCKS = [4546] * 21 + [4534]
# phase 10's cut of that axis: its first block (cut from 2 when the whole
# script took 1,103 s of its 1,200 on an H100); phase 11's: its first
# block (cut from 2 to make room for phase 8's and 14's Householder QRs)
STUDY_LOCAL_BLOCKS = STUDY_BLOCKS[:1]
TCP_BLOCKS = STUDY_BLOCKS[:1]
STUDY_RESUME_TOL = 2e-3  # tests/test_e2e_gwas.py:222
# the configuration's flags: the preset, the thresholds, the QC route and the caches
STUDY_CONFIG = "config/configGlobalSkipPCA.toml"
# phase 14's run: the Householder basis on phase 10's key and QC caches
HOUSEHOLDER_FLAGS = {"qr_method": "householder", "use_cached_keys": True, "use_cached_qc": True,
                     "use_cached_combined_q": False}
HOUSEHOLDER_TOL = 1e-3  # phase 14's statistics against phase 10's run 1 (cholqr2)


class _StdoutLines:
    """Tees sys.stdout, keeping the lines written while installed (the
    protocol prints its phase times there from the party threads)."""

    def __init__(self):
        self.real, self.buf, self._lock = sys.stdout, [], threading.Lock()

    def write(self, s):
        with self._lock:
            self.buf.append(s)
        return self.real.write(s)

    def flush(self):
        self.real.flush()

    def __enter__(self):
        sys.stdout = self
        return self

    def __exit__(self, *exc):
        sys.stdout = self.real

    def lines(self):
        return "".join(self.buf).splitlines()


class _RssPeak:
    """Samples this process's resident set every 0.2 s while installed."""

    def __init__(self):
        self.peak, self._stop = 0, threading.Event()

    def _rss(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _run(self):
        while True:
            self.peak = max(self.peak, self._rss())
            if self._stop.wait(0.2):
                return

    def __enter__(self):
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join(timeout=5)
        self.peak = max(self.peak, self._rss())


def _protocol_times(lines, pid: int) -> dict:
    """qc / pca / assoc seconds from the protocol's own line of party pid."""
    pat = re.compile(rf"\[pid {pid}\] GWAS protocol finished in ([\d.]+)s "
                     r"\(qc ([\d.]+)s, pca ([\d.]+)s, assoc ([\d.]+)s\)")
    for ln in lines:
        m = pat.search(ln)
        if m:
            return dict(zip(("total_s", "qc_s", "pca_s", "assoc_s"), map(float, m.groups())))
    raise AssertionError(f"no protocol line of party {pid}")


def _study_files(root: str, seed: int, n_loc: int, sizes, cfg_src: str, overrides: dict,
                 pca_snps=None, logistic: bool = False) -> tuple:
    """The study's files from the seed under root: per data party the
    genotype blocks geno.{i}.bin, blocksizes.txt, pheno.txt, cov.txt,
    pos.txt and plink2's count file (phase 9's generators over the whole
    SNP axis, 1,000 bp apart; with pca_snps, phase 12's: _pca_data, and
    positions that LD pruning thins to pca_snps; with logistic, phase 13's
    binary phenotype: _logistic_data), and a global config of cfg_src's
    flags (with overrides) and the paths in {pid} form.  Returns (the data,
    the config's path)."""
    import tomllib

    from sfgwas_tpu_torch.gwas import filestream as FS

    m = sum(sizes)
    if pca_snps:
        data = _pca_data(seed, n_loc, m)
        pos = _pca_positions(assoc_qc_oracle(data, ASSOC_FILTER, n_loc), pca_snps)
    elif logistic:
        data = _logistic_data(seed, n_loc, m)
        pos = np.arange(m) * 1000
    else:
        data = _assoc_data(seed, n_loc, m, 1)
        pos = np.arange(m) * 1000
    edges = np.cumsum([0] + list(sizes))
    for pid in (1, 2):
        g, pheno, cov = data[pid]
        d = os.path.join(root, f"party{pid}")
        os.makedirs(d)
        for b in range(len(sizes)):
            FS.write_geno_file(os.path.join(d, f"geno.{b}.bin"), g[:, edges[b] : edges[b + 1]])
        with open(os.path.join(d, "blocksizes.txt"), "w") as f:
            f.write("".join(f"{s}\n" for s in sizes))
        np.savetxt(os.path.join(d, "pheno.txt"), pheno)
        np.savetxt(os.path.join(d, "cov.txt"), cov)
        np.savetxt(os.path.join(d, "pos.txt"), pos, fmt="%d")
        _count_file(g, os.path.join(d, "gcount.bin"))
    with open(cfg_src, "rb") as f:
        cfg = {k: v for k, v in tomllib.load(f).items() if k != "servers"}
    cfg.update(overrides)
    if (cfg["num_inds"], cfg["num_snps"]) != ([0, n_loc, n_loc], m):
        raise AssertionError(f"{cfg_src}: {cfg['num_inds']} individuals, {cfg['num_snps']} SNPs")
    p = os.path.join(root, "party{pid}")
    cfg.update(
        geno_file_format="blocks", geno_binary_file_prefix=os.path.join(p, "geno"),
        geno_block_size_file=os.path.join(p, "blocksizes.txt"),
        pheno_file=os.path.join(p, "pheno.txt"), covar_file=os.path.join(p, "cov.txt"),
        snp_position_file=os.path.join(p, "pos.txt"),
        geno_count_file=os.path.join(p, "gcount.bin"),
        cache_dir=os.path.join(root, "cache"), output_dir=os.path.join(root, "out"),
    )
    path = os.path.join(root, "global.toml")
    with open(path, "w") as f:
        f.write("".join(f"{k} = {json.dumps(v)}\n" for k, v in cfg.items()))
    return data, path


def _study_hooks(torch, k2_inline: bool, keep_first: bool = True, keep_rows: bool = False,
                 pca_budget=None):
    """Wrappers for one CLI run: each party's collective_init timed with its
    bundle's keys_from_cache, each key-directory write timed, party 1's
    spans (prof on: the totals and each span as it ended), the calls of
    distributed_pca and the host chunks a host-streamed diagonal cache
    materialised on the device (calls, bytes of hi and lo copied), the
    products that took the sharded branch (a plan's groups() asked for
    shard devices), and with
    k2_inline every K2 launch held against its plain version on the same
    inputs right after it (bit equality, launches counted per row count of
    the product; with keep_first, the first launch's inputs are kept for the
    timed record, with keep_rows too the first launch's at each row
    count).  pca_budget, where given, is distributed_pca's device_budget."""
    from sfgwas_tpu_torch.gwas import matmult as MM
    from sfgwas_tpu_torch.gwas import pca as PP
    from sfgwas_tpu_torch.gwas import protocol as GP
    from sfgwas_tpu_torch.mpc import mhe as PM
    from sfgwas_tpu_torch.utils import prof

    hooks = _Patches()
    got = {"init": {}, "save_s": [], "spans": None, "pca_calls": 0, "sharded_products": 0,
           "streamed": {"calls": 0, "rows": 0, "h2d_bytes": 0},
           "k2": {"launches": 0, "equal": 0, "check_s": 0.0, "first": None, "by_rows": {},
                  "launches_by_rows": collections.Counter()}}
    lock = threading.Lock()

    def pca(real):
        def wrapped(*a, **k):
            with lock:
                got["pca_calls"] += 1
            if pca_budget is not None:
                k["device_budget"] = pca_budget
            return real(*a, **k)
        return wrapped

    def sharded(real):
        def wrapped(self, devices=None):
            if devices:
                with lock:
                    got["sharded_products"] += 1
            return real(self, devices)
        return wrapped

    def materialize(real):
        def wrapped(self, cps, nmod, a, b):
            step = 1024  # the host encode's chunk of diagonals
            sub = self.chunks[a // step : -(-b // step)]
            with lock:
                st = got["streamed"]
                st["calls"] += 1
                st["rows"] += b - a
                st["h2d_bytes"] += sum(hi.nbytes + lo.nbytes for hi, lo, _ in sub)
            return real(self, cps, nmod, a, b)
        return wrapped

    def init(real):
        def wrapped(net, *a, **k):
            t0 = time.time()
            cps = real(net, *a, **k)
            if cps.ctx.device.type == "cuda":
                torch.cuda.synchronize()
            with lock:
                got["init"][net.pid] = {"s": time.time() - t0,
                                        "keys_from_cache": cps.keys_from_cache}
            return cps
        return wrapped

    def save(real):
        def wrapped(*a):
            t0 = time.time()
            real(*a)
            with lock:
                got["save_s"].append(time.time() - t0)
        return wrapped

    def gwas(real):
        def wrapped(self):
            prof.reset()
            try:
                return real(self)
            finally:
                if self.pid == 1:
                    got["spans"] = {k: v[0] for k, v in prof.totals().items()}
                    got["events"] = prof.events()
        return wrapped

    def mac(real):
        def wrapped(ACC0, ACC1, R0, R1, polys, runs, q, mu, logn):
            a0, a1 = ACC0.clone(), ACC1.clone()
            out = real(ACC0, ACC1, R0, R1, polys, runs, q, mu=mu, logn=logn)
            t0 = time.time()
            MM.mac_dense_plain(a0, a1, R0, R1, polys, runs, q)
            eq = bool(torch.equal(a0, ACC0) and torch.equal(a1, ACC1))
            del a0, a1
            with lock:
                k2 = got["k2"]
                k2["launches"] += 1
                k2["equal"] += eq
                k2["check_s"] += time.time() - t0
                rows = int(R0.shape[1])
                k2["launches_by_rows"][rows] += 1
                kept = (R0, R1, polys, runs, q, mu, logn, ACC0.shape[0])
                if keep_first and k2["first"] is None:
                    k2["first"] = kept
                if keep_rows and rows not in k2["by_rows"]:
                    k2["by_rows"][rows] = kept
            return out
        return wrapped

    hooks.patch(PM, "collective_init", init)
    hooks.patch(PM, "_save_key_dir", save)
    hooks.patch(GP.ProtocolInfo, "gwas", gwas)
    hooks.patch(PP, "distributed_pca", pca)
    hooks.patch(MM.DiagBlock, "materialize_rows", materialize)
    hooks.patch(MM._MatmulPlan, "groups", sharded)
    if k2_inline:
        got["real_mac"] = hooks.patch(MM, "mac_dense", mac)
    return hooks, got


def _study_runs(torch, seed: int, out_dir: str, n_loc: int, sizes, cfg_src: str,
                platform=None, overrides=None, pca_snps=None, resume_flags=None,
                logistic: bool = False, householder: bool = False, routed: bool = False,
                pca_budget=None):
    """The study's two CLI runs (cli.main with --local-sim 3, and with
    --platform only where given; platform=None is the card): the files and
    config from the seed in a temporary directory (removed at the end),
    run 1 fresh with every launch count set to 0 before it and read after
    it (K2 held against its plain version at every launch, the other
    kernels recorded at their wrappers), run 2 resumed from run 1's caches
    (with resume_flags added to the config).  Party 1's assoc.txt of each
    run is copied to out_dir.  overrides replaces config fields (a CPU
    rehearsal's preset and sizes).  pca_snps makes phase 12's study (its
    data, LD pruning to about that many SNPs, the spans synchronized on
    the card, each run's decrypted PCs read back); logistic makes phase
    13's (its data, one fresh run and no resumed one: the logistic phase
    keeps no cache of its own; the spans synchronized on the card).
    householder adds phase 14's run after the resumed one: the config with
    qr_method = "householder" and use_cached_combined_q = false on run 1's
    key and QC caches, its basis and block-product caches removed first
    (checked as run 1 is, the spans synchronized on the card).  routed adds
    phase 15's run after that: the resumed config with run 1's key, QC and
    basis caches (the basis saved before the householder run and put back),
    the block products computed again, and every product routed over two
    logical shards of the party's device (the config with shard_matmult =
    true, the protocol's local_devices giving the two shards; the routing
    reset after; checked as run 1 is), then its unsharded twin ("twin":
    the same caches and config without shard_matmult); both draw phase
    3's masks from the same seeds (_seeded_phase3).  Returns (the data, each
    run's record)."""
    import shutil
    import tempfile

    from sfgwas_tpu_torch import cli
    from sfgwas_tpu_torch.gwas import matmult as MM
    from sfgwas_tpu_torch.gwas import protocol as GP
    from sfgwas_tpu_torch.ops import cuda_build
    from sfgwas_tpu_torch.utils import prof

    cuda = platform is None
    shards = [torch.device("cuda", 0) if cuda else torch.device(platform)] * SHARD_DEVICES
    tag = "pca_" if pca_snps else "logistic_" if logistic else ""
    tmp = tempfile.mkdtemp(prefix="sfgwas_study_")
    runs: dict = {}
    try:
        t0 = time.time()
        data, cfg = _study_files(tmp, seed, n_loc, sizes, cfg_src, overrides or {}, pca_snps,
                                 logistic)
        data_s = time.time() - t0
        cfgs = {"fresh": cfg, "resumed": cfg}
        if resume_flags:
            cfgs["resumed"] = os.path.join(tmp, "resumed.toml")
            with open(cfg) as f, open(cfgs["resumed"], "w") as g:
                g.write(f.read() + "".join(f"{k} = {json.dumps(v)}\n"
                                           for k, v in resume_flags.items()))
        if householder:
            import tomllib

            with open(cfg, "rb") as f:
                hh_cfg = tomllib.load(f)
            hh_cfg.update(HOUSEHOLDER_FLAGS)
            cfgs["householder"] = os.path.join(tmp, "householder.toml")
            with open(cfgs["householder"], "w") as f:
                f.write("".join(f"{k} = {json.dumps(v)}\n" for k, v in hh_cfg.items()))
        if routed:
            cfgs["routed"] = os.path.join(tmp, "routed.toml")
            with open(cfgs["resumed"]) as f, open(cfgs["routed"], "w") as g:
                g.write(f.read() + "shard_matmult = true\n")
            cfgs["twin"] = cfgs["resumed"]
        names = ("fresh",) if logistic else ("fresh", "resumed")
        names += ("householder",) if householder else ()
        names += ("routed", "twin") if routed else ()
        saved = os.path.join(tmp, "saved_basis")
        for name in names:
            checked = name in ("fresh", "householder", "routed")
            if name in ("householder", "routed", "twin"):
                # the block products (assoc_assoc_*) are computed again, and
                # for householder the basis (assoc_Qcomb.*) too; the keys and
                # QC resume.  run 1's basis is kept aside for the routed run
                for pid in (0, 1, 2):
                    d = os.path.join(tmp, "cache", f"party{pid}")
                    keep = os.path.join(saved, f"party{pid}")
                    if not os.path.isdir(keep):  # run 1's basis and block products
                        os.makedirs(os.path.join(keep, "products"))
                        for fn in os.listdir(d):
                            if fn.startswith("assoc_Qcomb"):
                                shutil.copy(os.path.join(d, fn), keep)
                            elif fn.startswith("assoc_assoc_"):
                                shutil.copy(os.path.join(d, fn), os.path.join(keep, "products"))
                    for fn in os.listdir(d):
                        if fn.startswith("assoc_"):
                            os.remove(os.path.join(d, fn))
                    if name in ("routed", "twin"):
                        for fn in os.listdir(keep):
                            if fn.startswith("assoc_Qcomb"):
                                shutil.copy(os.path.join(keep, fn), d)
            argv = ["--local-sim", "3", "--config-global", cfgs[name]]
            if platform is not None:
                argv += ["--platform", platform]
            hooks, got = _study_hooks(torch, k2_inline=checked, keep_rows=logistic,
                                      keep_first=name == "fresh", pca_budget=pca_budget)
            rec = _collective_recorder(k3=True) if checked else None
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            prof.ENABLED = True
            if cuda and (pca_snps or logistic or name in ("householder", "routed", "twin")):
                prof.SYNC = torch.cuda.synchronize
            if name == "routed":
                # the party's local devices, as shard_matmult reads them
                hooks.patch(GP, "local_devices", lambda real: lambda kind: list(shards))
            if name in ("routed", "twin"):
                # the same masks in both: their statistics must be the same bits
                hooks.patch(GP.ProtocolInfo, "phase3", _seeded_phase3(seed))
            cuda_build.reset_launch_counts()
            try:
                with _StdoutLines() as lines, _RssPeak() as rss:
                    t0 = time.time()
                    if cli.main(argv) != 0:
                        raise AssertionError(f"the {name} run exited nonzero")
                    if cuda:
                        torch.cuda.synchronize()
                    cmd_s = time.time() - t0
                launches = {k: v.launches for k, v in cuda_build.REGISTRY.items()}
            finally:
                MM.set_pipeline_devices(None)
                prof.ENABLED = False
                prof.SYNC = None
                hooks.restore()
                if rec is not None:
                    rec.restore()
            out = {pid: np.loadtxt(os.path.join(tmp, "out", f"party{pid}", "assoc.txt"))
                   for pid in (1, 2)}
            keep = {pid: np.loadtxt(os.path.join(tmp, "cache", f"party{pid}", "gkeep.txt"))
                    .astype(bool) for pid in (1, 2)}
            shutil.copy(os.path.join(tmp, "out", "party1", "assoc.txt"),
                        os.path.join(out_dir, f"assoc_{tag}{name}.txt" if not logistic
                                     else "assoc_logistic.txt"))
            runs[name] = dict(
                command_s=cmd_s, data_s=data_s,
                protocol_party1=_protocol_times(lines.lines(), 1),
                protocol_party2=_protocol_times(lines.lines(), 2),
                init_s={p: v["s"] for p, v in got["init"].items()},
                keys_from_cache={p: v["keys_from_cache"] for p, v in got["init"].items()},
                key_dir_write_s=got["save_s"], spans_party1_host_clock=got["spans"],
                events_party1=got.get("events"),
                peak_device_bytes=torch.cuda.max_memory_allocated() if cuda else None,
                peak_host_rss_bytes=rss.peak, launches=launches, stats=out, keep=keep, rec=rec,
                k2=got["k2"], real_mac=got.get("real_mac"), pca_calls=got["pca_calls"],
                streamed=got["streamed"], sharded_products=got["sharded_products"],
            )
            if name == "routed":
                runs[name]["products_vs_run1"] = _products_vs_kept(tmp, saved)
            if pca_snps:
                runs[name]["qpc"] = np.concatenate([
                    np.loadtxt(os.path.join(tmp, "cache", f"party{pid}", "Qpc.txt"),
                               delimiter=",", ndmin=2).T for pid in (1, 2)])
            _say(f"study {name}: {cmd_s:.1f} s of command, party 1 "
                 f"{json.dumps(runs[name]['protocol_party1'])}, init "
                 f"{json.dumps(runs[name]['init_s'])}, launches {json.dumps(launches)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return data, runs


def _seeded_phase3(seed: int):
    """A wrapper of ProtocolInfo.phase3 that seeds each party's local PRG
    streams and its encryption generator from `seed` and the party's pid
    as phase 3 starts, so that two runs from the same caches draw the same
    masks and noise."""
    def make(real):
        def seeded(self, qpc):
            table = self.net.rand.table
            for k in table:  # the global stream, each pair's, the party's own
                a, b = (-1, -1) if k < 0 else sorted((k, self.pid))
                table[k] = np.random.Generator(
                    np.random.Philox(key=[seed + 1, 100 * (a + 2) + b + 2]))
            self.cps.enc_rng = np.random.default_rng([seed + 1, self.pid])
            return real(self, qpc)
        return seeded
    return make


def _products_vs_kept(tmp: str, saved: str) -> dict:
    """Each data party's block products of the last run (its assoc_assoc_*
    caches: the rows of the basis, then the y~ row) against run 1's kept
    copies, bit for bit."""
    out = {}
    for pid in (1, 2):
        d = os.path.join(tmp, "cache", f"party{pid}")
        kept = os.path.join(saved, f"party{pid}", "products")
        names = sorted(os.listdir(kept))
        basis = y_row = bool(names)
        for fn in names:
            with np.load(os.path.join(d, fn)) as a, np.load(os.path.join(kept, fn)) as b:
                rows, cols = int(b["rows"]), int(b["cols"])
                for i in range(rows):
                    same = all(np.array_equal(a[f"{c}_{i}_{j}"], b[f"{c}_{i}_{j}"])
                               for j in range(cols) for c in ("c0", "c1", "m"))
                    if i < rows - 1:
                        basis &= same
                    else:
                        y_row &= same
        out[pid] = {"blocks": len(names), "basis_rows_equal": basis, "y_row_equal": y_row}
    return out


def study_check(data, runs, n_loc: int, sizes) -> dict:
    """The revealed filters against the plaintext QC oracle, the fresh
    run's statistics against the plaintext oracle, the resumed run's
    against the fresh run's."""
    fresh, resumed = runs["fresh"], runs["resumed"]
    want_keep = assoc_qc_oracle(data, ASSOC_FILTER, n_loc)
    want = assoc_stat_oracle(data, want_keep)
    edges = np.cumsum([0] + list(sizes))
    checks = {"snps": int(len(want_keep)), "kept": int(want_keep.sum()),
              "blocks_kept": sum(1 for b in range(len(sizes))
                                 if want_keep[edges[b] : edges[b + 1]].any())}
    for pid in (1, 2):
        got = fresh["stats"][pid]
        ok_shape = got.shape == want.shape
        checks[pid] = {
            "finite": bool(np.isfinite(got).all()),
            "max_abs_err": float(np.abs(got - want).max()) if ok_shape else None,
            "corr": float(np.corrcoef(got, want)[0, 1]) if ok_shape else None,
            "resumed_max_abs_diff": (float(np.abs(resumed["stats"][pid] - got).max())
                                     if resumed["stats"][pid].shape == got.shape else None),
        }
    # the data parties' revealed filters (the dealer's file of the counts
    # route holds no filter: it takes part in QC without the counts)
    for name, r in runs.items():
        checks[f"{name}_filter_equal"] = {p: bool(np.array_equal(r["keep"][p], want_keep))
                                          for p in (1, 2)}
    return checks


def study_phase(torch, seed: int, out_dir: str, kernels: list) -> dict:
    """Phase 10: the linear skip-PCA study through the CLI, cli.main with
    --local-sim 3 and no --platform (the card), at the example's width: 2 x
    1000 individuals, 5 covariates, config/configGlobalSkipPCA.toml's flags,
    and the first of its 22 SNP blocks (4,546 SNPs);
    run 1 fresh, run 2 resumed from its caches, then phase 14's and
    phase 15's runs (_study_runs).  Then K2
    timed at its first launch and every other kernel at each shape of run 1
    that no earlier phase checked.  Appends the kernels' records to
    `kernels`; returns the phase's record and phase 14's and 15's runs."""
    from sfgwas_tpu_torch.crypto.params import get_params
    from sfgwas_tpu_torch.gwas import matmult as MM

    params = get_params("PN14QP438")
    n_loc, sizes = 1000, STUDY_LOCAL_BLOCKS
    root = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.time()
    data, runs = _study_runs(torch, seed, out_dir, n_loc, sizes, os.path.join(root, STUDY_CONFIG),
                             overrides={"num_snps": int(sum(sizes))}, householder=True,
                             routed=True)
    hh = {"data": data, "run": runs.pop("householder"), "n_loc": n_loc, "sizes": sizes,
          "cholqr2_stats": runs["fresh"]["stats"]}
    rt = {"data": data, "run": runs.pop("routed"), "n_loc": n_loc, "sizes": sizes,
          "resumed_stats": runs["resumed"]["stats"], "twin": runs.pop("twin")}
    checks = study_check(data, runs, n_loc, sizes)
    fresh, resumed = runs["fresh"], runs["resumed"]
    k2 = fresh["k2"]
    line = {
        "individuals": [0, n_loc, n_loc], "covariates": 5, "snps": int(sum(sizes)),
        "blocks": len(sizes), "block_snps": sizes[0], "config": STUDY_CONFIG,
        "reduced": {"snps": [int(sum(STUDY_BLOCKS)), int(sum(sizes))],
                    "blocks": [len(STUDY_BLOCKS), len(sizes)],
                    "why": "time: the whole script runs within its 1,200 s"},
        "checks": checks, "data_s": fresh["data_s"],
        "k2_inline_checks": {k: k2[k] for k in ("launches", "equal", "check_s")},
        "host_cpu": f"{_cpu_model()}, {os.cpu_count()} logical cores",
    }
    for name, r in runs.items():
        line[name] = {k: r[k] for k in (
            "command_s", "protocol_party1", "protocol_party2", "init_s", "keys_from_cache",
            "key_dir_write_s", "spans_party1_host_clock", "peak_device_bytes",
            "peak_host_rss_bytes", "launches")}
    _say(f"study phase: {json.dumps(line)}")
    for name in runs:
        for pid, eq in checks[f"{name}_filter_equal"].items():
            if not eq:
                raise AssertionError(f"{name} run, party {pid}: the revealed SNP filter differs "
                                     "from the oracle")
    for pid in (1, 2):
        c = checks[pid]
        if (not c["finite"] or c["max_abs_err"] is None or not c["max_abs_err"] <= ASSOC_STAT_TOL
                or not c["corr"] > ASSOC_MIN_CORR):
            raise AssertionError(f"party {pid}: statistics off: max abs err {c['max_abs_err']}, "
                                 f"corr {c['corr']}, finite {c['finite']}")
        if c["resumed_max_abs_diff"] is None or not c["resumed_max_abs_diff"] < STUDY_RESUME_TOL:
            raise AssertionError(f"party {pid}: the resumed run is off the fresh one by "
                                 f"{c['resumed_max_abs_diff']}")
    missing = [k for k in ASSOC_PATH if fresh["launches"][k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the study's fresh run: {missing}")
    nblocks = checks["blocks_kept"]
    if nblocks != len(sizes) or fresh["launches"]["mac_dense"] != 2 * nblocks:
        raise AssertionError(f"K2 launched {fresh['launches']['mac_dense']} times for "
                             f"{nblocks} blocks at 2 data parties")
    if k2["launches"] != fresh["launches"]["mac_dense"] or k2["equal"] != k2["launches"]:
        raise AssertionError(f"K2 equal to its plain version at {k2['equal']} of "
                             f"{k2['launches']} launches")
    if resumed["launches"]["mac_dense"]:
        raise AssertionError(f"the resumed run launched K2 {resumed['launches']['mac_dense']} "
                             "times")
    if (any(fresh["keys_from_cache"].values()) or sorted(resumed["keys_from_cache"]) != [0, 1, 2]
            or not all(resumed["keys_from_cache"].values())):
        raise AssertionError(f"bundles from the key cache: fresh {fresh['keys_from_cache']}, "
                             f"resumed {resumed['keys_from_cache']}")
    if len(fresh["key_dir_write_s"]) != 3 or resumed["key_dir_write_s"]:
        raise AssertionError(f"key directories written: fresh {fresh['key_dir_write_s']}, "
                             f"resumed {resumed['key_dir_write_s']}")
    rec = fresh.pop("rec")
    del runs, resumed
    # K2 timed at the first launch's inputs, then the other kernels at the
    # fresh run's shapes that no earlier phase checked
    R0, R1, polys, mruns, q, mu, logn, nacc = k2.pop("first")
    _k2_check(torch, MM, kernels,
              f"mac_dense (study) {[mruns.nruns, int(mruns.run_start_host[-1])]}",
              fresh["real_mac"], R0, R1, polys, mruns, q, mu, logn, nacc)
    kernels[-1].update(launches=fresh["launches"]["mac_dense"], path="study",
                       launches_at_shape=1, inline_equal_launches=k2["equal"])
    del R0, R1, polys, mruns
    torch.cuda.empty_cache()
    k1_shapes, k1_total, tree_shapes, _ = _collective_kernel_checks(
        torch, rec, fresh["launches"], params, kernels, "study", new_only=True)
    del rec
    line.update(k1_new_shapes_total_ms=k1_total, k1_shapes=k1_shapes, tree_shapes=tree_shapes,
                phase_s=time.time() - t_phase)
    return line, hh, rt


def householder_study_check(hh: dict) -> dict:
    """Phase 14's filters against the QC oracle, its statistics against
    the plaintext oracle and against phase 10's run 1 (cholqr2, the same
    data and keys)."""
    data, run, n_loc = hh["data"], hh["run"], hh["n_loc"]
    want_keep = assoc_qc_oracle(data, ASSOC_FILTER, n_loc)
    want = assoc_stat_oracle(data, want_keep)
    checks = {"filter_equal": {p: bool(np.array_equal(run["keep"][p], want_keep))
                               for p in (1, 2)}}
    for pid in (1, 2):
        got, chol = run["stats"][pid], hh["cholqr2_stats"][pid]
        ok = got.shape == want.shape == chol.shape
        checks[pid] = {
            "finite": bool(np.isfinite(got).all()),
            "max_abs_err": float(np.abs(got - want).max()) if ok else None,
            "corr": float(np.corrcoef(got, want)[0, 1]) if ok else None,
            "cholqr2_max_abs_diff": float(np.abs(got - chol).max()) if ok else None,
        }
    return checks


def householder_study_phase(torch, hh: dict, kernels: list) -> dict:
    """Phase 14: the skip-PCA study with qr_method = "householder" through
    the CLI, run by phase 10's _study_runs after its resumed run (the keys
    and QC resumed from run 1's caches, the covariate basis and the block
    products computed again).  Checks it, then holds every kernel against
    its plain version at each shape of the run that no earlier phase
    checked.  Appends the kernels' records to `kernels`; returns the
    phase's record."""
    from sfgwas_tpu_torch.crypto.params import get_params

    params = get_params("PN14QP438")
    t_phase = time.time()
    run, sizes = hh["run"], hh["sizes"]
    checks = householder_study_check(hh)
    k2 = run["k2"]
    spans = run["spans_party1_host_clock"] or {}
    line = {
        "individuals": [0, hh["n_loc"], hh["n_loc"]], "covariates": 5, "snps": int(sum(sizes)),
        "blocks": len(sizes), "config": STUDY_CONFIG, "flags": HOUSEHOLDER_FLAGS,
        "run": "a third run of phase 10's _study_runs, after its resumed run: the keys and "
               "the QC filter restored from run 1's caches, the basis and the block products "
               "computed again",
        "reduced": {"snps": [int(sum(STUDY_BLOCKS)), int(sum(sizes))],
                    "blocks": [len(STUDY_BLOCKS), len(sizes)],
                    "why": "time: the whole script runs within its 1,200 s"},
        "checks": checks,
        "k2_inline_checks": {k: k2[k] for k in ("launches", "equal", "check_s")},
        "spans_party1_synchronized": {k: spans[k] for k in ("combined_q",) + HH_SPANS
                                      if k in spans},
    }
    line.update({k: run[k] for k in (
        "command_s", "protocol_party1", "protocol_party2", "init_s", "keys_from_cache",
        "peak_device_bytes", "peak_host_rss_bytes", "launches")})
    _say(f"householder study phase: {json.dumps(line)}")
    for pid, eq in checks["filter_equal"].items():
        if not eq:
            raise AssertionError(f"householder run, party {pid}: the SNP filter differs from "
                                 "the oracle")
    for pid in (1, 2):
        c = checks[pid]
        if (not c["finite"] or c["max_abs_err"] is None or not c["max_abs_err"] <= ASSOC_STAT_TOL
                or not c["corr"] > ASSOC_MIN_CORR
                or not c["cholqr2_max_abs_diff"] <= HOUSEHOLDER_TOL):
            raise AssertionError(f"householder party {pid}: statistics off: {c}")
    missing = [k for k in ASSOC_PATH if run["launches"][k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the householder run: {missing}")
    nblocks = len(sizes)
    if (run["launches"]["mac_dense"] != 2 * nblocks or k2["launches"] != 2 * nblocks
            or k2["equal"] != k2["launches"]):
        raise AssertionError(f"K2: {run['launches']['mac_dense']} launches, {k2['equal']} of "
                             f"{k2['launches']} equal to its plain version; want {2 * nblocks}")
    if sorted(run["keys_from_cache"]) != [0, 1, 2] or not all(run["keys_from_cache"].values()):
        raise AssertionError(f"bundles from the key cache: {run['keys_from_cache']}")
    rec = run.pop("rec")
    k1_shapes, k1_total, tree_shapes, equal_only = _collective_kernel_checks(
        torch, rec, run["launches"], params, kernels, "householder_study", new_only=True,
        timed_per_kernel=HH_TIMED_SHAPES)
    del rec
    line.update(k1_new_shapes_timed_total_ms=k1_total, k1_shapes=k1_shapes,
                compared_without_timing=equal_only, tree_shapes=tree_shapes,
                phase_s=time.time() - t_phase)
    return line


# ---------------------------------------------------------------------------
# 11. the study as three party processes over loopback TCP

TCP_RUN_TIMEOUT_S = {"fresh": 900, "resumed": 400}  # first start to the last run record
TCP_CHECK_TIMEOUT_S = 600  # one party's kernel checks
# each party's OpenMP threads (torch's CPU pool, the native ring engine):
# the parties share one host
TCP_PARTY_THREADS = max(1, (os.cpu_count() or 3) // 3)
# the local config's fields: a party's own files and directories
TCP_LOCAL_FIELDS = ("geno_binary_file_prefix", "geno_block_size_file", "pheno_file",
                    "covar_file", "snp_position_file", "geno_count_file")


def free_ports(n: int) -> list:
    """n distinct ports free on 127.0.0.1 right now."""
    import socket

    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            socks.append(s)
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def tcp_configs(root: str, cfg: str, tag: str) -> list:
    """From the study's global config (paths in {pid} form): a global config
    with a [servers.partyN] map on 127.0.0.1 at free ports, and one local
    config a party with its own paths (the dealer takes party 1's) and its
    cache and output directories.  Returns [(global, local)] by pid.  The
    port's TCP tests write their configs with it too."""
    import tomllib

    with open(cfg, "rb") as f:
        fields = tomllib.load(f)
    p01, p02, p12 = free_ports(3)
    g = os.path.join(root, f"global_{tag}.toml")
    with open(cfg) as f, open(g, "w") as out:
        out.write(f.read())
        out.write('binding_ipaddr = "127.0.0.1"\n'
                  f'[servers.party0]\nipaddr = "127.0.0.1"\n[servers.party0.ports]\n'
                  f'party1 = "{p01}"\nparty2 = "{p02}"\n'
                  f'[servers.party1]\nipaddr = "127.0.0.1"\n[servers.party1.ports]\n'
                  f'party2 = "{p12}"\n[servers.party2]\nipaddr = "127.0.0.1"\n')
    cfgs = []
    for pid in range(3):
        loc = {k: fields[k].replace("{pid}", str(pid or 1)) for k in TCP_LOCAL_FIELDS}
        loc["cache_dir"] = os.path.join(fields["cache_dir"], f"party{pid}")
        loc["output_dir"] = os.path.join(fields["output_dir"], f"party{pid}")
        path = os.path.join(root, f"local_{tag}_{pid}.toml")
        with open(path, "w") as f:
            f.write("".join(f"{k} = {json.dumps(v)}\n" for k, v in loc.items()))
        cfgs.append((g, path))
    return cfgs


def _net_totals(hooks: "_Patches") -> dict:
    """Network's per-peer counters summed over a party's whole run: each
    reset_log (one at each protocol phase) first adds the counters it
    clears; totals(net) adds the counters still on the party's Network."""
    from sfgwas_tpu_torch.parallel import transport as PT

    keys = ("sent_bytes", "sent_msgs", "recv_bytes", "recv_msgs")
    tot = {"nets": [], "sum": collections.defaultdict(lambda: dict.fromkeys(keys, 0))}

    def add(net):
        for k in keys:
            for peer, v in getattr(net, k).items():
                if peer != net.pid:
                    tot["sum"][peer][k] += v

    def reset(real):
        def wrapped(self):
            if hasattr(self, "sent_bytes"):
                add(self)
            else:
                tot["nets"].append(self)
            real(self)
        return wrapped

    hooks.patch(PT.Network, "reset_log", reset)

    def totals() -> dict:
        for net in tot["nets"]:
            add(net)
        return {str(peer): v for peer, v in sorted(tot["sum"].items())}

    return totals


def _smi_memory_peak(stop: threading.Event, out: dict):
    """Samples the card's used memory (nvidia-smi, MiB) every 0.5 s until
    stop is set; the peak goes to out["mib"]."""
    while not stop.wait(0.5):
        try:
            v = subprocess.run(
                ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=30, check=True,
            ).stdout.strip().splitlines()[0]
        except (OSError, subprocess.SubprocessError, IndexError):
            continue
        out["mib"] = max(out.get("mib", 0), float(v))


def party_main(torch, args) -> int:
    """One party process of phase 11 (chip_smoke.py --party-run NAME
    --party-dir DIR, with PID in the environment): phase 10's hooks
    installed, then cli.main with the party's configs and no --platform
    (the card), with every launch count set to 0 before it and read after
    it.  Writes DIR/run{pid}.json.  After a fresh run it waits for
    DIR/go{pid}.json (the shapes earlier checks held), holds K1 and K3-K6
    against their plain versions at every shape of its run not among them,
    and writes DIR/checks{pid}.json.  --party-platform cpu runs the party
    on the CPU (a rehearsal: no kernel checks)."""
    import ast

    from sfgwas_tpu_torch import cli
    from sfgwas_tpu_torch.crypto.params import get_params
    from sfgwas_tpu_torch.ops import cuda_build
    from sfgwas_tpu_torch.utils import prof

    pid = int(os.environ["PID"])
    d, fresh = args.party_dir, args.party_run == "fresh"
    cuda = args.party_platform is None
    argv = ["--config-global", args.config_global, "--config-local", args.config_local]
    if cuda:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device available", file=sys.stderr)
            return 2
        torch.cuda.set_device(0)
        torch.cuda.reset_peak_memory_stats()
    else:
        argv += ["--platform", args.party_platform]
    hooks, got = _study_hooks(torch, k2_inline=fresh, keep_first=False)
    totals = _net_totals(hooks)
    rec = _collective_recorder(k3=True) if fresh and cuda else None
    prof.ENABLED = True
    cuda_build.reset_launch_counts()
    try:
        with _StdoutLines() as lines, _RssPeak() as rss:
            t0 = time.time()
            cli.main(argv)
            if cuda:
                torch.cuda.synchronize()
            cmd_s = time.time() - t0
        launches = dict.fromkeys(ASSOC_PATH, 0)
        launches.update({k: v.launches for k, v in cuda_build.REGISTRY.items()})
    finally:
        prof.ENABLED = False
        hooks.restore()
        if rec is not None:
            rec.restore()
    k2 = got["k2"]
    k2.pop("first")
    run = dict(
        pid=pid, command_s=cmd_s, protocol=_protocol_times(lines.lines(), pid),
        init_s=got["init"][pid]["s"], keys_from_cache=got["init"][pid]["keys_from_cache"],
        key_dir_write_s=got["save_s"], spans_party1_host_clock=got["spans"],
        peak_device_bytes=torch.cuda.max_memory_allocated() if cuda else None,
        peak_device_reserved_bytes=torch.cuda.max_memory_reserved() if cuda else None,
        peak_host_rss_bytes=rss.peak, launches=launches, k2=k2, net=totals(),
        omp_threads=os.environ.get("OMP_NUM_THREADS"), finished_at=time.time(),
    )
    _write_whole(os.path.join(d, f"run{pid}.json"), json.dumps(run))
    _say(f"party {pid} {args.party_run}: {json.dumps(run)}")
    if not (fresh and cuda):
        return 0
    del got
    torch.cuda.empty_cache()
    go = os.path.join(d, f"go{pid}.json")
    deadline = time.time() + TCP_CHECK_TIMEOUT_S
    while not os.path.exists(go):
        if time.time() > deadline:
            raise AssertionError(f"party {pid}: no go for the kernel checks")
        time.sleep(0.2)
    with open(go) as f:
        CHECKED.update(ast.literal_eval(f.read()))
    kernels: list = []
    k1_shapes, k1_total, tree_shapes, _ = _collective_kernel_checks(
        torch, rec, launches, get_params("PN14QP438"), kernels, f"tcp study party {pid}",
        new_only=True)
    with open(os.path.join(d, f"checks{pid}.json"), "w") as f:
        json.dump({"kernels": kernels, "checked": _checked_repr(),
                   "k1_shapes": k1_shapes, "k1_total_ms": k1_total,
                   "tree_shapes": tree_shapes}, f)
    return 0


def _write_whole(path: str, text: str):
    """Writes text to path under another name first, then renames it: a
    process polling for path never reads it half written."""
    with open(path + ".part", "w") as f:
        f.write(text)
    os.replace(path + ".part", path)


def _checked_repr() -> str:
    """CHECKED as a Python literal (ast.literal_eval reads it back): its
    keys with plain ints and bools in place of numpy's."""
    def plain(x):
        if isinstance(x, (tuple, list)):
            return tuple(plain(v) for v in x)
        if isinstance(x, (bool, np.bool_)):
            return bool(x)
        return x if isinstance(x, str) else int(x)

    return repr(sorted((plain(k) for k in CHECKED), key=repr))


def _tcp_run(name: str, d: str, cfgs: list, kernels: list, out_dir: str,
             platform=None) -> dict:
    """One run of phase 11: the three party processes started together
    (OMP_NUM_THREADS=TCP_PARTY_THREADS each), the parent waiting for every
    run record (a process that fails or a timeout kills the others and
    raises), then, after a fresh run on the card, each party's kernel checks
    one party at a time.  Each party's log is copied to
    out_dir/tcp_<name>_party<pid>.log.  Returns the run's record."""
    import ast
    import shutil

    here = os.path.abspath(__file__)
    env = dict(os.environ, OMP_NUM_THREADS=str(TCP_PARTY_THREADS))
    extra = [] if platform is None else ["--party-platform", platform]
    procs, logs = [], []
    stop, smi = threading.Event(), {}
    sampler = threading.Thread(target=_smi_memory_peak, args=(stop, smi), daemon=True)
    sampler.start()
    t0 = time.time()

    def fail(why: str):
        for pid, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
        for pid, path in enumerate(logs):
            with open(path) as f:
                print(f"---- party {pid} ({name}), the end of its log:\n{f.read()[-6000:]}",
                      file=sys.stderr, flush=True)
        raise AssertionError(f"tcp study {name}: {why}")

    try:
        for pid, (g, loc) in enumerate(cfgs):
            path = os.path.join(d, f"{name}_party{pid}.log")
            logs.append(path)
            with open(path, "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, here, "--party-run", name, "--party-dir", d,
                     "--config-global", g, "--config-local", loc] + extra,
                    env=dict(env, PID=str(pid)), stdout=log, stderr=subprocess.STDOUT))
        records = [os.path.join(d, f"run{pid}.json") for pid in range(3)]
        while not all(os.path.exists(r) for r in records):
            bad = [(pid, p.returncode) for pid, p in enumerate(procs)
                   if p.poll() is not None and (p.returncode != 0 or not os.path.exists(
                       records[pid]))]
            if bad:
                fail(f"party processes exited before their run record: {bad}")
            if time.time() - t0 > TCP_RUN_TIMEOUT_S[name]:
                fail(f"no run record from every party within {TCP_RUN_TIMEOUT_S[name]} s")
            time.sleep(0.2)
        runs = []
        for r in records:
            with open(r) as f:
                runs.append(json.load(f))
        wall_s = max(r["finished_at"] for r in runs) - t0
        stop.set()
        if name == "fresh" and platform is None:
            for pid, p in enumerate(procs):
                _write_whole(os.path.join(d, f"go{pid}.json"), _checked_repr())
                try:
                    p.wait(timeout=TCP_CHECK_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    fail(f"party {pid}'s kernel checks took over {TCP_CHECK_TIMEOUT_S} s")
                if p.returncode != 0:
                    fail(f"party {pid}'s kernel checks exited {p.returncode}")
                with open(os.path.join(d, f"checks{pid}.json")) as f:
                    chk = json.load(f)
                CHECKED.update(ast.literal_eval(chk["checked"]))
                kernels.extend(chk["kernels"])
                runs[pid]["k1_new_shapes_total_ms"] = chk["k1_total_ms"]
                runs[pid]["tree_shapes"] = chk["tree_shapes"]
        for pid, p in enumerate(procs):
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                fail(f"party {pid} did not exit after its run")
            if p.returncode != 0:
                fail(f"party {pid} exited {p.returncode}")
        last_exit_s = time.time() - t0
    finally:
        stop.set()
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        sampler.join(timeout=60)
        for pid, path in enumerate(logs):
            shutil.copy(path, os.path.join(out_dir, f"tcp_{name}_party{pid}.log"))
    for r in records:
        os.remove(r)
    return {"wall_s": wall_s, "last_exit_s": last_exit_s, "card_peak_used_mib": smi.get("mib"),
            "parties": runs}


def tcp_study_phase(torch, seed: int, out_dir: str, kernels: list, n_loc: int = 1000,
                    sizes=STUDY_BLOCKS, platform=None, overrides=None) -> dict:
    """Phase 11: the study of phase 10 at the depth `sizes` gives (2 x 1000
    individuals, 5 covariates, main() runs the first of the config's 22
    blocks; the default is all 22), configGlobalSkipPCA.toml's
    flags) as three party processes over loopback TCP, each `cli.main` with
    its PID and its local config and no --platform (the card), fresh, then
    resumed from the caches.  The six kernels, the ring engine and the
    transport library are built here first; the parties load them.  Appends
    the kernels' records of the shapes no earlier phase checked; returns the
    phase's record.
    platform="cpu" with a small n_loc, sizes and a preset in overrides
    rehearses the phase on the CPU (no kernels, no checks of them)."""
    import shutil
    import tempfile

    from sfgwas_tpu_torch.ops import cuda_build, native_ring
    from sfgwas_tpu_torch.parallel import native_transport

    root = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.time()
    t0 = time.time()
    if platform is None:
        cuda_build.build()
    native_ring.lib()
    native_transport.lib()
    build_s = time.time() - t0
    if platform is None:
        torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="sfgwas_tcp_")
    runs: dict = {}
    try:
        t0 = time.time()
        data, cfg = _study_files(tmp, seed, n_loc, sizes, os.path.join(root, STUDY_CONFIG),
                                 overrides or {})
        data_s = time.time() - t0
        for name in ("fresh", "resumed"):
            run = _tcp_run(name, tmp, tcp_configs(tmp, cfg, name), kernels, out_dir, platform)
            run["stats"] = {pid: np.loadtxt(os.path.join(tmp, "out", f"party{pid}", "assoc.txt"))
                            for pid in (1, 2)}
            run["keep"] = {pid: np.loadtxt(os.path.join(tmp, "cache", f"party{pid}",
                                                        "gkeep.txt")).astype(bool)
                           for pid in (1, 2)}
            shutil.copy(os.path.join(tmp, "out", "party1", "assoc.txt"),
                        os.path.join(out_dir, f"assoc_tcp_{name}.txt"))
            runs[name] = run
            p = run["parties"]
            _say(f"tcp study {name}: {run['wall_s']:.1f} s from the first start to the last "
                 f"run record; protocol {json.dumps([r['protocol'] for r in p])}; init "
                 f"{[round(r['init_s'], 2) for r in p]} s; launches "
                 f"{json.dumps([r['launches'] for r in p])}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    checks = study_check(data, runs, n_loc, sizes)
    fresh, resumed = runs["fresh"], runs["resumed"]
    total = {k: sum(r["launches"].get(k, 0) for r in fresh["parties"])
             for k in sorted({k for r in fresh["parties"] for k in r["launches"]})}
    line = {
        "individuals": [0, n_loc, n_loc], "covariates": 5, "snps": int(sum(sizes)),
        "blocks": len(sizes), "config": STUDY_CONFIG, "transport": "NativeTCPTransport",
        "reduced": {"snps": [int(sum(STUDY_BLOCKS)), int(sum(sizes))],
                    "blocks": [len(STUDY_BLOCKS), len(sizes)],
                    "why": "time: the whole script runs within its 1,200 s"},
        "mpc_num_threads": 1, "omp_threads_per_party": TCP_PARTY_THREADS, "build_s": build_s,
        "data_s": data_s, "checks": checks, "fresh_launches_all_parties": total,
        "host_cpu": f"{_cpu_model()}, {os.cpu_count()} logical cores",
    }
    for name, r in runs.items():
        line[name] = {k: r[k] for k in ("wall_s", "last_exit_s", "card_peak_used_mib")}
        line[name]["parties"] = [{k: v for k, v in p.items() if k not in ("tree_shapes",)}
                                 for p in r["parties"]]
    _say(f"tcp study phase: {json.dumps(line)}")
    for name in runs:
        for pid, eq in checks[f"{name}_filter_equal"].items():
            if not eq:
                raise AssertionError(f"tcp {name} run, party {pid}: the revealed SNP filter "
                                     "differs from the oracle")
    for pid in (1, 2):
        c = checks[pid]
        if (not c["finite"] or c["max_abs_err"] is None or not c["max_abs_err"] <= ASSOC_STAT_TOL
                or not c["corr"] > ASSOC_MIN_CORR):
            raise AssertionError(f"tcp party {pid}: statistics off: max abs err "
                                 f"{c['max_abs_err']}, corr {c['corr']}, finite {c['finite']}")
        if c["resumed_max_abs_diff"] is None or not c["resumed_max_abs_diff"] < STUDY_RESUME_TOL:
            raise AssertionError(f"tcp party {pid}: the resumed run is off the fresh one by "
                                 f"{c['resumed_max_abs_diff']}")
    cuda = platform is None  # a CPU rehearsal launches no kernel
    missing = [k for k in ASSOC_PATH if not total.get(k)]
    if cuda and missing:
        raise AssertionError(f"kernels not launched on the tcp study's fresh run: {missing}")
    for pid, r in enumerate(fresh["parties"]):
        want = checks["blocks_kept"] if pid else 0
        k2, launched = r["k2"], r["launches"].get("mac_dense", 0)
        if (cuda and launched != want) or k2["launches"] != want or k2["equal"] != want:
            raise AssertionError(f"tcp party {pid}: K2 launched {launched} times, "
                                 f"{k2['equal']} of {k2['launches']} calls equal to its plain "
                                 f"version; want {want}")
    for pid, r in enumerate(resumed["parties"]):
        if r["launches"].get("mac_dense", 0):
            raise AssertionError(f"tcp party {pid}: the resumed run launched K2 "
                                 f"{r['launches']['mac_dense']} times")
    if (any(r["keys_from_cache"] for r in fresh["parties"])
            or not all(r["keys_from_cache"] for r in resumed["parties"])):
        raise AssertionError("tcp study: bundles from the key cache: fresh "
                             f"{[r['keys_from_cache'] for r in fresh['parties']]}, resumed "
                             f"{[r['keys_from_cache'] for r in resumed['parties']]}")
    tree_shapes: dict = {}
    for r in fresh["parties"]:
        for key, found in r.pop("tree_shapes", {}).items():
            tree_shapes.setdefault(key, []).extend(s for s in found
                                                   if s not in tree_shapes.get(key, []))
    line.update(tree_shapes=tree_shapes, phase_s=time.time() - t_phase)
    return line


# ---------------------------------------------------------------------------
# 12. the default-config study with PCA through the CLI

# the shipped configuration: PCA on (5 PCs, 10 oversampling columns, cholqr2,
# 5 shifted-QR iterations an eigenvalue), QC from the plink2 counts
PCA_CONFIG = "config/configGlobal.toml"
# the first block of the config's 22: cut from 3 when phase 15 took the
# whole script past 1,140 of its 1,200 s on the H100 (about 1,145 s), from 2
# to make room for phase 16; QC then keeps fewer SNPs than PCA_SNPS, and LD
# pruning keeps them all.  The device budget of the diagonal caches is cut
# with the blocks (pca_device_budget), so that the cut study takes the
# host-streamed path that the example's 22 blocks take
PCA_BLOCKS = STUDY_BLOCKS[:1]
PCA_SNPS = 10_000  # LD-pruned SNPs: the example's order (sfgwas_tpu/gwas/pca.py:60-61)
PCA_POWER_ITERS = 1  # of the config's 20
# shifted-QR iterations an eigenvalue, of the config's 5 (tests/test_torch_pca.py
# runs 2): cut to 2 when the whole script ran past its 1,200 s on an H100 (the
# SS eigendecomposition of the 15 x 15 Gram took 182 of the fresh run's 313
# s), to 1 to make room for phase 16 (a 15 x 15 Gram with two dominant
# eigenvalues keeps both eigenvalues and its top two eigenvectors in the
# span of the top five rows at 1 iteration, on the CPU)
PCA_EIGEN_ITERS = 1
PCA_NPOP, PCA_FST = 3, 0.05  # Balding-Nichols subpopulations
PCA_SHIFT = (0.0, 0.8, -0.8)  # the phenotype's mean in each subpopulation
PCA_MIN_COS = 0.99  # |cos| of each of the top two exact PCs with span(Qpc)
PCA_RESUME_TOL = 2e-2  # tests/test_e2e_gwas.py:357
# run 2: the decrypted PCs, the filter, the basis and the products from run 1's caches
PCA_RESUME = {"use_cached_pca": True, "use_cached_qc": True, "use_cached_combined_q": True}


def _pca_data(seed: int, n_loc: int, m: int, ncov: int = 5):
    """Phase 12's data from the seed, per data party: genotypes [n_loc, m]
    of three subpopulations, each individual's drawn uniformly (so each
    spans both parties), with Balding-Nichols allele frequencies at F_ST =
    0.05 around an ancestral MAF uniform in [0.02, 0.5], about 1% missing
    (-1); 5 covariates at phase 8's column scales; a phenotype with 5
    planted effects and a shift per subpopulation."""
    rng = np.random.default_rng(seed + 12)
    p = rng.uniform(0.02, 0.5, size=m)
    k = (1 - PCA_FST) / PCA_FST
    freqs = rng.beta(p * k, (1 - p) * k, size=(PCA_NPOP, m))
    planted = rng.choice(m, 5, replace=False)
    out = {}
    for pid in (1, 2):
        lab = rng.integers(0, PCA_NPOP, size=n_loc)
        g = rng.binomial(2, freqs[lab]).astype(np.int8)
        g[rng.uniform(size=(n_loc, m)) < 0.01] = -1
        cov = rng.normal(size=(n_loc, ncov)) * np.array([1.0, 20.0, 0.1, 50.0, 0.3])[:ncov]
        pheno = (rng.normal(size=n_loc) + 0.3 * np.maximum(g[:, planted], 0).sum(1)
                 + np.asarray(PCA_SHIFT)[lab])
        out[pid] = (g, pheno, cov)
    return out


def _pca_positions(keep: np.ndarray, target: int) -> np.ndarray:
    """Base-pair positions, ascending, such that LD pruning at
    config/configGlobal.toml's snp_dist_thres (100,000 bp) keeps the first
    `target` SNPs that QC keeps: each of those lies 100,000 bp past the
    SNP before it, every other SNP 1 bp."""
    kept = np.flatnonzero(keep)[:target]
    gap = np.ones(len(keep), np.int64)
    gap[kept] = 100_000
    return np.cumsum(gap)


def ld_prune_oracle(keep: np.ndarray, pos: np.ndarray, dist: int) -> np.ndarray:
    """The greedy pruning of gwas/gwas.go:609-626 in numpy terms: a kept SNP
    stays when it lies at least dist past the last one that stayed."""
    out = np.zeros(len(keep), bool)
    last = None
    for i in np.flatnonzero(keep):
        if last is None or pos[i] >= last + dist:
            out[i], last = True, pos[i]
    return out


def pca_study_check(data, runs, n_loc: int, sizes, pca_snps: int, npc: int) -> dict:
    """The filters against the QC oracle; each run's decrypted PCs finite,
    and each of the top two PCs of the standardised, pruned, pooled
    genotypes in their span; the statistics against the oracle on [1 |
    covariates | the run's PCs]; the resumed run's against the fresh run's."""
    fresh, resumed = runs["fresh"], runs["resumed"]
    keep = assoc_qc_oracle(data, ASSOC_FILTER, n_loc)
    pruned = ld_prune_oracle(keep, _pca_positions(keep, pca_snps), 100_000)
    G = np.concatenate([data[1][0], data[2][0]])[:, pruned].astype(np.float64)
    G[G < 0] = 0.0
    sd = G.std(0)
    Gs = (G - G.mean(0)) / np.where(sd > 0, sd, 1.0)
    u, sv, _ = np.linalg.svd(Gs, full_matrices=False)
    checks = {"snps": int(len(keep)), "kept": int(keep.sum()), "pruned": int(pruned.sum()),
              "singular_values_top4": sv[:4].tolist()}
    for name, r in runs.items():
        q = r["qpc"]
        ok = q.shape == (2 * n_loc, npc) and bool(np.isfinite(q).all())
        basis = np.linalg.qr(q)[0] if ok else None
        checks[f"{name}_qpc"] = {
            "shape": list(q.shape), "finite": bool(np.isfinite(q).all()),
            "cos_top2": ([float(np.linalg.norm(basis.T @ u[:, k])) for k in range(2)]
                         if ok else None),
        }
        checks[f"{name}_filter_equal"] = {p: bool(np.array_equal(r["keep"][p], keep))
                                          for p in (1, 2)}
    want = assoc_stat_oracle(data, keep, fresh["qpc"])
    for pid in (1, 2):
        got = fresh["stats"][pid]
        ok_shape = got.shape == want.shape
        checks[pid] = {
            "finite": bool(np.isfinite(got).all()),
            "max_abs_err": float(np.abs(got - want).max()) if ok_shape else None,
            "corr": float(np.corrcoef(got, want)[0, 1]) if ok_shape else None,
            "resumed_max_abs_diff": (float(np.abs(resumed["stats"][pid] - got).max())
                                     if resumed["stats"][pid].shape == got.shape else None),
        }
    return checks


def _pca_study_runs(torch, seed: int, out_dir: str, n_loc: int = 1000, sizes=PCA_BLOCKS,
                    pca_snps: int = PCA_SNPS, platform=None, overrides=None):
    """Phase 12's two CLI runs (_study_runs on config/configGlobal.toml with
    the power iterations cut to PCA_POWER_ITERS and the shifted-QR
    iterations to PCA_EIGEN_ITERS; platform=None is the
    card).  A CPU rehearsal: platform="cpu" with a small n_loc, sizes and
    pca_snps and, in overrides, "ckks_params": "TEST8", num_inds and
    num_snps (and smaller PCA sizes: kp 15 costs minutes of SS work)."""
    root = os.path.dirname(os.path.abspath(__file__))
    fields = {"num_snps": int(sum(sizes)), "num_power_iters": PCA_POWER_ITERS,
              "iter_per_eigenval": PCA_EIGEN_ITERS}
    fields.update(overrides or {})
    return _study_runs(torch, seed, out_dir, n_loc, sizes, os.path.join(root, PCA_CONFIG),
                       platform=platform, overrides=fields, pca_snps=pca_snps,
                       resume_flags=PCA_RESUME, pca_budget=pca_device_budget(len(sizes)))


def pca_device_budget(nblocks: int) -> int:
    """distributed_pca's device budget for a study cut to nblocks of the
    example's 22: the port's default (the reference's 6 GiB) times
    nblocks / 22, the share of the example's diagonal caches that the cut
    study holds."""
    from sfgwas_tpu_torch.gwas import pca as PP

    return PP.DEVICE_CACHE_BYTES * nblocks // len(STUDY_BLOCKS)


def _pca_spans(spans) -> dict:
    """Party 1's PCA spans (seconds), and per stage the power iterations'
    sum."""
    pca = {k: v for k, v in (spans or {}).items() if k.startswith("pca_")}
    per_stage: dict = {}
    for k, secs in pca.items():
        m = re.match(r"pca_iter\d+_(\w+)$", k)
        if m:
            per_stage[m.group(1)] = per_stage.get(m.group(1), 0.0) + secs
    return {"spans": pca, "power_iterations_by_stage": per_stage}


def pca_study_phase(torch, seed: int, out_dir: str, kernels: list) -> dict:
    """Phase 12: the default-config study with PCA through the CLI, cli.main
    with --local-sim 3 and no --platform (the card), at the shipped width:
    PN14QP438, 2 x 1000 individuals, 5 covariates, 5 PCs with 10
    oversampling columns (kp 15), cholqr2, QC from the counts at
    config/configGlobal.toml's thresholds, LD pruning at 100,000 bp to at
    most 10,000 SNPs (host-streamed diagonal caches, the device budget cut
    with the blocks), the first of the config's 22 blocks, 1 of its 20
    power iterations and 1 of its 5 shifted-QR iterations an eigenvalue;
    run 1 fresh, run 2
    resumed from the decrypted PCs and the other caches.  Then K2 timed at
    its first launch (a PCA shape) and every other kernel at each shape of
    run 1 that no earlier phase checked.  Appends the kernels' records to
    `kernels`; returns the phase's record."""
    from sfgwas_tpu_torch.crypto.params import get_params
    from sfgwas_tpu_torch.gwas import matmult as MM

    params = get_params("PN14QP438")
    n_loc, sizes, npc = 1000, PCA_BLOCKS, 5
    t_phase = time.time()
    data, runs = _pca_study_runs(torch, seed, out_dir, n_loc, sizes)
    checks = pca_study_check(data, runs, n_loc, sizes, PCA_SNPS, npc)
    fresh, resumed = runs["fresh"], runs["resumed"]
    k2 = fresh["k2"]
    line = {
        "individuals": [0, n_loc, n_loc], "covariates": 5, "snps": int(sum(sizes)),
        "blocks": len(sizes), "config": PCA_CONFIG, "pcs": npc, "oversampling": 10,
        "power_iterations": PCA_POWER_ITERS, "eigen_iterations": PCA_EIGEN_ITERS,
        "pca_snps_target": PCA_SNPS,
        "population": {"subpopulations": PCA_NPOP, "fst": PCA_FST, "shift": PCA_SHIFT},
        "reduced": {"snps": [int(sum(STUDY_BLOCKS)), int(sum(sizes))],
                    "blocks": [len(STUDY_BLOCKS), len(sizes)],
                    "device_budget_bytes": [pca_device_budget(len(STUDY_BLOCKS)),
                                            pca_device_budget(len(sizes))],
                    "power_iterations": [20, PCA_POWER_ITERS],
                    "eigen_iterations": [5, PCA_EIGEN_ITERS],
                    "pruned_snps": [PCA_SNPS, checks["pruned"]],
                    "why": "time: the whole script runs within its 1,200 s"},
        "checks": checks, "data_s": fresh["data_s"],
        "k2_inline_checks": {k: k2[k] for k in ("launches", "equal", "check_s")},
        "host_cpu": f"{_cpu_model()}, {os.cpu_count()} logical cores",
    }
    for name, r in runs.items():
        line[name] = {k: r[k] for k in (
            "command_s", "protocol_party1", "protocol_party2", "init_s", "keys_from_cache",
            "peak_device_bytes", "peak_host_rss_bytes", "launches", "pca_calls", "streamed")}
        line[name]["pca_party1"] = _pca_spans(r["spans_party1_host_clock"])
        line[name]["spans_party1"] = r["spans_party1_host_clock"]
    line["fresh"]["cache_mode"] = "host-streamed" if fresh["streamed"]["calls"] else "device"
    _say(f"pca study phase: {json.dumps(line)}")
    for name in runs:
        for pid, eq in checks[f"{name}_filter_equal"].items():
            if not eq:
                raise AssertionError(f"pca {name} run, party {pid}: the revealed SNP filter "
                                     "differs from the oracle")
        q = checks[f"{name}_qpc"]
        if not q["finite"] or q["cos_top2"] is None or min(q["cos_top2"]) < PCA_MIN_COS:
            raise AssertionError(f"pca {name} run: the PCs {q} miss the top two exact PCs")
    for pid in (1, 2):
        c = checks[pid]
        if (not c["finite"] or c["max_abs_err"] is None or not c["max_abs_err"] <= ASSOC_STAT_TOL
                or not c["corr"] > ASSOC_MIN_CORR):
            raise AssertionError(f"pca party {pid}: statistics off: max abs err "
                                 f"{c['max_abs_err']}, corr {c['corr']}, finite {c['finite']}")
        if c["resumed_max_abs_diff"] is None or not c["resumed_max_abs_diff"] < PCA_RESUME_TOL:
            raise AssertionError(f"pca party {pid}: the resumed run is off the fresh one by "
                                 f"{c['resumed_max_abs_diff']}")
    if fresh["pca_calls"] != 3 or resumed["pca_calls"]:
        raise AssertionError(f"distributed_pca ran {fresh['pca_calls']} / "
                             f"{resumed['pca_calls']} times (fresh / resumed)")
    if not fresh["streamed"]["calls"]:
        raise AssertionError("the PCA caches were not host-streamed")
    missing = [k for k in ASSOC_PATH if fresh["launches"][k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the pca study's fresh run: {missing}")
    if (k2["launches"] != fresh["launches"]["mac_dense"] or k2["equal"] != k2["launches"]
            or not k2["launches"]):
        raise AssertionError(f"K2 equal to its plain version at {k2['equal']} of "
                             f"{k2['launches']} launches")
    rec = fresh.pop("rec")
    del runs, resumed
    R0, R1, polys, mruns, q, mu, logn, nacc = k2.pop("first")
    _k2_check(torch, MM, kernels,
              f"mac_dense (pca) {[mruns.nruns, int(mruns.run_start_host[-1])]}",
              fresh["real_mac"], R0, R1, polys, mruns, q, mu, logn, nacc)
    kernels[-1].update(launches=fresh["launches"]["mac_dense"], path="pca_study",
                       launches_at_shape=1, inline_equal_launches=k2["equal"])
    del R0, R1, polys, mruns
    torch.cuda.empty_cache()
    k1_shapes, k1_total, tree_shapes, _ = _collective_kernel_checks(
        torch, rec, fresh["launches"], params, kernels, "pca_study", new_only=True)
    del rec
    line.update(k1_new_shapes_total_ms=k1_total, k1_shapes=k1_shapes, tree_shapes=tree_shapes,
                phase_s=time.time() - t_phase)
    return line


class _ProbeStop(Exception):
    """Ends a --pca-probe run after the eigensolve."""


def pca_probe(torch, seed: int, out_dir: str, n_loc: int = 1000, sizes=PCA_BLOCKS,
              pca_snps: int = PCA_SNPS, platform=None, overrides=None) -> list:
    """The in-vivo bisect of PCA (python3 chip_smoke.py --pca-probe): phase
    12's fresh run through the CLI with one power iteration, each data
    party decrypting collectively the inputs and outputs of the Q
    scaling's steps (sfgwas_tpu/gwas/pca.py:186-217: the mean-weight
    multiply, the 1/sqrt(count) multiply after the mixed-level add, the
    std-inverse multiply), the aggregations, the bootstraps, the lazily
    normalised products and the first QR, and then the Gram, and every
    party revealing the eigenvalues.  Each line gives a step's levels and
    scales (log2), its |max| at each data party and, where numpy can
    redo the step on the decrypted inputs, the error.  The run stops after
    the eigensolve.  Writes the lines to out_dir/pca_probe.txt and
    returns them.  platform="cpu" with small sizes and a TEST8 preset in
    overrides rehearses it on the CPU."""
    import math
    import shutil
    import tempfile

    from sfgwas_tpu_torch import cli
    from sfgwas_tpu_torch.crypto import basics as B
    from sfgwas_tpu_torch.gwas import matmult as MM
    from sfgwas_tpu_torch.gwas import pca as PP
    from sfgwas_tpu_torch.mpc import linalg as PL
    from sfgwas_tpu_torch.mpc import mhe as PM

    tl = threading.local()
    lock = threading.Lock()
    calls: dict = {}
    lines: list = []
    last_qx: dict = {}

    def say(msg):
        with lock:
            lines.append(msg)
        _say(msg)

    def flat(x):
        if isinstance(x, list) and x and isinstance(x[0], list):
            return [ct for row in x for ct in row]
        return list(x) if isinstance(x, list) else [x]

    def is_cts(x):
        return isinstance(x, list) and bool(x) and hasattr(flat(x)[0], "c0")

    def dec(cps, cts):
        """Each data party's version of a ciphertext list, decoded."""
        out = {}
        for p in (1, 2):
            mine = cts if tl.net.pid == p else [None] * len(cts)
            pts = PM.collective_decrypt_many(tl.net, cps, mine, p)
            out[p] = np.stack([np.asarray(cps.ctx.decode(pt)) for pt in pts])
        return out

    def levels(cts):
        return sorted({(c.nmod, round(math.log2(c.scale), 3)) for c in cts})

    def probe(name, limit, expect=None):
        def make(real):
            def wrapped(*a, **k):
                net = getattr(tl, "net", None)
                if net is None or net.pid == 0:
                    return real(*a, **k)
                with lock:
                    n = calls.get((name, net.pid), 0)
                    calls[(name, net.pid)] = n + 1
                out = real(*a, **k)
                if n >= limit:
                    return out
                cps = next(x for x in a if hasattr(x, "ctx") and hasattr(x, "slots"))
                ins = [x for x in a if is_cts(x)]
                din = [dec(cps, flat(x)) for x in ins]
                dout = dec(cps, flat(out))
                tag = f"pid{net.pid} {name}#{n}"
                for i, (x, d) in enumerate(zip(ins, din)):
                    say(f"{tag} in{i}: {levels(flat(x))} |max| "
                        f"{[float(np.abs(v).max()) for v in d.values()]}")
                say(f"{tag} out: {levels(flat(out))} |max| "
                    f"{[float(np.abs(v).max()) for v in dout.values()]}")
                if name == "qx":
                    last_qx[net.pid] = dout
                if expect is not None:
                    want = expect(a, din)
                    got = dout[net.pid].reshape(-1)[: want.size]
                    say(f"{tag} max err {float(np.abs(got - want.reshape(-1)).max()):.3e} "
                        f"(|expected| max {float(np.abs(want).max()):.3e})")
                return out
            return wrapped
        return make

    def pca(real):
        def wrapped(mpc, cps, X, nsnp, nrows_all, npc, over, *a, **k):
            tl.net, tl.mpc, tl.n, tl.m, tl.kp = mpc.net, mpc, sum(nrows_all[1:]), nsnp, npc + over
            try:
                return real(mpc, cps, X, nsnp, nrows_all, npc, over, *a, **k)
            finally:
                tl.net = None
        return wrapped

    def gram(real):
        def wrapped(cps, cts, slot_lists, nct, value=1.0, cache_key=None):
            out = real(cps, cts, slot_lists, nct, value=value, cache_key=cache_key)
            if cache_key and cache_key[0] == "pca_gram":
                tl.gram_value = value
            return out
        return wrapped

    def gram_out(real):
        def wrapped(net, cps, cv, src, *a, **k):
            out = real(net, cps, cv, src, *a, **k)
            if getattr(tl, "gram_value", None) is None or net.pid == 0:
                return out
            z = dec(cps, flat(out))[net.pid].reshape(-1)[: tl.kp * tl.kp].reshape(tl.kp, tl.kp)
            q = np.concatenate([last_qx[net.pid][p].reshape(tl.kp, -1) for p in (1, 2)], axis=1)
            want = q @ q.T * tl.gram_value
            say(f"pid{net.pid} gram: {levels(flat(out))} |max| {float(np.abs(z).max()):.3e}, "
                f"max err {float(np.abs(z - want).max()):.3e}, top eigenvalue "
                f"{float(np.linalg.eigvalsh(want)[-1]):.4e} (x c = "
                f"{float(np.linalg.eigvalsh(want)[-1]) * PP.gram_scale(tl.mpc, tl.n, tl.m, tl.kp):.4e})")
            tl.gram_value = None
            return out
        return wrapped

    def eigen(real):
        def wrapped(mpc, A, *a, **k):
            V, L = real(mpc, A, *a, **k)
            if getattr(tl, "net", None) is not None:
                if mpc.pid > 0:
                    vals = mpc.ring.to_float(mpc.reveal_sym(L), mpc.frac_bits)
                    say(f"pid{mpc.pid} eigen_decomp: eigenvalues {np.sort(vals)[::-1][:4].tolist()}")
                # the dealer's part only sends: it waits here for the data parties
                mpc.assert_sync()
                raise _ProbeStop()
            return V, L
        return wrapped

    def const(a, din):
        return din[0][tl.net.pid] * a[2]

    def prod(a, din):
        return din[0][tl.net.pid] * din[1][tl.net.pid]

    hooks = _Patches()
    hooks.patch(PP, "distributed_pca", pca)
    hooks.patch(B, "cmult_const", probe("cmult_const", 4, const))
    hooks.patch(B, "cmult", probe("cmult", 2, prod))
    hooks.patch(PM, "aggregate_cmat", probe("aggregate_cmat", 1))
    hooks.patch(PM, "bootstrap_mat", probe("bootstrap_mat", 2))
    hooks.patch(MM, "qx_lazy_norm_stream", probe("qx", 2))
    hooks.patch(MM, "qxt_lazy_norm_stream", probe("qxt", 1))
    hooks.patch(PP, "net_qr", probe("net_qr", 1))
    hooks.patch(B, "mask_scatter_sum", gram)
    hooks.patch(PM, "bootstrap_vec", gram_out)
    hooks.patch(PL, "eigen_decomp", eigen)
    root = os.path.dirname(os.path.abspath(__file__))
    fields = {"num_snps": int(sum(sizes)), "num_power_iters": 1}
    fields.update(overrides or {})
    tmp = tempfile.mkdtemp(prefix="sfgwas_probe_")
    try:
        _, cfg = _study_files(tmp, seed, n_loc, sizes, os.path.join(root, PCA_CONFIG), fields,
                              pca_snps)
        argv = ["--local-sim", "3", "--config-global", cfg]
        if platform is not None:
            argv += ["--platform", platform]
        try:
            cli.main(argv)
            raise AssertionError("the probe's run did not reach the eigensolve")
        except _ProbeStop:
            pass
    finally:
        hooks.restore()
        shutil.rmtree(tmp, ignore_errors=True)
    with open(os.path.join(out_dir, "pca_probe.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return lines

# ---------------------------------------------------------------------------
# 13. the logistic study through the CLI

LOGISTIC_CONFIG = "config/configGlobalLogistic.toml"
# the first of the config's 22 blocks (cut from 2, with the epochs, to make
# room for phase 8's and 14's Householder QRs)
LOGISTIC_BLOCKS = STUDY_BLOCKS[:1]
LOGISTIC_EPOCHS = 3  # tests/test_e2e_gwas.py:79's count
# phase 13's Newton epochs, of the config's 15: cut from 3 to make room for
# the Householder QRs of phases 8 and 14, then from 2 when the whole script
# ran past its 1,200 s on an H100 (the second epoch took 85 s).  One epoch
# still runs both branches of compute_grad_and_inv_hessian (the first
# epoch's, without the intercept term, and the score test's preparation's,
# with it), and the phase still holds the statistics to the converged
# oracle, corr > 0.99
LOGISTIC_RUN_EPOCHS = 1
LOGISTIC_CONVERGED_EPOCHS = 50  # scripts/check_example_oracle.py:97
LOGISTIC_TOL = 2e-2  # against the oracle of the same epochs
LOGISTIC_MIN_CORR = 0.999
LOGISTIC_CONVERGED_CORR = 0.99  # scripts/check_example_oracle.py's own contract
# the phenotype's logit: an intercept, effects of covariates 0, 1 and 3 (per
# standard deviation 0.5, 0.4, -0.5) and of 3 planted SNPs' dosages
LOGISTIC_COV_EFFECTS = (0.5, 0.02, 0.0, -0.01, 0.0)
LOGISTIC_SNP_EFFECTS = (0.6, -0.5, 0.4)
# K2's launches a block at each data party: g^T W z B^T, g^T W g on the
# squared block, g^T y~ and g^T o
LOGISTIC_K2_A_BLOCK = 4


# phase 13's first SS inverse: the first Newton epoch's Hessian is c I (the
# orthonormal basis of [1 | C], weights 1/4), so A + A^T is 111.8034 I plus
# the noise of its HE products, as --card-runs revealed it (run BR)
NEAR_SCALAR = 55.9017
NEAR_SCALAR_OFF = 2.3e-7  # the off-diagonals' noise, uniform in +-
NEAR_SCALAR_DIAG = 1.4e-6  # the diagonal's noise
INVERSE_TOL = 1e-3  # of max |eig(B^T B (A + A^T)) - 1|; a lost direction is ~0.95


def near_scalar_input(seed: int = 0, k: int = 6) -> np.ndarray:
    """A k x k input of the SS inverse like phase 13's first: NEAR_SCALAR I
    plus symmetric off-diagonal and diagonal noise, from the seed."""
    rng = np.random.default_rng(seed)
    off = np.triu(rng.uniform(-NEAR_SCALAR_OFF, NEAR_SCALAR_OFF, size=(k, k)), 1)
    diag = rng.uniform(-NEAR_SCALAR_DIAG, NEAR_SCALAR_DIAG, size=k)
    return NEAR_SCALAR * np.eye(k) + off + off.T + np.diag(diag)


def inverse_sqrt_error(A: np.ndarray, B: np.ndarray) -> float:
    """How far B is from B^T B = (A + A^T)^-1: max |eig(B^T B (A + A^T)) - 1|."""
    return float(np.abs(np.linalg.eigvals(B.T @ B @ (A + A.T)) - 1).max())


def _logistic_data(seed: int, n_loc: int, m: int, ncov: int = 5):
    """Phase 13's data from the seed, per data party: phase 9's genotypes
    (MAF uniform in [0.02, 0.5], about 1% missing) and covariates (phase
    8's column scales), and a binary phenotype drawn from a logistic model
    over the covariates and 3 planted SNPs (missing read as 0), as
    tests/test_e2e_gwas.py:255 draws its own."""
    rng = np.random.default_rng(seed + 13)
    maf = rng.uniform(0.02, 0.5, size=m)
    planted = rng.choice(m, len(LOGISTIC_SNP_EFFECTS), replace=False)
    out = {}
    for pid in (1, 2):
        g = rng.binomial(2, maf[None, :], size=(n_loc, m)).astype(np.int8)
        g[rng.uniform(size=(n_loc, m)) < 0.01] = -1
        cov = rng.normal(size=(n_loc, ncov)) * np.array([1.0, 20.0, 0.1, 50.0, 0.3])[:ncov]
        logit = (-0.2 + cov @ np.asarray(LOGISTIC_COV_EFFECTS)[:ncov]
                 + np.maximum(g[:, planted], 0) @ np.asarray(LOGISTIC_SNP_EFFECTS))
        pheno = (rng.uniform(size=n_loc) < 1 / (1 + np.exp(-logit))).astype(float)
        out[pid] = (g, pheno, cov)
    return out


def logistic_oracle(data, keep: np.ndarray, epochs: int) -> np.ndarray:
    """The exact-sigmoid score test after `epochs` Newton steps from zero
    weights on [ones | covariates] (the first step's p is 1/2, as
    lr_newton_cov_only's first epoch without the intercept term), then the
    statistic of gwy_score_test (sfgwas_tpu/gwas/assoc.py:557-700, missing
    dosages read as 0): g^T (y~ - o) / sqrt(g^T W g - g^T W Z (Z^T W Z)^-1
    Z^T W g), with y~ = y - p and o = W Z (Z^T W Z)^-1 Z^T y~.  o is W Z
    times the next Newton step, so it vanishes only at convergence
    (scripts/check_example_oracle.py:93-116 leaves it out at its 50
    epochs); after 2 epochs, leaving it out put the oracle 1.41e-2 off the
    port's statistics on the card."""
    G = np.concatenate([data[1][0], data[2][0]])[:, keep].astype(np.float64)
    G[G < 0] = 0.0
    y = np.concatenate([data[1][1], data[2][1]])
    Z = np.column_stack([np.ones(len(y)), np.concatenate([data[1][2], data[2][2]])])
    beta = np.zeros(Z.shape[1])
    for _ in range(epochs):
        p = 1 / (1 + np.exp(-Z @ beta))
        w = p * (1 - p)
        beta = beta + np.linalg.solve(Z.T @ (Z * w[:, None]), Z.T @ (y - p))
    p = 1 / (1 + np.exp(-Z @ beta))
    w = p * (1 - p)
    ZW = Z * w[:, None]
    Hinv = np.linalg.inv(Z.T @ ZW)
    gzw = G.T @ ZW
    den = (w[:, None] * G * G).sum(0) - np.einsum("ij,jk,ik->i", gzw, Hinv, gzw)
    o = ZW @ (Hinv @ (Z.T @ (y - p)))
    return (G.T @ (y - p - o)) / np.sqrt(den)


def logistic_study_check(data, runs, n_loc: int, epochs: int) -> dict:
    """The revealed filters against the QC oracle, the statistics against
    the oracle of the same epochs and the converged one."""
    fresh = runs["fresh"]
    keep = assoc_qc_oracle(data, ASSOC_FILTER, n_loc)
    want = logistic_oracle(data, keep, epochs)
    conv = logistic_oracle(data, keep, LOGISTIC_CONVERGED_EPOCHS)
    checks = {"snps": int(len(keep)), "kept": int(keep.sum()),
              "cases": int(sum(data[p][1].sum() for p in (1, 2))),
              "oracle_epochs_vs_converged_max_abs_diff": float(np.abs(want - conv).max()),
              "fresh_filter_equal": {p: bool(np.array_equal(fresh["keep"][p], keep))
                                     for p in (1, 2)}}
    for pid in (1, 2):
        got = fresh["stats"][pid]
        ok = got.shape == want.shape
        checks[pid] = {
            "finite": bool(np.isfinite(got).all()),
            "max_abs_err": float(np.abs(got - want).max()) if ok else None,
            "corr": float(np.corrcoef(got, want)[0, 1]) if ok else None,
            "converged_max_abs_err": float(np.abs(got - conv).max()) if ok else None,
            "converged_corr": float(np.corrcoef(got, conv)[0, 1]) if ok else None,
        }
    return checks


def _logistic_study_runs(torch, seed: int, out_dir: str, n_loc: int = 1000,
                         sizes=LOGISTIC_BLOCKS, platform=None, overrides=None):
    """Phase 13's CLI run (_study_runs on config/configGlobalLogistic.toml
    with the epochs cut to LOGISTIC_RUN_EPOCHS; platform=None is the card).  A
    CPU rehearsal: platform="cpu" with a small n_loc and sizes and, in
    overrides, "ckks_params": "TEST8", num_inds and num_snps."""
    root = os.path.dirname(os.path.abspath(__file__))
    fields = {"num_snps": int(sum(sizes)), "epochs": LOGISTIC_RUN_EPOCHS}
    fields.update(overrides or {})
    return _study_runs(torch, seed, out_dir, n_loc, sizes, os.path.join(root, LOGISTIC_CONFIG),
                       platform=platform, overrides=fields, logistic=True)


# party 1's spans that split a logistic run: each Newton epoch, the score
# test's preparation and each score-test block (the spans that ended since
# the previous one of these are its parts)
LOGISTIC_SPLITS = ("lr_epoch", "score_prep", "score_block")


def logistic_spans(events) -> dict:
    """Party 1's span events (prof.events()) split per Newton epoch, the
    score test's preparation and per score-test block: each part's seconds
    by span name (the split span's own seconds under its name)."""
    parts = {k: [] for k in LOGISTIC_SPLITS}
    cur: dict = {}
    for name, secs in events or []:
        if name in LOGISTIC_SPLITS:
            cur[name] = cur.get(name, 0.0) + secs
            parts[name].append(cur)
            cur = {}
        else:
            cur[name] = cur.get(name, 0.0) + secs
    return {"epochs": parts["lr_epoch"], "score_prep": parts["score_prep"],
            "score_blocks": parts["score_block"]}


def logistic_study_phase(torch, seed: int, out_dir: str, kernels: list):
    """Phase 13: the logistic study through the CLI, cli.main with
    --local-sim 3 and no --platform (the card), at
    config/configGlobalLogistic.toml's width: PN14QP438, QC from the counts
    at its thresholds, cached keys, skip_pca, the degree-62 sigmoid on
    [-10, 10], inverse_mat_scale 10,000, 2 x 1000 individuals, 5
    covariates, the first of the config's 22 blocks and 1 of its 15
    Newton epochs; one fresh run.  Then K2 timed at its first launch at
    each row count (6: g^T W z B^T; 1: the squared block's g^T W g) and
    every other kernel at each shape of the run that no earlier phase
    checked.  Appends the kernels' records to `kernels`; returns the
    phase's record and, for phase 16, what each party's first SS inverse
    (the first Newton epoch's) started from and gave (_FirstCalls)."""
    from sfgwas_tpu_torch.crypto.params import get_params
    from sfgwas_tpu_torch.gwas import matmult as MM
    from sfgwas_tpu_torch.mpc import linalg as LA

    params = get_params("PN14QP438")
    n_loc, sizes = 1000, LOGISTIC_BLOCKS
    t_phase = time.time()
    inverses = _FirstCalls(LA, "matrix_inverse_sqrt_svd")  # the first, for phase 16
    try:
        data, runs = _logistic_study_runs(torch, seed, out_dir, n_loc, sizes)
    finally:
        inverses.restore()
    checks = logistic_study_check(data, runs, n_loc, LOGISTIC_RUN_EPOCHS)
    fresh = runs["fresh"]
    k2 = fresh["k2"]
    line = {
        "individuals": [0, n_loc, n_loc], "covariates": 5, "snps": int(sum(sizes)),
        "blocks": len(sizes), "config": LOGISTIC_CONFIG, "epochs": LOGISTIC_RUN_EPOCHS,
        "sigmoid": {"A": -10.0, "B": 10.0, "degree": 62}, "inverse_mat_scale": 10000.0,
        "phenotype": {"cov_effects": LOGISTIC_COV_EFFECTS, "snp_effects": LOGISTIC_SNP_EFFECTS},
        "reduced": {"snps": [int(sum(STUDY_BLOCKS)), int(sum(sizes))],
                    "blocks": [len(STUDY_BLOCKS), len(sizes)],
                    "epochs": [15, LOGISTIC_RUN_EPOCHS],
                    "why": "time: the whole script runs within its 1,200 s"},
        "checks": checks, "data_s": fresh["data_s"],
        "k2_inline_checks": {k: k2[k] for k in ("launches", "equal", "check_s")},
        "k2_launches_by_rows": dict(k2["launches_by_rows"]),
        "host_cpu": f"{_cpu_model()}, {os.cpu_count()} logical cores",
        "fresh": {k: fresh[k] for k in (
            "command_s", "protocol_party1", "protocol_party2", "init_s", "keys_from_cache",
            "peak_device_bytes", "peak_host_rss_bytes", "launches")},
    }
    line["fresh"]["spans_party1"] = fresh["spans_party1_host_clock"]
    line["fresh"]["logistic_party1"] = logistic_spans(fresh["events_party1"])
    _say(f"logistic study phase: {json.dumps(line)}")
    for pid, eq in checks["fresh_filter_equal"].items():
        if not eq:
            raise AssertionError(f"logistic run, party {pid}: the revealed SNP filter differs "
                                 "from the oracle")
    for pid in (1, 2):
        c = checks[pid]
        if (not c["finite"] or c["max_abs_err"] is None or not c["max_abs_err"] <= LOGISTIC_TOL
                or not c["corr"] > LOGISTIC_MIN_CORR
                or not c["converged_corr"] > LOGISTIC_CONVERGED_CORR):
            raise AssertionError(f"logistic party {pid}: statistics off: {c}")
    missing = [k for k in ASSOC_PATH if fresh["launches"][k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the logistic study's run: {missing}")
    want = LOGISTIC_K2_A_BLOCK * len(sizes) * 2
    if (fresh["launches"]["mac_dense"] != want or k2["launches"] != want
            or k2["equal"] != want or sorted(k2["by_rows"]) != [1, 6]):
        raise AssertionError(f"K2: {fresh['launches']['mac_dense']} launches, {k2['equal']} of "
                             f"{k2['launches']} equal to its plain version, rows "
                             f"{sorted(k2['by_rows'])}; want {want} at rows 1 and 6")
    rec = fresh.pop("rec")
    del runs
    for rows in sorted(k2["by_rows"]):
        R0, R1, polys, mruns, q, mu, logn, nacc = k2["by_rows"].pop(rows)
        _k2_check(torch, MM, kernels,
                  f"mac_dense (logistic, {rows} rows) {[mruns.nruns, int(mruns.run_start_host[-1])]}",
                  fresh["real_mac"], R0, R1, polys, mruns, q, mu, logn, nacc)
        kernels[-1].update(launches=fresh["launches"]["mac_dense"], path="logistic_study",
                           launches_at_shape=k2["launches_by_rows"][rows],
                           inline_equal_launches=k2["equal"])
        del R0, R1, polys, mruns
        torch.cuda.empty_cache()
    k2.pop("first", None)
    k1_shapes, k1_total, tree_shapes, _ = _collective_kernel_checks(
        torch, rec, fresh["launches"], params, kernels, "logistic_study", new_only=True)
    del rec
    line.update(k1_new_shapes_total_ms=k1_total, k1_shapes=k1_shapes, tree_shapes=tree_shapes,
                phase_s=time.time() - t_phase)
    return line, inverses.snaps


# ---------------------------------------------------------------------------
# 15. within-party sharding: the sharded product and the routed study

# logical shards of the one card: the sharded branch runs every step it runs
# on two devices, and its copies between them are no-ops
SHARD_DEVICES = 2
SHARD_LABEL = "two logical shards on one card, no cross-device copy"
SHARD_REPS = 3  # timed calls of each product mode
# phase 3's block placed as this many block columns: the product's columns
# go to shard slots bj % SHARD_DEVICES
WIDE_COLUMNS = 2


def shard_phase(torch, cps, A, cache, dense_out, kernels: list, out_dir: str) -> dict:
    """Phase 15 (b, c) on phase 3's block product (PN14QP438, the 1000 x
    4546 int8 block, 8 encrypted columns): (b) mat_mult_sharded over two
    logical shards of the card on phase 3's cache (one block column: every
    chunk on slot 0) and on WIDE, that block twice as two block columns
    (column bj on slot bj % 2: a real split), unsharded, sharded and
    through the pipeline routing; every output ciphertext bit-equal to
    phase 3's.  The two-column product is timed unsharded and sharded over
    SHARD_REPS calls each, the sharded one also stage by stage
    (synchronized spans) and traced (no device value read back), with K1
    and K3 held at its new shapes; (c) K2 at each shard slot's launch
    against its plain version on fresh accumulators (the first timed, the
    other compared).  Appends the kernels' records to `kernels`; returns
    the phase's record."""
    from sfgwas_tpu_torch.crypto.params import get_params
    from sfgwas_tpu_torch.gwas import matmult as MM
    from sfgwas_tpu_torch.ops import cuda_build, rns
    from sfgwas_tpu_torch.utils import prof

    global TIMING
    ctx = cps.ctx
    dev = ctx.device
    params = get_params("PN14QP438")
    shards = [dev] * SHARD_DEVICES
    nmod, s, logn = MM.mm_nmod(cps), len(A), ctx.params.logn
    wide = [[cache[0][0]] * WIDE_COLUMNS]
    t_phase = time.time()

    def equal(out):
        # every block column of `out` is phase 3's one output column
        return all(_same(torch, a.c0, rb[0].c0) and _same(torch, a.c1, rb[0].c1)
                   for ra, rb in zip(out, dense_out) for a in ra)

    def seconds(fn):
        ts = []
        for _ in range(SHARD_REPS):
            torch.cuda.synchronize()
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            ts.append(time.time() - t0)
        return {"mean_s": float(np.mean(ts)), "spread_s": float(max(ts) - min(ts)), "calls_s": ts}

    def unsharded():
        return MM.mat_mult_cached(cps, A, wide)

    def sharded():
        return MM.mat_mult_sharded(cps, A, wide, devices=shards)

    # (b) equality, then the timed calls; the launch counts of the phase's
    # products are set to 0 before and read after
    cuda_build.reset_launch_counts()
    eq = {"one_column_sharded": equal(MM.mat_mult_sharded(cps, A, cache, devices=shards)),
          "two_columns": equal(unsharded()), "two_columns_sharded": equal(sharded())}
    MM.set_pipeline_devices(shards)
    try:
        eq["two_columns_routed"] = equal(MM.mat_mult_cached(cps, A, wide))
    finally:
        MM.set_pipeline_devices(None)
    times = {"unsharded": seconds(unsharded), "sharded": seconds(sharded)}
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in cuda_build.REGISTRY.items()}
    per_product = {}
    for name, fn in (("unsharded", unsharded), ("sharded", sharded)):
        cuda_build.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        per_product[name] = {k: v.launches for k, v in cuda_build.REGISTRY.items()}
    _say(f"shard phase: ciphertexts equal to phase 3's {json.dumps(eq)}; two block columns "
         f"({SHARD_LABEL}) {json.dumps(times)}")
    if not all(eq.values()):
        raise AssertionError(f"a sharded product differs from phase 3's: {eq}")
    missing = [k for k in SHARD_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the sharded products: {missing}")
    # K2 launches per product: one a block row unsharded, one a shard slot
    # that holds chunks sharded
    plan = MM._plan_for(cps, wide, nmod, row_batch=s)
    want = {"unsharded": 1, "sharded": len(plan.groups(shards)[0])}
    if want["sharded"] != SHARD_DEVICES or any(
            per_product[m]["mac_dense"] != want[m] for m in want):
        raise AssertionError(f"K2 launches per product {per_product}; want {want}")
    # the sharded product's spans, each ended by a synchronize
    prof.ENABLED, prof.SYNC = True, torch.cuda.synchronize
    prof.reset()
    try:
        sharded()
        spans = {k: v[0] for k, v in prof.totals().items()}
    finally:
        prof.ENABLED, prof.SYNC = False, None
    profiled = _profile(torch, sharded, os.path.join(out_dir, "shard_profile.txt"))
    if profiled["host_readbacks"]:
        raise AssertionError(f"the sharded product read {profiled['host_readbacks']} device "
                             "values back to the host")
    # K1 and K3 at the two-column product's shapes (its giant step rotates
    # twice phase 3's segments)
    rec = _collective_recorder(k3=True)
    cuda_build.reset_launch_counts()
    try:
        sharded()
        torch.cuda.synchronize()
    finally:
        rec.restore()
    rec_launches = {k: v.launches for k, v in cuda_build.REGISTRY.items()}
    k1_shapes, k1_total, tree_shapes, equal_only = _collective_kernel_checks(
        torch, rec, rec_launches, params, kernels, "sharded_product", new_only=True,
        timed_per_kernel=1)
    del rec

    # (c) K2 at each shard slot's launch, on fresh accumulators as the
    # sharded product runs it: the first timed, the other compared
    q = ctx._t(range(nmod))["q"]
    mu = rns.barrett_mu64(ctx.basis, range(nmod), dev)
    nacc = len(plan.segments) + 1
    R0, R1 = MM.baby_rotations(cps, A, plan, 0)
    compared: list = []
    for slot, g in enumerate(plan.groups(shards)[0]):
        TIMING = slot == 0
        try:
            _k2_check(torch, MM, kernels if slot == 0 else compared,
                      f"mac_dense (shard slot {slot} of {SHARD_DEVICES}, {s} rows)",
                      MM.mac_dense, R0, R1, g["polys"], g["runs"], q, mu, logn, nacc,
                      replaces="sfgwas_tpu/gwas/matmult.py:397")
        finally:
            TIMING = True
    kernels[-1].update(launches=launches["mac_dense"], path="sharded_product",
                       launches_per_mat_mult=per_product["sharded"]["mac_dense"])
    slot_checks = [{"shape": k["shape"], "bit_equal": k["bit_equal"], "ms": k["ms"],
                    "bound_ms": k["bound_ms"]} for k in (kernels[-1], *compared)]
    del R0, R1, plan
    torch.cuda.empty_cache()
    _say(f"shard slot K2 checks: {json.dumps(slot_checks)}")
    if not all(k["bit_equal"] for k in slot_checks):
        raise AssertionError(f"K2 at a shard slot differs from its plain version: {slot_checks}")
    return {
        "label": SHARD_LABEL, "devices": [str(d) for d in shards], "preset": "PN14QP438",
        "block": [1000, 4546], "block_columns": WIDE_COLUMNS, "columns": s, "nmod": nmod,
        "equal_to_phase3": eq, "secs_per_product": times,
        "launches": launches, "launches_per_product": per_product,
        "sharded_spans_s": spans, "sharded_profile": profiled,
        "k1_new_shapes_timed_total_ms": k1_total, "k1_shapes": k1_shapes,
        "compared_without_timing": equal_only, "slot_checks": slot_checks,
        "tree_shapes": tree_shapes, "phase_s": time.time() - t_phase,
    }


def routed_study_check(rt: dict) -> dict:
    """Phase 15 (d)'s filters against the QC oracle, its statistics against
    the plaintext oracle, against its unsharded twin (the same caches and
    seeds: bit for bit) and, for the record, against phase 10's resumed run
    (the same keys, filter and basis, but its block products from run 1's
    cache and its own draws: they differ in the last printed digits), and
    its block products against run 1's: the basis rows bit for bit; the y~
    row carries this run's own bootstrap draw."""
    data, run, n_loc = rt["data"], rt["run"], rt["n_loc"]
    want_keep = assoc_qc_oracle(data, ASSOC_FILTER, n_loc)
    want = assoc_stat_oracle(data, want_keep)
    checks = {"filter_equal": {p: bool(np.array_equal(run["keep"][p], want_keep))
                               for p in (1, 2)}}
    for pid in (1, 2):
        got, res = run["stats"][pid], rt["resumed_stats"][pid]
        ok = got.shape == want.shape == res.shape
        checks[pid] = {
            "finite": bool(np.isfinite(got).all()),
            "max_abs_err": float(np.abs(got - want).max()) if ok else None,
            "corr": float(np.corrcoef(got, want)[0, 1]) if ok else None,
            "twin_bit_equal": bool(np.array_equal(got, rt["twin"]["stats"][pid])),
            "resumed_bit_equal": bool(ok and np.array_equal(got, res)),
            "resumed_max_abs_diff": float(np.abs(got - res).max()) if ok else None,
        }
    checks["products_vs_run1"] = run["products_vs_run1"]
    return checks


def routed_study_phase(torch, rt: dict, kernels: list) -> dict:
    """Phase 15 (d): the skip-PCA study with every product routed over two
    logical shards of the card (shard_matmult = true in the config, the
    protocol's local_devices giving the two shards), and its unsharded
    twin on the same caches and seeds, run by phase 10's _study_runs after
    phase 14's run: the keys, the QC filter and run 1's basis restored
    from the caches, the block products computed again.  Checks it, then holds every kernel against
    its plain version at each shape of the run that no earlier phase
    checked.  Appends the kernels' records to `kernels`; returns the
    phase's record."""
    from sfgwas_tpu_torch.crypto.params import get_params

    params = get_params("PN14QP438")
    t_phase = time.time()
    run, sizes = rt["run"], rt["sizes"]
    checks = routed_study_check(rt)
    k2 = run["k2"]
    line = {
        "individuals": [0, rt["n_loc"], rt["n_loc"]], "covariates": 5,
        "snps": int(sum(sizes)), "blocks": len(sizes), "config": STUDY_CONFIG,
        "label": SHARD_LABEL,
        "run": "a fourth run of phase 10's _study_runs, after phase 14's: the resumed config "
               "with the keys, the QC filter and run 1's basis restored from the caches, the "
               "block products computed again, shard_matmult = true with the protocol's "
               "local_devices giving [cuda:0, cuda:0], the routing reset after",
        "reduced": {"snps": [int(sum(STUDY_BLOCKS)), int(sum(sizes))],
                    "blocks": [len(STUDY_BLOCKS), len(sizes)],
                    "why": "time: the whole script runs within its 1,200 s"},
        "checks": checks, "sharded_products": run["sharded_products"],
        "twin": {"command_s": rt["twin"]["command_s"],
                 "sharded_products": rt["twin"]["sharded_products"],
                 "run": "the same caches and seeds, the resumed config without shard_matmult"},
        "k2_inline_checks": {k: k2[k] for k in ("launches", "equal", "check_s")},
        "k2_launches_by_rows": dict(k2["launches_by_rows"]),
        "assoc_s_party1": run["protocol_party1"].get("assoc_s"),
    }
    line.update({k: run[k] for k in (
        "command_s", "protocol_party1", "protocol_party2", "init_s", "keys_from_cache",
        "spans_party1_host_clock", "peak_device_bytes", "peak_host_rss_bytes", "launches")})
    _say(f"routed study phase: {json.dumps(line)}")
    for pid, eq in checks["filter_equal"].items():
        if not eq:
            raise AssertionError(f"routed run, party {pid}: the SNP filter differs from the "
                                 "oracle")
    for pid in (1, 2):
        c = checks[pid]
        if (not c["finite"] or c["max_abs_err"] is None or not c["max_abs_err"] <= ASSOC_STAT_TOL
                or not c["corr"] > ASSOC_MIN_CORR or not c["twin_bit_equal"]):
            raise AssertionError(f"routed party {pid}: statistics off: {c}")
        prod = checks["products_vs_run1"][pid]
        if prod["blocks"] != len(sizes) or not prod["basis_rows_equal"]:
            raise AssertionError(f"routed party {pid}: the block products' basis rows differ "
                                 f"from run 1's: {prod}")
    missing = [k for k in ASSOC_PATH if run["launches"][k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the routed run: {missing}")
    nblocks = len(sizes)
    if run["sharded_products"] != 2 * nblocks or rt["twin"]["sharded_products"] != 0:
        raise AssertionError(f"{run['sharded_products']} products took the sharded branch "
                             f"({rt['twin']['sharded_products']} in the twin); want "
                             f"{2 * nblocks} (0)")
    if run["launches"]["mac_dense"] != k2["launches"] or k2["equal"] != k2["launches"]:
        raise AssertionError(f"K2: {run['launches']['mac_dense']} launches, {k2['equal']} of "
                             f"{k2['launches']} equal to its plain version")
    if sorted(run["keys_from_cache"]) != [0, 1, 2] or not all(run["keys_from_cache"].values()):
        raise AssertionError(f"bundles from the key cache: {run['keys_from_cache']}")
    rec = run.pop("rec")
    k1_shapes, k1_total, tree_shapes, equal_only = _collective_kernel_checks(
        torch, rec, run["launches"], params, kernels, "routed_study", new_only=True,
        timed_per_kernel=HH_TIMED_SHAPES)
    del rec
    line.update(k1_new_shapes_timed_total_ms=k1_total, k1_shapes=k1_shapes,
                compared_without_timing=equal_only, tree_shapes=tree_shapes,
                phase_s=time.time() - t_phase)
    return line


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tree", metavar="DIR",
                    help="time only K1, K4, bs_mask and K6 of the package under DIR")
    ap.add_argument("--shapes", metavar="FILE", help="their shapes (a full run's shapes.json)")
    ap.add_argument("--pca-probe", action="store_true",
                    help="only the in-vivo bisect of PCA (pca_probe): decrypts around its steps")
    # phase 11 starts each party as this script with these (PID in the environment)
    ap.add_argument("--party-run", choices=("fresh", "resumed"), help=argparse.SUPPRESS)
    ap.add_argument("--party-dir", help=argparse.SUPPRESS)
    ap.add_argument("--config-global", help=argparse.SUPPRESS)
    ap.add_argument("--config-local", help=argparse.SUPPRESS)
    ap.add_argument("--party-platform", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if bool(args.tree) != bool(args.shapes):
        ap.error("--tree and --shapes go together")

    import torch

    if args.party_run:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return party_main(torch, args)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if args.tree:
        return tree_only(torch, args.tree, args.shapes)
    if args.pca_probe:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from sfgwas_tpu_torch.ops import cuda_build

        _say(_smi())
        cuda_build.build()
        out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
        os.makedirs(out, exist_ok=True)
        pca_probe(torch, args.seed, out)
        return 0
    t_script = time.time()
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

    # ---- 3. the main path; K4's launches (rotation keygen) recorded at its
    # wrapper for phase 5
    k4_rec = _Recorder()
    k4_rec.wrap(C, "uniform_mod", "uniform_mod", lambda q, mu, sd, idx, b, logn: (b, q.shape[0]))
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
    try:
        cps.rot_keys.update(ctx.gen_rot_keys_batched(sk, gels, rng, key_nmod=params.mm_nmod))
        torch.cuda.synchronize()
    finally:
        k4_rec.restore()
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
    if sum(k4_rec.counts.values()) != launches["uniform_mod"]:
        raise AssertionError("K4 launched on the main path outside the rotation keygen")
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
    missing = [k for k in MM_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    # launches of one mat_mult_cached call
    cuda_build.reset_launch_counts()
    out = MM.mat_mult_cached(cps, A, cache)
    torch.cuda.synchronize()
    per_call = {k: v.launches for k, v in cuda_build.REGISTRY.items()}
    _say(f"launches: main path {json.dumps(launches)}; one mat_mult_cached {json.dumps(per_call)}")
    # K1's (direction, prime rows, shape) in one call, recorded at its wrapper
    k1_rec = _Recorder()
    k1_rec.wrap(cuda_ntt, "ntt_b_kernel", "k1", _k1_key)
    try:
        MM.mat_mult_cached(cps, A, cache)
        torch.cuda.synchronize()
    finally:
        k1_rec.restore()
    k1_shapes = k1_rec.k1_shapes()
    del k1_rec
    for sym, inv in (("ntt_fwd", False), ("ntt_inv", True)):
        if sum(n for i, _, _, n in k1_shapes if i == inv) != per_call[sym]:
            raise AssertionError(f"K1 shapes recorded {k1_shapes} miss launches of {sym}")
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
    # K4 at the rotation keygen's draws
    k4_shapes = _k4_rows(torch, C, k4_rec, params.basis, kernels)
    del k4_rec
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
        _k3_check(torch, C, kernels, name,
                  "sfgwas_tpu/crypto/ckks.py:993" if k0.shape[1] > 1
                  else "sfgwas_tpu/crypto/ckks.py:1050",
                  ext, k0, k1, q_ext, mu_ext, logn, C.ks_digit_product, reps, preps)

    ext = ctx.decompose_ntt_b(C1s, nmod).contiguous()[None]
    ks_check("ks_digit_product (hoisted)", ext, ik0[None], ik1[None], 10, 2)
    del ext

    # K2 at the real block row: the baby rotations of A and the whole cache
    R0, R1 = MM.baby_rotations(cps, A, plan, 0)
    (g,) = plan.groups()[0]
    q_mm = ctx._t(range(nmod))["q"]
    mu_mm = rns.barrett_mu64(params.basis, range(nmod), dev)
    runs = g["runs"]
    nacc = len(plan.segments) + 1
    _k2_check(torch, MM, kernels, "mac_dense", MM.mac_dense, R0, R1, g["polys"], runs, q_mm,
              mu_mm, logn, nacc)
    # the real accumulators of this block row, for K3's grouped shape
    acc_shape = (nacc, ncols, nmod, N)
    zeros = lambda: torch.zeros(acc_shape, dtype=torch.int32, device=dev)  # noqa: E731
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
        k["launches"], k["path"] = launches[k["kernel"]], "block_product"
        k.setdefault("launches_per_mat_mult", per_call[k["kernel"]])
    del pout, pcps, plan, gi, ig0, ig1, ik0, ik1, C1s
    torch.cuda.empty_cache()

    # ---- 15 (b, c). within-party sharding on the block product
    shard = shard_phase(torch, cps, A, cache, out, kernels, out_dir)
    del cache, A, out, cps
    torch.cuda.empty_cache()

    # ---- 6. the MHE collective layer
    mhe = mhe_phase(torch, args.seed, out_dir, kernels)
    # ---- 7. the SS domain and the SS<->HE bridge
    ss, sqrt_snaps = ss_phase(torch, args.seed, out_dir, kernels)
    # ---- 8. the CholeskyQR2 covariate basis
    qr = qr_phase(torch, args.seed, out_dir, kernels)
    # ---- 9. the linear association phase
    assoc = assoc_phase(torch, args.seed, out_dir, kernels)
    # ---- 10. the study through the CLI, fresh and resumed
    study, hh, rt = study_phase(torch, args.seed, out_dir, kernels)
    # ---- 14. the Householder study, run inside phase 10 after its resumed run
    householder_study = householder_study_phase(torch, hh, kernels)
    del hh
    # ---- 15 (d). the study with every product routed over two logical
    # shards, run inside phase 10 after phase 14's run
    routed_study = routed_study_phase(torch, rt, kernels)
    del rt
    # ---- 11. the study as three party processes over loopback TCP
    tcp_study = tcp_study_phase(torch, args.seed, out_dir, kernels, sizes=TCP_BLOCKS,
                                overrides={"num_snps": int(sum(TCP_BLOCKS))})
    # ---- 12. the default-config study with PCA through the CLI
    pca_study = pca_study_phase(torch, args.seed, out_dir, kernels)
    # ---- 13. the logistic study through the CLI
    logistic_study, inverse_snaps = logistic_study_phase(torch, args.seed, out_dir, kernels)
    # ---- 16. the SS domain's device mode: phase 7's square root and phase
    # 13's first inverse replayed with the shares on the card
    ss_device = ss_device_phase(torch, sqrt_snaps, inverse_snaps, kernels)
    del sqrt_snaps, inverse_snaps
    # the shapes --tree times: K1's of one product, K4's of every path,
    # bs_mask's and K6's of the collective phases
    shapes = {"preset": "PN14QP438", "k1": k1_shapes, "uniform_mod": k4_shapes, "bs_mask": [],
              "crt_lift": []}
    for phase in (shard, mhe, ss, qr, assoc, study, householder_study, routed_study, tcp_study,
                  pca_study, logistic_study):
        for key, found in phase.pop("tree_shapes").items():
            shapes[key] += [s for s in found if s not in shapes[key]]
    with open(os.path.join(out_dir, "shapes.json"), "w") as f:
        json.dump(shapes, f)
    sass = _sass(cuda_build, ("crp", "bs_share", "crt_lift"), out_dir, "main")
    for fn, v in sass.items():
        _say(f"sass {fn[:60]}: {v['instructions']} instructions, {json.dumps(v['ops'])}")

    _say("kernel checks: " + ", ".join(
        f"{k['name']} equal={k['bit_equal']} {k['ms']:.4f} ms on the device (call "
        f"{k['call_ms']:.4f} ms, plain {k['plain_ms']:.3f} ms, bound {k['bound_ms']:.4f} ms by "
        f"{k['bound_by']})" for k in kernels))
    bad = [k["name"] for k in kernels if not k["bit_equal"]]
    if bad:
        raise AssertionError(f"kernels differ from their plain versions: {bad}")

    record = {
        "kernels": kernels,
        "card": smi,
        "max_sm_clock_mhz": max_sm_mhz,
        "sm_count": torch.cuda.get_device_properties(0).multi_processor_count,
        "ptxas": ptxas,
        "sass": sass,
        "main_path": {
            "preset": "PN14QP438", "block": [n_ind, n_snp], "columns": ncols,
            "diagonals": k_total, "nmod": nmod, "rotation_keys": len(gels),
            "secs_per_block_product": dt, "gmac_per_s": gmacs, "max_abs_err": err,
            "preprocess_s": t_pre, "rotation_keygen_s": t_keys, "path_s": t_main,
            "kernel_vs_plain_ciphertexts_equal": same,
        },
        "profile": profiled,
        "k1_total_ms": k1_total,
        "mhe": mhe,
        "ss": ss,
        "ss_device": ss_device,
        "qr": qr,
        "assoc": assoc,
        "study": study,
        "tcp_study": tcp_study,
        "pca_study": pca_study,
        "logistic_study": logistic_study,
        "householder_study": householder_study,
        "shard": shard,
        "routed_study": routed_study,
        "k5_launches_by_nwords": K5_BY_PATH,
    }
    record["script_s"] = time.time() - t_script
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    _say(f"script: {record['script_s']:.1f} s from its start to its record, the build included")
    _say(json.dumps({"kernels": kernels}))
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
