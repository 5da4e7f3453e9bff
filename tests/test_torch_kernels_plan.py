"""What surrounds the port's kernels K2 (dense MAC) and K3 (keyswitch digit
product), on the CPU: the plan's CSR entry list, the plain MAC on it against
the padded-chunk semantics of the reference, a numpy model of the kernels'
Barrett step, and wrappers that validate their launches without reading
anything back from the device."""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sfgwas_tpu_torch.crypto import ckks as PC
from sfgwas_tpu_torch.crypto.params import PRESETS, get_params, prime_chain
from sfgwas_tpu_torch.gwas import matmult as PMM
from sfgwas_tpu_torch.ops import rns

M32 = np.uint64(0xFFFFFFFF)


def _blocks_plan(slots, n, nmod, q_primes, shape, row_batch, polys_device="meta"):
    """A dense plan for a matrix of `shape` in blocks of `slots`, built from
    the diagonal index sets alone (no encode): every block's polys are an
    uninitialised tensor of the right shape."""
    d = int(math.ceil(math.sqrt(slots)))
    cache = []
    for bi in range(0, shape[0], slots):
        row = []
        for bj in range(0, shape[1], slots):
            r, c = min(slots, shape[0] - bi), min(slots, shape[1] - bj)
            sh = PMM.block_shifts(slots, r, c)
            polys = torch.empty((len(sh), nmod, n), dtype=torch.int32, device=polys_device)
            row.append(PMM.DiagBlock(sh // d, sh % d, polys, d))
        cache.append(row)
    cps = SimpleNamespace(
        ctx=SimpleNamespace(n=n, device=torch.device("cpu")),
        params=SimpleNamespace(q_primes=q_primes),
    )
    return PMM._MatmulPlan(cps, cache, nmod, row_batch=row_batch), cache


def test_csr_entries_are_the_unpadded_chunk_pairs_at_pn14():
    """The PN14 block of chip_smoke.py (1000 x 4546, 8 rows, nmod 7): 62
    segments, 61 rotated; 123 chunks padded to 73; the CSR list holds the
    5,545 (diagonal, baby) pairs once each, in 62 runs, each of one segment."""
    spec = PRESETS["PN14QP438"]
    q_primes, _ = prime_chain(spec)
    nmod, n, slots = 7, 1 << spec.logn, 1 << (spec.logn - 1)
    plan, cache = _blocks_plan(slots, n, nmod, q_primes, (1000, 4546), row_batch=8)
    blk = cache[0][0]
    assert plan.nbr == plan.nbc == 1 and blk.num_diags == 5545
    assert len(plan.segments) == 62
    assert sum(g > 0 for _, g in plan.segments) == 61
    assert len(plan.chunks[0]) == 123 and plan.k_pad == 73
    padded = sum(len(c["bidx"]) for c in plan.chunks[0])
    assert padded == 123 * 73 == 8979
    (g,) = plan.groups()[0]
    runs = g["runs"]
    assert runs.nruns == 62 and runs.run_start_host[-1] == 5545
    assert list(g["chunk_start"][[0, -1]]) == [0, 123]
    diag = runs.entry_diag.numpy()
    baby = runs.entry_baby.numpy()
    # exactly the chunks' unpadded pairs, in order
    want_d = np.concatenate([np.arange(c["k0"], c["k1"]) for c in plan.chunks[0]])
    want_b = np.concatenate([c["bidx"][: c["k1"] - c["k0"]] for c in plan.chunks[0]])
    assert np.array_equal(diag, want_d) and np.array_equal(baby, want_b)
    assert np.array_equal(np.sort(diag), np.arange(5545))
    babies = np.array(plan.babies[0])
    assert len(babies) == 91 and np.array_equal(babies[baby], blk.babies[diag])
    starts = runs.run_start_host
    assert runs.longest == np.diff(starts).max() == 91
    for r, sg in enumerate(runs.run_sg_host):
        bj, giant = plan.segments[sg]
        assert bj == 0 and set(blk.giants[diag[starts[r]:starts[r + 1]]]) == {giant}


def _rand_residues(rng, q, shape):
    """uint32 residues below each row's prime: q [nmod], shape [..., nmod, N]."""
    return (rng.integers(0, 1 << 40, size=shape) % q[:, None]).astype(np.int64)


def test_mac_dense_plain_csr_matches_padded_chunks(monkeypatch):
    """At TEST8 (2 x 2 blocks of 128 slots, a chunk budget of 5 diagonals so
    that giant groups split and chunks pad), the plain MAC on the CSR list
    gives the ACC of the reference's padded chunks: k_pad entries per chunk,
    padding entries indexing diagonal 0 and the all-zero rotation nb_pad."""
    params = get_params("TEST8")
    nmod, n, s = 5, params.n, 2
    q = np.array(params.q_primes[:nmod], np.int64)
    monkeypatch.setattr(PMM, "MM_CHUNK_BYTES", 5 * nmod * n * 4 * s)
    plan, cache = _blocks_plan(params.slots, n, nmod, params.q_primes, (200, 150), s, "cpu")
    rng = np.random.default_rng(4)
    acc_shape = (len(plan.segments) + 1, s, nmod, n)
    qt = torch.from_numpy(q.astype(np.int32))[:, None]
    split = False
    for bi, row in enumerate(plan.groups()):
        (g,) = row
        split |= bool(np.diff(g["chunk_start"]).max() > 1)
        K = g["polys"].shape[0]
        polys = _rand_residues(rng, q, (K, nmod, n))
        nb = len(plan.babies[bi])
        R = [_rand_residues(rng, q, (nb, s, nmod, n)) for _ in range(2)]
        # the padded-chunk semantics, in numpy
        want = [np.zeros(acc_shape, np.int64) for _ in range(2)]
        offs, tot = {}, 0
        for c in plan.chunks[bi]:
            if id(c["blk"]) not in offs:
                offs[id(c["blk"])] = tot
                tot += c["blk"].num_diags
        for c in plan.chunks[bi]:
            k = c["k1"] - c["k0"]
            idx = np.zeros(plan.k_pad, np.int64)
            idx[:k] = offs[id(c["blk"])] + np.arange(c["k0"], c["k1"])
            for comp in range(2):
                Rp = np.concatenate([R[comp], np.zeros((plan.nb_pad + 1 - nb,) + R[comp].shape[1:],
                                                       np.int64)])
                terms = Rp[c["bidx"]] * polys[idx][:, None] % q[:, None]
                want[comp][c["sg"]] = (want[comp][c["sg"]] + terms.sum(0)) % q[:, None]
        ACC = [torch.zeros(acc_shape, dtype=torch.int32) for _ in range(2)]
        g = dict(g, polys=torch.from_numpy(polys.astype(np.int32)))
        PMM.mac_dense_plain(ACC[0], ACC[1], torch.from_numpy(R[0].astype(np.int32)),
                            torch.from_numpy(R[1].astype(np.int32)), g["polys"], g["runs"], qt)
        for comp in range(2):
            assert np.array_equal(ACC[comp].numpy(), want[comp])
    assert split and plan.k_pad > 1


def _umulhi64(a, b):
    """High 64 bits of the 128-bit product of uint64 arrays (32-bit limbs)."""
    a_lo, a_hi = a & M32, a >> np.uint64(32)
    b_lo, b_hi = b & M32, b >> np.uint64(32)
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    mid = (ll >> np.uint64(32)) + (lh & M32) + (hl & M32)
    return hh + (lh >> np.uint64(32)) + (hl >> np.uint64(32)) + (mid >> np.uint64(32))


def _barrett64_model(a, q, mu):
    """The kernels' reduction of a 64-bit sum: qhat = umulhi(a, mu), the
    remainder a - qhat*q taken in 32 bits, one conditional subtract."""
    qhat = _umulhi64(a, np.full_like(a, mu))
    r = ((a & M32) - (qhat & M32) * np.uint64(q)) & M32
    return np.where(r >= np.uint64(q), r - np.uint64(q), r)


def test_barrett64_model_equals_mod_for_every_preset_prime():
    rng = np.random.default_rng(8)
    primes, built = set(), []
    for name, spec in PRESETS.items():
        try:
            qs, sp = prime_chain(spec)
        except RuntimeError:  # PN16QP1761: too few 25-bit NTT primes, in both packages
            continue
        primes.update(qs + [sp])
        built.append(name)
    assert len(built) == len(PRESETS) - 1 and len(primes) > 50
    for q in sorted(primes):
        assert q < 1 << 26
        mu = (1 << 64) // q
        top = PMM.MAC_MAX_TERMS * (q - 1) ** 2
        assert top < 1 << 64
        sums = [0, q - 1, q, 2 * q, 7 * q, (1 << 40) // q * q, top, top - 1, (1 << 64) - 1,
                (1 << 64) - 1 - q]
        a = np.concatenate([
            np.array(sums, dtype=np.uint64),
            rng.integers(0, 1 << 63, size=64, dtype=np.uint64) * np.uint64(2)
            + rng.integers(0, 2, size=64, dtype=np.uint64),
        ])
        assert np.array_equal(_barrett64_model(a, q, mu), a % np.uint64(q)), q
    basis = get_params("TEST8").basis
    rows = range(len(basis.primes))
    assert rns.barrett_mu64(basis, rows, "cpu").tolist() == [
        (1 << 64) // q for q in basis.primes
    ]


class _Poison:
    """A stand-in for a device tensor that fails on any use."""

    def __getattr__(self, name):
        raise AssertionError(f"read the device run_start ({name})")


def test_mac_dense_reads_runs_only_from_the_host():
    """On the CPU path the wrapper walks the runs by the plan's host copy
    (the device run_start is never touched); on the card path its checks
    read only metadata: every input on the meta device, which holds no
    data, passes them, and a run longer than MAC_MAX_TERMS is refused from
    the host copy alone."""
    basis = get_params("TEST8").basis
    rows = (0, 1)
    q = rns._sel(basis, rows, "cpu")["q"]
    mu = rns.barrett_mu64(basis, rows, "cpu")
    rng = np.random.default_rng(3)
    R = torch.from_numpy(_rand_residues(rng, np.array(basis.primes[:2]), (3, 2, 2, basis.n))
                         .astype(np.int32))
    polys = torch.from_numpy(_rand_residues(rng, np.array(basis.primes[:2]), (4, 2, basis.n))
                             .astype(np.int32))
    runs = PMM.MacRuns.from_host([0, 1, 2, 3], [2, 0, 1, 1], [0, 3, 4], [1, 0], "cpu")
    want = PMM.mac_dense_plain(torch.zeros((2, 2, 2, basis.n), dtype=torch.int32),
                               torch.zeros((2, 2, 2, basis.n), dtype=torch.int32),
                               R, R, polys, runs, q)
    runs.run_start = _Poison()
    got = PMM.mac_dense(torch.zeros((2, 2, 2, basis.n), dtype=torch.int32),
                        torch.zeros((2, 2, 2, basis.n), dtype=torch.int32),
                        R, R, polys, runs, q, mu, basis.logn)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    def meta(t):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")

    mruns = PMM.MacRuns.from_host([0, 1, 2, 3], [2, 0, 1, 1], [0, 3, 4], [1, 0], "meta")
    acc = torch.empty((2, 2, 2, basis.n), dtype=torch.int32, device="meta")
    args = (acc, acc, meta(R), meta(R), meta(polys), mruns, meta(q), meta(mu), basis.logn)
    assert PMM._mac_dense_shape(*args) == (3, 2, 2)
    mruns.longest = PMM.MAC_MAX_TERMS + 1
    with pytest.raises(ValueError, match="terms in a run"):
        PMM._mac_dense_shape(*args)
    with pytest.raises(ValueError, match="int64"):
        PMM._mac_dense_shape(*args[:7], meta(q), basis.logn)


def test_ks_digit_checks_read_only_metadata():
    """K3's checks on the meta device: they pass for a good shape, refuse a
    digit count with no kernel instance, and a ring size that is not
    2^logn."""
    X, N = 3, 1 << 8

    def t(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    q, mu = t(X, 1), t(X, dtype=torch.int64)
    for G, S, Bk, J in ((1, 8, 90, 7), (61, 8, 1, 7), (2, 3, 17, PC.KS_MAX_DIGITS)):
        ext, key = t(G, S, J, X, N), t(G, Bk, J, X, N)
        assert PC._ks_digit_shape(ext, key, key, q, mu, 8) == (G, S, Bk, J, X, N)
    J = PC.KS_MAX_DIGITS + 1
    with pytest.raises(ValueError, match="digits"):
        PC._ks_digit_shape(t(1, 1, J, X, N), t(1, 1, J, X, N), t(1, 1, J, X, N), q, mu, 8)
    with pytest.raises(ValueError, match="is not 2"):
        PC._ks_digit_shape(t(1, 1, 2, X, 64), t(1, 1, 2, X, 64), t(1, 1, 2, X, 64), q, mu, 7)


def test_ptxas_report_reads_registers_and_spills(tmp_path, monkeypatch):
    """chip_smoke.py fails a run on a spill in any kernel, or a stack frame
    in K1, from this report."""
    from sfgwas_tpu_torch.ops import cuda_build

    log = tmp_path / "libks_digit-0.so.log"
    log.write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z9kernelILi7EEvPj' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z9kernelILi7EEvPj\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 74 registers, used 1 barriers, 392 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z9kernelILi24EEvPj' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z9kernelILi24EEvPj\n"
        "    8 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 255 registers, 1024 bytes smem, 392 bytes cmem[0]\n"
    )
    monkeypatch.setattr(cuda_build, "_target", lambda name: tmp_path / f"lib{name}-0.so")
    rep = cuda_build.ptxas_report("ks_digit")
    assert [(k["kernel"], k["registers"], k["stack"], k["spill_stores"], k["spill_loads"],
             k["smem"]) for k in rep] == [("_Z9kernelILi7EEvPj", 74, 0, 0, 0, 0),
                                         ("_Z9kernelILi24EEvPj", 255, 8, 8, 12, 1024)]
    assert cuda_build.ptxas_report("mac_dense") == []


def test_build_target_follows_shared_headers(tmp_path, monkeypatch):
    """A library is named by its source, the shared headers and the flags,
    so an edit of csrc/common.cuh rebuilds every kernel that includes it."""
    from sfgwas_tpu_torch.ops import cuda_build

    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// a\n")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    first = cuda_build._target("k")
    assert cuda_build._target("k") == first
    (tmp_path / "common.cuh").write_text("// b\n")
    assert cuda_build._target("k") != first
