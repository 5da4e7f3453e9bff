"""What the NTT kernel K1 (sfgwas_tpu_torch/csrc/ntt.cu) decides, modelled on
the CPU: its pass schedule (which coefficients a thread holds in each pass,
which twiddle each butterfly takes), its shared-memory layout and device
access pattern, and its lazy reduction.  The model runs the kernel's
wrapping uint32 arithmetic in numpy and is held bit-equal to the plain
butterfly rns._ntt_b_butterfly."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sfgwas_tpu_torch.crypto.params import PRESETS, get_params, prime_chain
from sfgwas_tpu_torch.ops import rns

NTT_CU = Path(rns.__file__).resolve().parents[1] / "csrc" / "ntt.cu"
M32 = np.uint64(0xFFFFFFFF)

# the kernel's constants (checked against the source below)
R, THREADS = 5, 256
RC = 1 << R
LOGNS = (8, 10, 12, 13, 14, 15)  # the kernel's instances: the presets' ring sizes


def _plan(logn):
    n = 1 << logn
    tpoly = min(n // RC, THREADS)
    polys = THREADS // tpoly
    npass = -(-logn // R)
    passes = [(p * R, min(R, logn - p * R), max(0, logn - p * R - R)) for p in range(npass)]
    return dict(n=n, tpoly=tpoly, groups=n // RC // tpoly, polys=polys, threads=tpoly * polys,
                padded=n + n // 32, passes=passes)


def _coef_index(lo, gid, e):
    return (gid & ((1 << lo) - 1)) | (e << lo) | ((gid >> lo) << (lo + R))


def _shared_address(lo, gid, e):
    """The kernel's sbase(gid) + soff(e): index i of the padded shared poly
    at i + (i >> 5)."""
    low, hi = gid & ((1 << lo) - 1), gid >> lo
    base = low + (low >> 5) + (hi << (lo + R)) + (hi << (lo + R - 5))
    return base + (e << lo) + ((e << (lo - 5)) if lo >= 5 else (e >> (5 - lo)))


def _stage(logn, S, LO, i):
    """Forward stage S+i of a pass: window bit W, the thread's pairs (e, f)
    and each pair's offset j in the twiddle run; run length and the run's
    start for each group id (a function)."""
    s = S + i
    W = logn - 1 - s - LO
    run = 1 << (R - 1 - W)
    js, es = np.meshgrid(np.arange(run), np.arange(1 << W), indexing="ij")
    e = ((js << (W + 1)) | es).ravel()
    return (s, W, e, e | (1 << W), js.ravel(), run,
            lambda gid: (1 << s) + ((gid >> LO) << (R - 1 - W)))


def _umulhi(a, b):
    return (a * b) >> np.uint64(32)  # a, b < 2^32: the product fits in uint64


def _shoup_lazy(a, w, ws, q):
    return (a * w - _umulhi(a, ws) * q) & M32


def _ntt_model(x, basis, rows, inverse):
    """The kernel's passes on x [L, B, N] uint32, in numpy uint64 holding
    wrapping uint32 values."""
    logn = basis.logn
    pl = _plan(logn)
    t = {k: v[np.asarray(rows)].astype(np.uint64) for k, v in basis._np.items()}
    q = t["q"][:, None]  # [L, 1, 1]
    y = x.astype(np.uint64).copy()
    gid = np.arange(pl["n"] // RC)
    e_all = np.arange(RC)
    order = range(len(pl["passes"]))
    for p in (reversed(order) if inverse else order):
        S, K, LO = pl["passes"][p]
        idx = _coef_index(LO, gid[:, None], e_all[None, :])  # [G, 32]
        a = y[:, :, idx]  # [L, B, G, 32]
        for i in (reversed(range(K)) if inverse else range(K)):
            s, W, e, f, j, run, base = _stage(logn, S, LO, i)
            ti = base(gid)[:, None] + j[None, :]  # [G, pairs]
            tw = (t["ipsi" if inverse else "psi"][:, ti])[:, None]  # [L, 1, G, pairs]
            tws = (t["ipsi_s" if inverse else "psi_s"][:, ti])[:, None]
            qq = q[..., None]
            u, v = a[..., e], a[..., f]
            if not inverse:
                tt = _shoup_lazy(v, tw, tws, qq)
                a[..., f] = (u + 2 * qq - tt) & M32
                a[..., e] = (u + tt) & M32
            else:
                sm = (u + v) & M32
                d = (u + 2 * qq - v) & M32
                a[..., e] = np.minimum(sm, (sm - 2 * qq) & M32)
                a[..., f] = _shoup_lazy(d, tw, tws, qq)
        last = p == (0 if inverse else len(pl["passes"]) - 1)
        if last:
            if inverse:
                fw, fws = t["ninv"][:, :, None, None], t["ninv_s"][:, :, None, None]
            else:
                fw, fws = np.uint64(1), (np.uint64(1) << np.uint64(32)) // q[..., None]
            r = _shoup_lazy(a, fw, fws, q[..., None])
            a = np.minimum(r, (r - q[..., None]) & M32)
        y[:, :, idx] = a
    return y.astype(np.uint32)


def test_model_constants_are_the_kernels():
    src = NTT_CU.read_text()
    for name, val in (("R", R), ("THREADS", THREADS)):
        assert re.search(rf"constexpr int {name} = {val};", src), name
    assert "PADDED = N + N / 32" in src
    assert sorted(int(v) for v in re.findall(r"NTT_CASE\((\d+)\)", src)) == list(LOGNS)
    assert sorted({spec.logn for spec in PRESETS.values()} - {16}) == list(LOGNS)


@pytest.mark.parametrize("logn", LOGNS)
def test_passes_cover_every_stage_and_coefficient_once(logn):
    pl = _plan(logn)
    n = pl["n"]
    assert pl["threads"] == THREADS
    assert pl["tpoly"] * pl["groups"] * RC == n and len(pl["passes"]) in (2, 3)
    stages = []
    gid = np.arange(n // RC)
    for S, K, LO in pl["passes"]:
        idx = _coef_index(LO, gid[:, None], np.arange(RC)[None, :])
        # the groups of a pass partition the poly
        assert np.array_equal(np.sort(idx.ravel()), np.arange(n))
        for i in range(K):
            s, W, e, f, j, run, base = _stage(logn, S, LO, i)
            assert 0 <= W < R and len(e) == RC // 2
            stages.append(s)
            # the pairs are those of the stage: differ in bit logn-1-s only
            u, v = idx[:, e], idx[:, f]
            assert np.array_equal(v - u, np.full_like(u, 1 << (logn - 1 - s)))
            assert np.all((u >> (logn - 1 - s)) & 1 == 0)
            # each butterfly's twiddle is psi[2^s + (u >> (logn - s))]
            assert np.array_equal(base(gid)[:, None] + j[None, :], (1 << s) + (u >> (logn - s)))
            # a run is read with loads of min(run, 4) words at aligned offsets
            assert np.all(base(gid) % run == 0) and run <= 16
    assert stages == list(range(logn))


@pytest.mark.parametrize("logn", LOGNS)
def test_exchange_is_free_of_bank_conflicts(logn):
    """For every pass, group and coefficient slot, the 32 lanes of every warp
    touch 32 different banks of the padded shared-memory poly."""
    pl = _plan(logn)
    tid = np.arange(pl["threads"])
    slot, tp = tid // pl["tpoly"], tid % pl["tpoly"]
    for S, K, LO in pl["passes"]:
        for g in range(pl["groups"]):
            gid = tp + g * pl["tpoly"]
            for e in range(RC):
                i = _coef_index(LO, gid, e)
                assert np.array_equal(_shared_address(LO, gid, e), i + (i >> 5))
                banks = (slot * pl["padded"] + i + (i >> 5)) % 32
                assert all(len(set(banks[w:w + 32])) == 32 for w in range(0, len(tid), 32))


@pytest.mark.parametrize("logn", LOGNS)
def test_device_accesses(logn):
    """First forward pass: for each coefficient slot a warp reads
    consecutive words (one 128-byte line at N >= 2^10).  Last pass: a thread
    holds 32 contiguous coefficients."""
    pl = _plan(logn)
    gid = np.arange(min(pl["tpoly"], 32))
    S, K, LO = pl["passes"][0]
    assert LO == logn - R
    for e in range(RC):
        addr = _coef_index(LO, gid, e)
        assert np.array_equal(np.diff(addr), np.ones(len(gid) - 1, np.int64))
    S, K, LO = pl["passes"][-1]
    assert LO == 0
    idx = _coef_index(0, np.arange(pl["n"] // RC)[:, None], np.arange(RC)[None, :])
    assert np.array_equal(idx, np.arange(pl["n"]).reshape(-1, RC))


@pytest.mark.parametrize("logn", LOGNS)
def test_contiguous_groups_pass_through_the_warps_own_shared_region(logn):
    """Where a thread holds 32 contiguous coefficients (the last forward and
    first inverse pass), a warp's device accesses go through shared memory:
    lane l's chunk k is block coefficients f0 + 128 k + 4 l .. +3.  Each
    instruction covers 512 contiguous bytes, the warp's chunks are exactly
    the coefficients its threads hold (so a __syncwarp suffices), and the
    scalar shared accesses of a chunk word are free of bank conflicts."""
    pl = _plan(logn)
    n = pl["n"]
    for g in range(pl["groups"]):
        for first in range(0, pl["threads"], 32):
            tid = first + np.arange(32)
            slot, gid = tid // pl["tpoly"], tid % pl["tpoly"] + g * pl["tpoly"]
            held = (slot[:, None] * n + gid[:, None] * RC + np.arange(RC)[None, :]).ravel()
            f0 = (first // pl["tpoly"]) * n + (first % pl["tpoly"] + g * pl["tpoly"]) * RC
            f = f0 + 128 * np.arange(RC // 4)[:, None] + 4 * np.arange(32)[None, :]  # [k, lane]
            assert np.array_equal(np.diff(f, axis=1), np.full((RC // 4, 31), 4))
            chunks = (f[..., None] + np.arange(4)).ravel()
            assert np.array_equal(np.sort(chunks), np.sort(held))
            for c in range(4):
                w = f + c
                addr = (w >> logn) * pl["padded"] + (w & (n - 1)) + ((w & (n - 1)) >> 5)
                assert all(len(set(row % 32)) == 32 for row in addr)


def _bases():
    """Every preset that builds, a few of its primes (PN16QP1761 has too few
    NTT primes in both packages)."""
    out = []
    for name, spec in PRESETS.items():
        try:
            qs, sp = prime_chain(spec)
        except RuntimeError:
            continue
        out.append((name, spec.logn, qs + [sp]))
    return out


def test_lazy_bounds_hold_for_every_preset_prime():
    """Forward values grow by < 2q a stage from < q: below (1 + 2 logn) q
    < 2^31 after all logn stages; the lazy Shoup product is in [0, 2q) for
    any input below 2^32, and the final Shoup step by 1 plus one
    conditional subtract gives v mod q.  The inverse stays in [0, 2q): 4q
    fits in 32 bits."""
    rng = np.random.default_rng(11)
    bases = _bases()
    assert len(bases) == len(PRESETS) - 1
    primes = sorted({(q, logn) for _, logn, qs in bases for q in qs})
    assert len(primes) > 50
    for q, logn in primes:
        top = (1 + 2 * logn) * q
        assert q < 1 << 26 and top < 1 << 31 and 4 * q < 1 << 32
        qq = np.uint64(q)
        a = np.concatenate([np.array([0, 1, q - 1, q, 2 * q - 1, 4 * q - 1, top - 1, (1 << 32) - 1],
                                     np.uint64), rng.integers(0, top, 256, dtype=np.uint64)])
        for w in (0, 1, q - 1, int(rng.integers(2, q - 1))):
            ws = (np.uint64(w) << np.uint64(32)) // qq
            r = _shoup_lazy(a, np.uint64(w), ws, qq)
            assert np.all(r < 2 * qq) and np.array_equal(r % qq, a * np.uint64(w) % qq), (q, w)
        v = a[a < top]
        r = _shoup_lazy(v, np.uint64(1), (np.uint64(1) << np.uint64(32)) // qq, qq)
        assert np.array_equal(np.minimum(r, (r - qq) & M32), v % qq), q


@pytest.mark.parametrize("fill", ["random", "zero", "top"])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("preset", ["TEST8", "TEST10", "PN14QP438"])
def test_model_equals_plain_butterfly(preset, inverse, fill):
    """The schedule model, with the kernel's lazy uint32 arithmetic, against
    the plain butterfly on 3 polys of 2-3 rows; "top" sets every input to
    q - 1, which drives the forward values to their largest bound."""
    if preset == "PN14QP438":  # two primes of the chain: the tables for all 16 take seconds
        qs, _ = prime_chain(PRESETS[preset])
        basis, rows = rns.RnsBasis(qs[:2], PRESETS[preset].logn), (0, 1)
    else:
        basis = get_params(preset).basis
        rows = (0, 2, len(basis.primes) - 1)
    rng = np.random.default_rng(len(preset) + 2 * inverse)
    qn = np.array([basis.primes[r] for r in rows], np.uint64)[:, None, None]
    shape = (len(rows), 3, basis.n)
    if fill == "random":
        x = (rng.integers(0, 1 << 40, shape, dtype=np.uint64) % qn).astype(np.uint32)
    elif fill == "zero":
        x = np.zeros(shape, np.uint32)
    else:
        x = np.broadcast_to(qn - 1, shape).astype(np.uint32)
    want = rns.to_u32(rns._ntt_b_butterfly(rns.as_i32(x), basis, rows, inverse))
    assert np.array_equal(_ntt_model(x, basis, rows, inverse), want)
