"""What the threefry kernels K4 (sfgwas_tpu_torch/csrc/crp.cu, uniform_mod)
and K5's bs_mask (csrc/bs_share.cu) compute, modelled on the CPU: their
32-bit counter halves, the constants they read off the 64-bit Barrett
constant, the 32-bit Barrett and Shoup folds with their lazy bounds,
bs_mask's generic fold, and which of bs_mask's two kernels a table takes.  The model runs the kernels' wrapping
uint32 arithmetic in numpy and is held bit-equal to the plain versions
ckks.uniform_mod_plain and mhe._fold_words / bs_mask_plain."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sfgwas_tpu_torch.crypto import ckks as PC
from sfgwas_tpu_torch.crypto.params import get_params
from sfgwas_tpu_torch.mpc import mhe as PM
from sfgwas_tpu_torch.ops import rns, threefry

CSRC = Path(rns.__file__).resolve().parents[1] / "csrc"
M32 = np.uint64(0xFFFFFFFF)
VEC = 4  # coefficients a thread, in both kernels (checked against the sources below)
PRESETS = ("TEST8", "TEST10", "PN14QP438")


def _u64(v):
    return np.asarray(v, dtype=np.uint64)


def _umulhi(a, b):
    return (a * b) >> np.uint64(32)  # a, b < 2^32: the product fits in uint64


def barrett32_lazy(a, m, q):
    with np.errstate(over="ignore"):
        return (a - _umulhi(a, m) * q) & M32


def shoup_lazy(a, w, ws, q):
    with np.errstate(over="ignore"):
        return (a * w - _umulhi(a, ws) * q) & M32


def sub_if_ge(x, q):
    with np.errstate(over="ignore"):  # x - q wraps, as in uint32
        return np.minimum(x, (x - q) & M32)


def _k4_constants(q: int):
    """m = floor(2^32/q), cs = the Shoup quotient of c = 2^32 mod q, and c,
    as crp.cu reads them off mu = floor(2^64/q)."""
    mu = (1 << 64) // q
    m, cs = mu >> 32, mu & 0xFFFFFFFF
    return m, cs, (-m * q) & 0xFFFFFFFF


def _k4_fold(hi, lo, q: int):
    m, cs, c = (_u64(v) for v in _k4_constants(q))
    q = _u64(q)
    s = shoup_lazy(hi, c, cs, q) + barrett32_lazy(lo, m, q)
    assert (s < 4 * q).all()
    return sub_if_ge(barrett32_lazy(s, m, q), q)


def _primes(preset):
    return get_params(preset).basis.primes


def test_model_constants_are_the_kernels():
    crp, bs = (CSRC / "crp.cu").read_text(), (CSRC / "bs_share.cu").read_text()
    assert re.search(rf"constexpr int VEC = {VEC};", crp)
    assert re.search(rf"constexpr int MASK_VEC = {VEC};", bs)
    for src in (crp, bs):
        assert "make_uint4(o[0], o[1], o[2], o[3])" in src  # one 16-byte store of VEC words
    # the register kernel's bound on the lazy sum, as bs_lazy decides it
    assert "2 (nwords + 1) q_max < 2^32" in bs
    assert re.search(rf"constexpr int REG_WORDS = {PM.BS_REG_WORDS};", bs)


@pytest.mark.parametrize("preset", PRESETS)
def test_k4_constants_from_mu(preset):
    """m, c and cs read off the 64-bit Barrett constant are floor(2^32/q),
    2^32 mod q and floor(c 2^32 / q); every prime leaves the lazy sum of
    the fold (below 4q) and the mask fold (below 10q) inside 32 bits."""
    for q in _primes(preset):
        m, cs, c = _k4_constants(q)
        assert (m, c, cs) == ((1 << 32) // q, (1 << 32) % q, (((1 << 32) % q) << 32) // q)
        assert 10 * q < 1 << 32


EDGES = (0, 1, (1 << 24) - 1, (1 << 32) - 1)


@pytest.mark.parametrize("preset", PRESETS)
def test_k4_fold_of_edge_words(preset):
    """(hi 2^32 + lo) mod q for every pair of edge words (0, 1, 2^24 - 1,
    2^32 - 1, q - 1, q, a random word) at every prime of the preset."""
    rng = np.random.default_rng(1)
    for q in _primes(preset):
        words = sorted(set(EDGES + (q - 1, q, int(rng.integers(1 << 32)))))
        hi, lo = (_u64(a).ravel() for a in np.meshgrid(words, words, indexing="ij"))
        want = np.array([((int(h) << 32) | int(l)) % q for h, l in zip(hi, lo)], np.uint64)
        assert np.array_equal(_k4_fold(hi, lo, q), want)


@pytest.mark.parametrize("preset", PRESETS)
def test_shoup_and_barrett_are_lazy_by_one_q(preset):
    """Both 32-bit folds give a value below 2q congruent to the exact one,
    for any 32-bit input: the kernels rely on it for words that are not
    residues (K4's hi and lo)."""
    for q in _primes(preset):
        a = _u64(sorted(set(EDGES + (q - 1, q, 2 * q - 1))))
        m = _u64((1 << 32) // q)
        for w in (1, 2, q - 1, pow(1 << 24, 2, q)):
            ws = _u64((w << 32) // q)
            got = shoup_lazy(a, _u64(w), ws, _u64(q))
            assert (got < 2 * q).all()
            assert np.array_equal(got % _u64(q), _u64([int(x) * w % q for x in a]))
        got = barrett32_lazy(a, m, _u64(q))
        assert (got < 2 * q).all() and np.array_equal(got % _u64(q), a % _u64(q))


@pytest.mark.parametrize("batch,rows", [(1, (0,)), (3, (0, 1, 2, 9)), (2, (4, 7, 8))])
def test_k4_model_is_uniform_mod_plain(batch, rows):
    """The whole kernel on a TEST8 draw: counter halves as the kernel forms
    them (the block's high word, its low word plus n), the hashes, the
    32-bit fold, against the plain version."""
    params = get_params("TEST8")
    n, logn, L = params.n, params.logn, len(rows)
    seed, idx = (0xDEADBEEF, 77), 5
    key = threefry.derive_key(*seed, idx)
    total = batch * L * n
    row = np.arange(batch * L, dtype=np.uint64)[:, None]
    coef = np.arange(n, dtype=np.uint64)[None, :]
    words = []
    for base in (row << np.uint64(logn), (row << np.uint64(logn)) + _u64(total)):
        assert ((base & M32) + coef <= M32).all()  # the low word never carries
        y0, y1 = threefry.threefry2x32(key[0], key[1], base >> np.uint64(32), (base & M32) + coef)
        words.append(_u64(y0) ^ _u64(y1))
    primes = [params.basis.primes[r] for r in rows]
    out = np.stack([_k4_fold(words[0][i], words[1][i], primes[i % L]) for i in range(batch * L)])
    q = rns._sel(params.basis, rows, "cpu")["q"]
    want = rns.to_u32(PC.uniform_mod_plain(q, seed, idx, batch, n)).reshape(batch * L, n)
    assert np.array_equal(out, want)


@pytest.mark.parametrize("logn,rows", [(14, 1 << 19), (14, 56 * 8 * 700), (20, 5000), (8, 1 << 25)])
def test_counter_halves_past_2_32(logn, rows):
    """A draw of more than 2^32 words: the kernel's halves (the block's
    high word, its low word plus n) are the 64-bit counter's, at the first,
    last and random coefficients of rows on either side of every 2^32
    boundary, for hi and for lo (+ total)."""
    n = 1 << logn
    total = rows * n
    assert 2 * total > 1 << 32
    rng = np.random.default_rng(logn)
    pick = {0, rows - 1} | {int(r) for r in rng.integers(0, rows, 64)}
    pick |= {min(rows - 1, (k << 32) // n + d) for k in range(1, 2 * total // (1 << 32) + 1)
             for d in (-1, 0)}
    key = threefry.derive_key(3, 4, 5)
    for r in sorted(pick):
        for off in (0, total):
            base = (r << logn) + off
            for c in {0, 1, n - 1, int(rng.integers(n))}:
                hi_w, lo_w = base >> 32, (base & 0xFFFFFFFF) + c
                assert lo_w <= 0xFFFFFFFF and (hi_w << 32) | lo_w == base + c
    # and the hash of such a counter is jax.random.bits' word there
    c = (1 << 33) + 12345
    y0, y1 = threefry.threefry2x32(key[0], key[1], c >> 32, c & 0xFFFFFFFF)
    assert y0 ^ y1 == int(threefry.bits(key, c, 1, "cpu")[0])


def _mask_case(preset, rows, nwords, top_bits, B, logn, seed):
    """Signed words [K, B, n] (the top one centred) with edge values set,
    and the kernel's unsigned form of them."""
    ctx = PC.CkksContext(get_params(preset), device="cpu")
    n = 1 << logn
    w = PM._mask_words(seed, 9, B, nwords, top_bits, n, "cpu").clone()
    h = 1 << (top_bits - 1)
    low = [0, 1, (1 << 24) - 1, 1 << 23]  # edge words below the top
    top = [-h, -1, 0, h - 1]  # the most negative, negative, zero and largest top words
    for j in range(len(low)):
        w[:-1, 0, j] = low[j]
        w[-1, 0, j] = top[j]
    u = w.numpy().astype(np.int64)
    u[-1] += h
    assert (u >= 0).all() and (u[:-1] < 1 << 24).all() and (u[-1] < 1 << top_bits).all()
    return ctx, w, u.astype(np.uint64), h


def _mask_fold_fast(u, t, h):
    """bs_mask_kernel's fold of the unsigned words u [K, ...] at the rows of
    table t: the centring constant plus one Shoup term a word, one Barrett
    step and a conditional subtract."""
    q = rns.to_u32(t["q"]).astype(np.uint64)[:, 0]
    pw = rns.to_u32(t["pw"]).astype(np.uint64)
    ps = rns.to_u32(t["ps"]).astype(np.uint64)
    mu = t["mu"].numpy().astype(np.uint64)
    K = u.shape[0]
    out = []
    for r in range(q.shape[0]):
        qr, m = q[r], mu[r] >> np.uint64(32)
        acc = 2 * qr - shoup_lazy(_u64(h), pw[r, K - 1], ps[r, K - 1], qr)
        assert 0 < acc <= 2 * qr
        acc = acc + sum(shoup_lazy(u[k], pw[r, k], ps[r, k], qr) for k in range(K))
        assert (acc < 2 * qr * (K + 1)).all() and (acc <= M32).all()
        out.append(sub_if_ge(barrett32_lazy(acc, m, qr), qr))
    return np.stack(out)


def _mask_fold_generic(u, t, h):
    """bs_mask_generic_kernel's fold: -h p_top mod q, then each word's
    Shoup term reduced and added in turn, the sum kept below q."""
    q = rns.to_u32(t["q"]).astype(np.uint64)[:, 0]
    pw = rns.to_u32(t["pw"]).astype(np.uint64)
    ps = rns.to_u32(t["ps"]).astype(np.uint64)
    K = u.shape[0]
    out = []
    for r in range(q.shape[0]):
        qr = q[r]
        acc = sub_if_ge(qr - sub_if_ge(shoup_lazy(_u64(h), pw[r, K - 1], ps[r, K - 1], qr), qr), qr)
        acc = np.broadcast_to(acc, u.shape[1:])
        for k in range(K):
            acc = sub_if_ge(acc + sub_if_ge(shoup_lazy(u[k], pw[r, k], ps[r, k], qr), qr), qr)
            assert (acc < qr).all()
        out.append(acc)
    return np.stack(out)


@pytest.mark.parametrize("nwords,top_bits", [(1, 1), (1, 24), (2, 13), (3, 23), (4, 24), (4, 1),
                                            (5, 24), (6, 21), (10, 17), (18, 13)])
@pytest.mark.parametrize("preset", PRESETS)
def test_mask_fold_is_fold_words(preset, nwords, top_bits):
    """The register kernel's lazy fold (its bound holds at every prime of
    these presets) and the generic fold against the plain _fold_words,
    edge words included."""
    rows = tuple(range(min(5, get_params(preset).nq + 1)))
    ctx, w, u, h = _mask_case(preset, rows, nwords, top_bits, 2, 5, (11, 12))
    t = PM._bs_tables(ctx, rows, nwords)
    assert t["lazy"]
    want = rns.to_u32(PM._fold_words(w, t["pw"], t["q"])).astype(np.uint64)
    assert np.array_equal(_mask_fold_fast(u, t, h), want)
    assert np.array_equal(_mask_fold_generic(u, t, h), want)


@pytest.mark.parametrize("nwords,top_bits", [(3, 24), (5, 20)])
def test_generic_fold_with_primes_below_the_top_word(nwords, top_bits):
    """PN12's 18-19-bit primes, below the 24-bit words: both folds stay
    exact where a word and h = 2^(top_bits-1) exceed q.  The register
    kernel takes them (its lazy bound holds); the generic kernel's fold is
    held to the same bits."""
    rows = (0, 1, 2)
    ctx, w, u, h = _mask_case("PN12QP109", rows, nwords, top_bits, 2, 3, (1, 2))
    t = PM._bs_tables(ctx, rows, nwords)
    assert t["lazy"] and h > max(ctx.basis.primes[r] for r in rows)
    assert PM.bs_mask_variant(t, t, nwords, 12) == "register"
    want = rns.to_u32(PM._fold_words(w, t["pw"], t["q"])).astype(np.uint64)
    assert np.array_equal(_mask_fold_fast(u, t, h), want)
    assert np.array_equal(_mask_fold_generic(u, t, h), want)


@pytest.mark.parametrize("preset", ["PN12QP109", "TEST8", "PN14QP438", "PN15QP880"])
def test_bs_tables_lazy_is_the_bound_on_the_largest_prime(preset):
    """`lazy` of _bs_tables is 2 (nwords + 1) q_max < 2^32 on the row set's
    own largest prime, at every word count the preset's masks draw and one
    past the bound; bs_lazy at its edge."""
    params = get_params(preset)
    ctx = PC.CkksContext(params, device="cpu")
    rows = tuple(range(params.nq))
    q_max = max(params.basis.primes[r] for r in rows)
    edge = (1 << 32) // (2 * q_max) - 1  # the most words the bound takes
    for nwords in sorted({PM._mask_bits(params, nm, 3)[0] for nm in range(1, params.nq + 1)}
                         | {edge, edge + 1}):
        t = PM._bs_tables(ctx, rows, nwords)
        assert t["lazy"] == (2 * (nwords + 1) * q_max < 1 << 32) == (nwords <= edge)
    assert PM.bs_lazy((1 << 31) - 1, 0) is True and PM.bs_lazy(1 << 31, 0) is False
    assert PM.bs_lazy(1 << 26, 30) is True and PM.bs_lazy(1 << 26, 31) is False


def test_bs_mask_variant_rule():
    """The register kernel for 1..BS_REG_WORDS words on tables that pass
    the lazy bound at N >= 4; the generic kernel for more words, for a row
    set past the bound (either one) and for N < 4."""
    ok, past = {"lazy": True}, {"lazy": False}
    for nwords in range(1, PM.BS_MAX_WORDS + 1):
        want = "register" if nwords <= PM.BS_REG_WORDS else "generic"
        assert PM.bs_mask_variant(ok, ok, nwords, 14) == want
        assert PM.bs_mask_variant(ok, past, nwords, 14) == "generic"
        assert PM.bs_mask_variant(past, ok, nwords, 14) == "generic"
    assert PM.bs_mask_variant(ok, ok, 3, 2) == "register"
    assert PM.bs_mask_variant(ok, ok, 3, 1) == "generic"
    # PN14QP438's refreshes: nmod 1..17 prime rows, every word count the register kernel's
    params = get_params("PN14QP438")
    ctx = PC.CkksContext(params, device="cpu")
    for nmod in range(1, params.nq + 1):
        nwords, _ = PM._mask_bits(params, nmod, 3)
        tl = PM._bs_tables(ctx, tuple(range(nmod)), nwords)
        tf = PM._bs_tables(ctx, tuple(range(params.nq)), nwords)
        assert PM.bs_mask_variant(tl, tf, nwords, params.logn) == "register"


@pytest.mark.parametrize("preset,nrows,ntgt,B,nwords,top_bits", [
    ("TEST8", 3, 9, 3, 3, 23),
    ("TEST10", 1, 4, 2, 1, 24),
    ("PN14QP438", 3, 17, 1, 3, 23),
    ("PN14QP438", 9, 11, 2, 10, 17),
])
def test_mask_model_is_bs_mask_plain(preset, nrows, ntgt, B, nwords, top_bits):
    """The whole register kernel on a small draw: its counters ((k B + b) N
    + n from the block's base), the masked words and the fold of both row
    sets, against bs_mask_plain."""
    params = get_params(preset)
    logn = 5
    n = 1 << logn
    ctx = PC.CkksContext(params, device="cpu")
    rows, tgt = tuple(range(nrows)), tuple(range(ntgt))
    tl, tf = PM._bs_tables(ctx, rows, nwords), PM._bs_tables(ctx, tgt, nwords)
    seed, idx = (0x9E3779B9, 0x7F4A7C15), 3
    key = threefry.derive_key(*seed, idx)
    cols = B * n
    kb = (np.arange(nwords, dtype=np.uint64)[:, None] * _u64(cols)
          + (np.arange(B, dtype=np.uint64)[None, :] << np.uint64(logn)))[..., None]
    y0, y1 = threefry.threefry2x32(key[0], key[1], kb >> np.uint64(32),
                                   (kb & M32) + np.arange(n, dtype=np.uint64))
    u = (_u64(y0) ^ _u64(y1)) & _u64(0xFFFFFF)
    u[-1] &= _u64((1 << top_bits) - 1)
    h = 1 << (top_bits - 1)
    want = PM.bs_mask_plain(tl["pw"], tf["pw"], tl["q"], tf["q"], seed, idx, B, nwords,
                            top_bits, n)
    for t, wt in ((tl, want[0]), (tf, want[1])):
        assert np.array_equal(_mask_fold_fast(u, t, h), rns.to_u32(wt).astype(np.uint64))
    # the wrapper on CPU tables is the plain version
    got = PM.bs_mask(tl, tf, seed, idx, B, nwords, top_bits, logn)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_bs_mask_split_rule():
    """Warps share a run only where the grid would leave SMs idle: the
    split doubles while the blocks (B N / 512) times it stay below
    BS_SPLIT_BLOCKS, up to 4."""
    assert PM.bs_mask_split(1, 14) == 4  # 32 blocks: the widest mask's single refresh
    assert PM.bs_mask_split(7, 14) == 4  # 224 blocks: the association's 7 products
    assert PM.bs_mask_split(8, 14) == 4  # 256: the MHE phase's refreshes of 8
    assert PM.bs_mask_split(12, 14) == 2  # 384: the QR band refresh
    assert PM.bs_mask_split(17, 14) == 1  # 544
    assert PM.bs_mask_split(1, 2) == 4 and PM.bs_mask_split(70000, 2) == 1
    for B in range(1, 40):
        for logn in (2, 9, 12, 14, 15):
            split = PM.bs_mask_split(B, logn)
            blocks = B * max(1, (1 << logn) // 512)
            assert split in (1, 2, 4)
            assert split == 4 or blocks * split >= PM.BS_SPLIT_BLOCKS
            assert split == 1 or blocks * split // 2 < PM.BS_SPLIT_BLOCKS
