"""What kernel K6 (sfgwas_tpu_torch/csrc/crt_lift.cu, the CRT lift of the
collective bootstrap) computes, modelled on the CPU: its packed table, its
groups of destination rows, its 32-bit Shoup and Barrett folds with their
lazy bounds and its float32 rounding of k.  The model runs the kernel's
wrapping uint32 arithmetic in numpy, reads the table at the kernel's
offsets, and is held bit-equal to the plain version rns.crt_lift_plain and
to the exact residues of the lifted values."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sfgwas_tpu_torch.crypto.params import PRESETS, prime_chain
from sfgwas_tpu_torch.ops import rns

CSRC = Path(rns.__file__).resolve().parents[1] / "csrc"
M32 = np.uint64(0xFFFFFFFF)
SRC, DST_HEAD = 4, 4  # words of the packed table per source row, and per destination row's head
PLAN_PRESETS = ("TEST8", "TEST10", "PN14QP438", "PN15QP880")
# (preset, l) with l source rows of the chain; each lifts to the whole chain
CASES = [(p, l) for p in PLAN_PRESETS for l in (1, 3, 17, 24)
         if l <= PRESETS[p].base_primes + 2 * PRESETS[p].levels + 1]


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


def _basis(preset):
    """The preset's whole chain (its Q primes and the special prime) with
    NTT tables for a tiny ring: K6's tables read only the primes."""
    q, sp = prime_chain(PRESETS[preset])
    return rns.RnsBasis(q + [sp], 3)


def crt_model(x, pack, l: int, D: int, G: int):
    """K6 on x [l, M] (uint64 holding uint32) with the packed table, block
    group by block group: each group of G destination rows recomputes y and
    k, as the kernel's blockIdx.y does."""
    u = pack.astype(np.uint64)
    src = u[: SRC * l].reshape(l, SRC)
    row = DST_HEAD + 2 * l
    inv_q = pack[: SRC * l].reshape(l, SRC)[:, 3].view(np.float32)
    out = np.zeros((D, x.shape[1]), np.uint64)
    for d0 in range(0, D, G):
        y = []
        s = np.zeros(x.shape[1], np.float32)
        for i in range(l):
            w, ws, q = src[i, 0], src[i, 1], src[i, 2]
            lazy = shoup_lazy(x[i], w, ws, q)
            assert (lazy < 2 * q).all()
            y.append(sub_if_ge(lazy, q))
            # (float)y, one rounded product and one rounded sum a row, in order
            s = s + y[i].astype(np.uint32).astype(np.float32) * inv_q[i]
        k = np.rint(s).astype(np.uint64)
        assert (k <= l).all()
        for d in range(d0, min(d0 + G, D)):
            r = u[SRC * l + d * row: SRC * l + (d + 1) * row]
            p, m = r[2], r[3]
            acc = shoup_lazy(k, r[0], r[1], p)
            assert (acc < 2 * p).all()
            for i in range(l):
                term = shoup_lazy(y[i], r[DST_HEAD + 2 * i], r[DST_HEAD + 2 * i + 1], p)
                assert (term < 2 * p).all()
                acc = acc + term  # uint64: the bound below says it never wraps in uint32
            assert (acc < 2 * (l + 1) * p).all() and (acc <= M32).all()
            out[d] = sub_if_ge(barrett32_lazy(acc, m, p), p)
    return out


def _values(Q: int, fill: str, rng):
    """Centred values the bootstrap's lift takes: random with |v| < Q/8;
    0, 1 and -1 (residues 0, 1 and q - 1 in every row); +-(Q/4 - 1)."""
    if fill == "random":
        return [int(a) * Q // (8 << 62) for a in rng.integers(-(1 << 62), 1 << 62, size=64)]
    if fill == "edges":
        return [0, 1, -1] * 3
    return [Q // 4 - 1, -(Q // 4 - 1)] * 2


def test_model_constants_are_the_kernels():
    src = (CSRC / "crt_lift.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["LMAX"]) == rns.CRT_LIFT_MAX_ROWS
    assert int(consts["GMAX"]) == rns.CRT_LIFT_MAX_GROUP
    assert (int(consts["SRC"]), int(consts["DST_HEAD"])) == (SRC, DST_HEAD)
    assert int(consts["VEC"]) == 4 and "make_uint4(v[0], v[1], v[2], v[3])" in src
    assert "__fadd_rn(s[v], __fmul_rn((float)y[i][v], inv_q))" in src  # no fused step


@pytest.mark.parametrize("fill", ["random", "edges", "quarter"])
@pytest.mark.parametrize("preset,l", CASES)
def test_model_equals_plain_and_exact(preset, l, fill):
    """l source rows lifted to the whole chain (every row, the source rows
    and the special prime included), in groups of crt_lift_group(D)."""
    basis = _basis(preset)
    src, dst = tuple(range(l)), tuple(range(len(basis.primes)))
    Q = 1
    for r in src:
        Q *= basis.primes[r]
    v = _values(Q, fill, np.random.default_rng(l))
    x = np.array([[vv % basis.primes[r] for vv in v] for r in src], np.uint32)
    exact = np.array([[vv % basis.primes[r] for vv in v] for r in dst], np.uint32)
    t = rns._crt_tables(basis, src, dst, "cpu")
    pack = rns.to_u32(t["pack"])
    got = crt_model(x.astype(np.uint64), pack, l, len(dst), rns.crt_lift_group(len(dst)))
    plain = rns.to_u32(rns.crt_lift_plain(rns.as_i32(x), t))
    assert np.array_equal(got, exact) and np.array_equal(plain, exact)


@pytest.mark.parametrize("G", range(1, rns.CRT_LIFT_MAX_GROUP + 1))
def test_model_is_the_same_for_every_group_size(G):
    """Every group size the kernel takes gives the same rows, a last group
    that is not full included (D = 11)."""
    basis = _basis("TEST10")
    src, dst = (0, 1, 2), tuple(range(11))
    Q = basis.primes[0] * basis.primes[1] * basis.primes[2]
    v = _values(Q, "random", np.random.default_rng(G))
    x = np.array([[vv % basis.primes[r] for vv in v] for r in src], np.uint64)
    pack = rns.to_u32(rns._crt_tables(basis, src, dst, "cpu")["pack"])
    want = np.array([[vv % basis.primes[r] for vv in v] for r in dst], np.uint64)
    assert np.array_equal(crt_model(x, pack, 3, len(dst), G), want)


def test_pack_holds_the_tables():
    """The packed table's layout, entry by entry, against the named tables
    and the Shoup and Barrett constants' definitions."""
    basis = _basis("PN14QP438")
    src, dst = (0, 1, 2), (0, 4, 9, 17)
    t = rns._crt_tables(basis, src, dst, "cpu")
    l, D = len(src), len(dst)
    pack = [int(v) for v in rns.to_u32(t["pack"])]
    assert len(pack) == SRC * l + D * (DST_HEAD + 2 * l)
    w, q, T = (rns.to_u32(t[k]).tolist() for k in ("w", "q", "T"))
    negQ, p = rns.to_u32(t["negQ"]).tolist(), rns.to_u32(t["p"]).tolist()
    for i in range(l):
        assert pack[SRC * i: SRC * (i + 1)] == [
            w[i], (w[i] << 32) // q[i], q[i], int(t["inv_q"][i:i + 1].numpy().view(np.uint32)[0])]
    row = DST_HEAD + 2 * l
    for d in range(D):
        r = pack[SRC * l + d * row: SRC * l + (d + 1) * row]
        assert r[:DST_HEAD] == [negQ[d], (negQ[d] << 32) // p[d], p[d], (1 << 32) // p[d]]
        assert r[DST_HEAD:] == [v for ti in T[d] for v in (ti, (ti << 32) // p[d])]
    assert t["sum_bound"] == 2 * (l + 1) * max(p)


@pytest.mark.parametrize("D", range(1, 40))
def test_groups_are_fewest_and_even(D):
    G = rns.crt_lift_group(D)
    groups = -(-D // G)
    assert 1 <= G <= rns.CRT_LIFT_GROUP <= rns.CRT_LIFT_MAX_GROUP
    assert groups == -(-D // rns.CRT_LIFT_GROUP)  # no more blocks than needed
    assert D - (groups - 1) * G >= 1 and G - (D - (groups - 1) * G) < groups  # as even as can be


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_lazy_sum_fits_32_bits_for_every_preset(preset):
    """2 (l + 1) max p < 2^32 for every source count the kernel takes, over
    every prime of the preset's chain; the one preset whose chain cannot be
    built (too few NTT primes) has nothing to lift."""
    if preset == "PN16QP1761":
        with pytest.raises(RuntimeError, match="not enough NTT primes"):
            prime_chain(PRESETS[preset])
        return
    basis = _basis(preset)
    rows = tuple(range(len(basis.primes)))
    l = min(rns.CRT_LIFT_MAX_ROWS, len(rows))
    t = rns._crt_tables(basis, rows[:l], rows, "cpu")
    assert t["sum_bound"] == 2 * (l + 1) * max(basis.primes)
    assert 2 * (rns.CRT_LIFT_MAX_ROWS + 1) * max(basis.primes) < 1 << 32


def test_wrapper_checks_read_only_metadata():
    """The card path's checks on the meta device, which holds no data: a
    source count or a table the kernel does not take, and primes whose lazy
    sum would pass 2^32, are refused before any launch."""
    basis = _basis("TEST8")
    src, dst = (0, 1, 2), tuple(range(9))
    t = rns._crt_tables(basis, src, dst, "meta")
    x = torch.empty((3, 64), dtype=torch.int32, device="meta")
    before = rns.CRT_LIFT.launches
    with pytest.raises(ValueError, match="pack"):
        rns.crt_lift(x, rns._crt_tables(basis, src, dst[:5], "meta") | {"p": t["p"]})
    with pytest.raises(ValueError, match="source rows"):
        rns.crt_lift(torch.empty((rns.CRT_LIFT_MAX_ROWS + 1, 64), dtype=torch.int32,
                                 device="meta"), t)
    wide = rns.RnsBasis(rns.gen_primes(25, 3, 30), 3)  # 30-bit primes: 2 * 25 * p > 2^32
    rows = tuple(range(25))
    with pytest.raises(ValueError, match="lazy sum"):
        rns.crt_lift(torch.empty((24, 64), dtype=torch.int32, device="meta"),
                     rns._crt_tables(wide, rows[:24], rows, "meta"))
    assert rns.CRT_LIFT.launches == before
