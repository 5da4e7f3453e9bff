"""Port parity: the MPC protocols of sfgwas_tpu_torch (mpc/mpc.py,
mpc/boolean.py, mpc/linalg.py::chol_whiten) against sfgwas_tpu's, three
parties (dealer 0, data parties 1 and 2) on the CPU.

Every case of tests/test_mpc_core.py and tests/test_mpc_linalg.py::
test_chol_whiten runs in both packages from the same PRG keys (the pairwise
and global keys are fixed; each party's local generator, which the dealer
draws its secret values from, is seeded alike here) and the same numpy
inputs.  The shares every party holds and the revealed ints must be
bit-equal to the reference's; the plaintext checks of the reference's tests
hold beside them, with their tolerances."""

import math
from types import SimpleNamespace

import numpy as np
import pytest

from sfgwas_tpu.mpc import linalg as RL
from sfgwas_tpu.ops import ring as RR
from sfgwas_tpu.parallel import simulate as RS
from sfgwas_tpu_torch.mpc import linalg as PL
from sfgwas_tpu_torch.ops import ring as PR
from sfgwas_tpu_torch.parallel import simulate as PS

F = 30  # frac bits
K = 60  # data bits
P = PR.P256
REF = SimpleNamespace(R=RR, S=RS, linalg=RL)
PORT = SimpleNamespace(R=PR, S=PS, linalg=PL)


def fxp(v):
    return int(round(v * (1 << F)))


def tofloat(x):
    x = int(x)
    return (x - P if x > P // 2 else x) / (1 << F)


def _same(got, want, where):
    """Bit equality of nested results (arrays, python ints, None)."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    elif want is None:
        assert got is None, where
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape, (where, g.shape, w.shape)
        if w.dtype == object:
            assert [int(v) for v in g.reshape(-1)] == [int(v) for v in w.reshape(-1)], where
        else:
            assert g.dtype == w.dtype, (where, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=where)


def _both(case, **kw):
    """case(mpc, M) at every party of both packages (M names the package's
    ring, simulate and linalg modules); asserts each party's results
    bit-equal and returns the port's, indexed by pid."""

    def wrap(M):
        def fn(mpc):
            mpc.rand.table[mpc.pid] = np.random.Generator(np.random.Philox(key=[7, mpc.pid]))
            return case(mpc, M)

        return fn

    ref = RS.run_parties(3, wrap(REF), **kw)
    port = PS.run_parties(3, wrap(PORT), **kw)
    for pid in range(3):
        _same(port[pid], ref[pid], f"pid{pid}")
    return port


def test_share_reveal():
    vals = [0, 1, 123456789, P - 5]

    def case(mpc, M):
        sh = M.S.make_shares(mpc, vals)
        return sh, M.S.reveal_ints(mpc, sh)

    res = _both(case)
    for pid in (1, 2):
        assert [int(v) for v in res[pid][1]] == vals


def test_beaver_mult_and_matmul():
    a = [3, 10**12, P - 7]  # includes a negative (-7)
    b = [5, 999, 12]

    def case(mpc, M):
        sa = M.S.make_shares(mpc, a)
        sb = M.S.make_shares(mpc, b)
        prod = mpc.ss_mult_elem(sa, sb)
        sq = mpc.ss_square_elem(sa)
        A = M.S.make_shares(mpc, [1, 2, 3, 4]).reshape(2, 2, -1)
        B = M.S.make_shares(mpc, [5, 6, 7, 8]).reshape(2, 2, -1)
        Mm = mpc.ss_mult_mat(A, B)
        rev = [M.S.reveal_ints(mpc, x) for x in (prod, sq, Mm.reshape(4, -1))]
        return (prod, sq, Mm), rev

    res = _both(case)
    prod, sq, Mm = res[1][1]
    assert [int(v) for v in prod] == [(x * y) % P for x, y in zip(a, b)]
    assert [int(v) for v in sq] == [(x * x) % P for x in a]
    assert [int(v) for v in Mm] == [19, 22, 43, 50]


def test_trunc():
    vals = [fxp(2.5), fxp(1000.125), fxp(-3.75), fxp(-0.001)]
    scaled = [(v << F) % P for v in vals]  # trunc brings them back

    def case(mpc, M):
        t = mpc.trunc(M.S.make_shares(mpc, scaled), K, F)
        return t, M.S.reveal_ints(mpc, t)

    res = _both(case)
    for got, want in zip(res[1][1], vals):
        gotc = int(got) if int(got) < P // 2 else int(got) - P
        assert abs(gotc - want) <= 1


@pytest.mark.parametrize("binary", [True, False])
def test_is_positive(binary):
    vals = [1, fxp(0.5), fxp(123.0), -1, fxp(-7.5), -(10**10), 10**10]

    def case(mpc, M):
        pos = mpc.is_positive(M.S.make_shares(mpc, [v % P for v in vals]), binary)
        return pos, M.S.reveal_ints(mpc, pos)

    res = _both(case)
    assert [int(v) for v in res[1][1]] == [1 if v > 0 else 0 for v in vals]


@pytest.mark.parametrize("binary", [True, False])
def test_normalizer_even_exp(binary):
    vals = [3, 255, fxp(1.0), fxp(900.0), 1 << 55]

    def case(mpc, M):
        s, s_sqrt = mpc.normalizer_even_exp(M.S.make_shares(mpc, vals), K, binary)
        return (s, s_sqrt), (M.S.reveal_ints(mpc, s), M.S.reveal_ints(mpc, s_sqrt))

    res = _both(case)
    s, ssqrt = res[1][1]
    for v, si, sq in zip(vals, s, ssqrt):
        si, sq = int(si), int(sq)
        # the binary version may normalize a value on a power-of-4 boundary
        # one notch high (tests/test_mpc_core.py:108-113)
        hi_slack = 4 if binary else 1
        assert (1 << (K - 2)) <= v * si <= hi_slack * (1 << K), (v, si)
        assert sq * sq == si


@pytest.mark.parametrize("binary,max_len", [(True, 1_000_000), (False, 1_000_000), (True, 3)])
def test_sqrt_and_inverse(binary, max_len):
    """max_len 3 splits the 5 values into two protocol runs."""
    vals = [2.0, 0.25, 9.0, 10000.0, 123.456]

    def case(mpc, M):
        b, binv = mpc.sqrt_and_sqrt_inverse(M.S.make_shares(mpc, [fxp(v) for v in vals]),
                                            binary)
        return (b, binv), (M.S.reveal_ints(mpc, b), M.S.reveal_ints(mpc, binv))

    res = _both(case, div_sqrt_max_len=max_len)
    b, binv = res[1][1]
    for v, s, si in zip(vals, b, binv):
        assert abs(tofloat(s) - math.sqrt(v)) < 1e-4 * max(1, math.sqrt(v))
        assert abs(tofloat(si) - 1 / math.sqrt(v)) < 1e-4 * max(1, 1 / math.sqrt(v))


@pytest.mark.parametrize("binary", [True, False])
def test_divide(binary):
    pairs = [(1.0, 3.0), (10.0, 4.0), (0.5, 2.0), (1234.5, 0.75)]

    def case(mpc, M):
        sa = M.S.make_shares(mpc, [fxp(a) for a, _ in pairs])
        sb = M.S.make_shares(mpc, [fxp(b) for _, b in pairs])
        d = mpc.divide(sa, sb, binary)
        return d, M.S.reveal_ints(mpc, d)

    res = _both(case)
    for (a, b), got in zip(pairs, res[1][1]):
        assert abs(tofloat(got) - a / b) < 1e-4 * max(1, a / b)


def test_less_than_family():
    a = [fxp(1.0), fxp(5.0), fxp(-2.0)]
    b = [fxp(2.0), fxp(3.0), fxp(-1.0)]

    def case(mpc, M):
        sa = M.S.make_shares(mpc, [v % P for v in a])
        sb = M.S.make_shares(mpc, [v % P for v in b])
        lt = mpc.less_than(sa, sb)
        nlt_pub = mpc.not_less_than_public(sa, mpc.ring.const(fxp(1.5)))
        nlt = mpc.not_less_than(sa, sb, False)
        return (lt, nlt_pub, nlt), [M.S.reveal_ints(mpc, x) for x in (lt, nlt_pub, nlt)]

    res = _both(case)
    lt, nlt_pub, nlt = res[1][1]
    assert [int(v) for v in lt] == [1, 0, 1]
    assert [int(v) for v in nlt_pub] == [0, 1, 0]
    assert [int(v) for v in nlt] == [0, 1, 0]


def test_powers_and_poly():
    vals = [2, 3, 5]

    def case(mpc, M):
        pw = mpc.powers(M.S.make_shares(mpc, vals), 4)
        return pw, M.S.reveal_ints(mpc, pw.reshape(5 * 3, -1))

    res = _both(case)
    got = np.array([int(v) for v in res[1][1]]).reshape(5, 3)
    for p in range(5):
        for i, v in enumerate(vals):
            assert got[p, i] == pow(v, p, P)


def test_prefix_or_small_field():
    rows = [
        [0, 0, 1, 0, 1, 0, 0],
        [0, 0, 0, 0, 0, 0, 0],
        [1, 1, 1, 1, 1, 1, 1],
        [0, 0, 0, 0, 0, 0, 1],
    ]

    def case(mpc, M):
        flat = [b for row in rows for b in row]
        sh = M.S.make_shares(mpc, flat, M.R.SElem).reshape(len(rows), len(rows[0]))
        out = mpc.prefix_or(sh)
        return out, M.S.reveal_ints(mpc, out, M.R.SElem)

    res = _both(case)
    got = np.asarray(res[1][1]).reshape(len(rows), -1)
    for i, row in enumerate(rows):
        assert list(got[i]) == list(np.maximum.accumulate(row))


def test_sync_partitions_and_polynomials():
    """assert_sync, a three-tensor beaver_partition_many, the plain trunc
    defaults, flip_bit and evaluate_poly."""
    vals = [fxp(1.5), fxp(-2.0), 7]

    def case(mpc, M):
        mpc.assert_sync()
        x = M.S.make_shares(mpc, vals)
        y = M.S.make_shares(mpc, [4, 5, 6])
        ars, ams = mpc.beaver_partition_many([x, y, x[:1]])
        t = mpc.trunc(mpc.ss_mult_elem(x, x))
        flip = mpc.flip_bit(M.S.make_shares(mpc, [0, 1, 1]))
        coeff = mpc.ring.from_ints([[1, 2, 3], [0, 0, 1]])  # 1 + 2x + 3x^2 and x^2
        poly = mpc.evaluate_poly(y, coeff)
        mpc.assert_sync()
        outs = (ars, ams, t, flip, poly)
        revs = [M.S.reveal_ints(mpc, z) for z in (t, flip, poly.reshape(6, -1))]
        return outs, revs

    res = _both(case)
    t, flip, poly = res[1][1]
    assert [round(tofloat(v) * (1 << F)) / (1 << F) for v in t][:2] == pytest.approx(
        [2.25, 4.0], abs=1e-8)
    assert [int(v) for v in flip] == [1, 0, 0]
    assert [int(v) for v in poly] == [1 + 2 * v + 3 * v * v for v in (4, 5, 6)] + [16, 25, 36]


def test_chol_whiten():
    """W upper triangular with W^T G W = I, stable across wildly different
    column scales (tests/test_mpc_linalg.py:87-105)."""
    rng = np.random.default_rng(11)
    Bm = rng.normal(size=(40, 4)) * np.array([1.0, 30.0, 0.05, 3.0])
    Bm[:, 0] = 1.0  # ones column, like the combined covariate basis
    G = Bm.T @ Bm / 40

    def case(mpc, M):
        sh = M.S.make_shares(mpc, [fxp(v) for v in G.reshape(-1)]).reshape(4, 4, -1)
        W = M.linalg.chol_whiten(mpc, sh)
        return W, M.S.reveal_ints(mpc, W.reshape(16, -1))

    res = _both(case)
    W = np.array([tofloat(v) for v in res[1][1]]).reshape(4, 4)
    assert np.allclose(W, np.triu(W), atol=1e-6), W
    assert np.allclose(W.T @ G @ W, np.eye(4), atol=2e-2)


def test_numpy_engine_gives_the_same_shares():
    """The port's MPC over rings on the numpy path (native=False) gives the
    shares of its native engine, the binary protocol's companion ring
    included."""
    vals = [fxp(2.0), fxp(0.25), fxp(9.0)]
    outs = {}
    for native in (True, False):
        field = PR.field_for_size(256, native=native)

        def fn(mpc):
            mpc.rand.table[mpc.pid] = np.random.Generator(np.random.Philox(key=[7, mpc.pid]))
            return mpc.sqrt_and_sqrt_inverse(PS.make_shares(mpc, vals), True)

        outs[native] = PS.run_parties(3, fn, ring=field)
    for pid in range(3):
        _same(outs[False][pid], outs[True][pid], f"pid{pid}")
