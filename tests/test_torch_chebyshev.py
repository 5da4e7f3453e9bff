"""Port parity: the Chebyshev part of sfgwas_tpu_torch/crypto/basics.py
(chebyshev_coeffs, evaluate_chebyshev, evaluate_chebyshev_interactive,
evaluate_chebyshev_bsgs) against sfgwas_tpu/crypto/basics.py.

- chebyshev_coeffs equal to the reference's, bit for bit;
- the port's own recursions, run over a plaintext stand-in for the CKKS
  context (values in place of ciphertexts), against numpy's chebval at
  the degrees of tests/test_chebyshev.py:24, 15 and 62 among them (the
  1e-12 coefficient cut and the p == d split);
- at TEST10 under the reference's keys carried across with interop, the
  three evaluators' output ciphertexts bit-equal to the reference's for
  the same input ciphertext, with the same level and scale; the refresh
  both packages are handed is one function (decrypt, decode, encrypt at
  the top from a generator seeded by the call's index);
- the degree-62 sigmoid on [-10, 10] within 1e-4 of the exact sigmoid,
  the bound of tests/test_chebyshev.py:88."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from sfgwas_tpu.crypto import basics as RB
from sfgwas_tpu.crypto import ckks as RC
from sfgwas_tpu.crypto.params import get_params as ref_get_params
from sfgwas_tpu.mpc.mhe import CryptoParams as RefCryptoParams
from sfgwas_tpu_torch import interop
from sfgwas_tpu_torch.crypto import basics as PB
from sfgwas_tpu_torch.crypto import ckks as PC
from sfgwas_tpu_torch.crypto.params import get_params as port_get_params
from sfgwas_tpu_torch.ops import rns as port_rns

PRESET = "TEST10"
DEGREES = [1, 2, 3, 4, 7, 8, 15, 16, 31, 62, 63]


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def test_chebyshev_coeffs_match_reference():
    fn = lambda x: 1.0 / (1.0 + math.exp(-x))  # noqa: E731
    for a, b, d in [(-10.0, 10.0, 62), (-6.0, 6.0, 15), (-1.0, 2.0, 3)]:
        np.testing.assert_array_equal(PB.chebyshev_coeffs(fn, a, b, d),
                                      RB.chebyshev_coeffs(fn, a, b, d))


# --- the recursions over plaintext values


class _Val:
    """A stand-in ciphertext: slot values, a level, a scale."""

    def __init__(self, v, nmod, scale):
        self.v, self.nmod, self.scale = np.asarray(v, float), nmod, scale


class _Ctx:
    """The CkksContext operations the evaluators use, on plain values.  A
    rescale drops two moduli; scales follow the same bookkeeping shape as
    CKKS (a product's scale is the product of scales over the pair)."""

    PAIR = 2.0 ** 40 * 1.001  # products drift off the preset scale

    def __init__(self, nq: int, base_nmod: int, exact: bool = True):
        self.nq, self.exact = nq, exact
        self.params = type("P", (), {"scale": 2.0 ** 40, "base_nmod": base_nmod})()

    def rescale(self, x):
        assert x.nmod - 2 >= self.params.base_nmod, x.nmod
        return _Val(x.v, x.nmod - 2, x.scale / self.PAIR)

    def mul_const(self, x, c):
        return _Val(x.v * c, x.nmod, x.scale * self.params.scale)

    def mul_const_to(self, x, c, target):
        return _Val(x.v * c, x.nmod, target * self.PAIR)

    def mul_relin(self, a, b, _rlk):
        return _Val(a.v * b.v, min(a.nmod, b.nmod), a.scale * b.scale)

    def add_const(self, x, c):
        return _Val(x.v + c, x.nmod, x.scale)

    def _pair(self, a, b):
        """exact: the evaluator must add at equal levels and scales (the
        steered evaluators); else the context aligns them, as CKKS does."""
        assert a.nmod == b.nmod or not self.exact
        assert abs(a.scale / b.scale - 1) < 1e-9 or not self.exact, (a.scale, b.scale)

    def add(self, a, b):
        self._pair(a, b)
        return _Val(a.v + b.v, a.nmod, a.scale)

    def sub(self, a, b):
        self._pair(a, b)
        return _Val(a.v - b.v, a.nmod, a.scale)

    def drop_to(self, x, nmod):
        assert nmod <= x.nmod
        return _Val(x.v, nmod, x.scale)


class _Cps:
    def __init__(self, nq, base_nmod, exact=True):
        self.ctx, self.rlk = _Ctx(nq, base_nmod, exact), None


XS = np.linspace(-1, 1, 257)


@pytest.mark.parametrize("deg", DEGREES)
def test_bsgs_recursion_matches_chebval(deg):
    """A deep context (no refresh) and a shallow one (refreshes inside the
    basis and the recursion): both equal chebval within 1e-9, every add
    at equal levels and scales."""
    c = np.random.default_rng(deg).normal(size=deg + 1)
    if deg >= 15:
        c[deg // 2] = 1e-13  # below the coefficient cut
    want = np.polynomial.chebyshev.chebval(XS, np.where(np.abs(c) < 1e-12, 0.0, c))
    calls = []

    def refresh(net, cps, x, src):
        calls.append(x.nmod)
        return _Val(x.v, cps.ctx.nq, cps.ctx.params.scale)

    for nq, base in ((10_000, 3), (13, 3)):
        cps = _Cps(nq, base)
        x = _Val(XS, nq, cps.ctx.params.scale)  # a = -1, b = 1: y = x
        got = PB.evaluate_chebyshev_bsgs(None, cps, [x], c, -1.0, 1.0, refresh)[0]
        assert np.abs(got.v - want).max() < 1e-9, (deg, nq)
    assert deg < 4 or calls  # the shallow context refreshed


@pytest.mark.parametrize("deg", [1, 2, 3, 8, 15])
def test_linear_recursions_match_chebval(deg):
    c = np.random.default_rng(100 + deg).normal(size=deg + 1)
    c[0] = c[0] if deg < 2 else 0.0
    want = np.polynomial.chebyshev.chebval(XS, c)

    def refresh(net, cps, x, src):
        return _Val(x.v, cps.ctx.nq, cps.ctx.params.scale)

    cps = _Cps(13, 3)
    x = _Val(XS, 13, cps.ctx.params.scale)
    got = PB.evaluate_chebyshev_interactive(None, cps, [x], c, -1.0, 1.0, refresh)[0]
    assert np.abs(got.v - want).max() < 1e-9
    deep = _Cps(4 * deg + 10, 3, exact=False)
    got = PB.evaluate_chebyshev(deep, _Val(XS, 4 * deg + 10, 2.0 ** 40), c, -1.0, 1.0)
    assert np.abs(got.v - want).max() < 1e-9


# --- ciphertexts at TEST10, bit for bit


@pytest.fixture(scope="module")
def pair():
    """The reference's local keys (secret, public, relinearisation) and the
    same keys carried across into a port bundle on the CPU."""
    rctx = RC.CkksContext(ref_get_params(PRESET))
    rng = np.random.default_rng(7)
    sk = rctx.gen_secret_key(rng)
    pk = rctx.gen_public_key(sk, rng)
    rlk = rctx.gen_relin_key(sk, rng)
    rcps = RefCryptoParams(rctx, sk, pk, rlk, {}, rng)
    pctx = PC.CkksContext(port_get_params(PRESET), device="cpu")
    pcps = interop.crypto_params(pctx, **interop.bundle_arrays(rcps))
    return rcps, pcps


def _refresher(pcps):
    """The refresh both packages get: decrypt, decode and encrypt afresh at
    the top in the port, from a generator seeded by the call's index; a
    reference ciphertext crosses over and back as residues."""
    calls = [0]

    def port_refresh(ct):
        vals = np.real(pcps.ctx.decode(pcps.ctx.decrypt(ct, pcps.sk)))
        pcps.enc_rng = np.random.default_rng(1000 + calls[0])
        calls[0] += 1
        return PB.encrypt_float_vector(pcps, vals)[0]

    def ref_refresh(net, cps, ct, src):
        out = port_refresh(interop.ciphertext(pcps.ctx, np.asarray(ct.c0), np.asarray(ct.c1),
                                              ct.nmod, ct.scale))
        return RC.Ciphertext(jnp.asarray(port_rns.to_u32(out.c0)),
                             jnp.asarray(port_rns.to_u32(out.c1)), out.nmod, out.scale)

    return (lambda net, cps, ct, src: port_refresh(ct)), ref_refresh, calls


def _same_ct(r, p):
    assert (p.nmod, p.scale) == (r.nmod, r.scale)
    np.testing.assert_array_equal(port_rns.to_u32(p.c0), np.asarray(r.c0))
    np.testing.assert_array_equal(port_rns.to_u32(p.c1), np.asarray(r.c1))


def _input(rcps, pcps, xs):
    rcps.enc_rng = np.random.default_rng(5)
    rct = RB.encrypt_float_vector(rcps, xs)[0]
    pct = interop.ciphertext(pcps.ctx, np.asarray(rct.c0), np.asarray(rct.c1), rct.nmod, rct.scale)
    _same_ct(rct, pct)
    return rct, pct


def _dec(pcps, ct, n):
    return np.real(pcps.ctx.decode(pcps.ctx.decrypt(ct, pcps.sk)))[:n]


SIG = lambda x: 1.0 / (1.0 + math.exp(-x))  # noqa: E731


@pytest.mark.parametrize("deg,a,b", [(15, -6.0, 6.0), (62, -10.0, 10.0)])
def test_bsgs_ciphertexts_match_reference(pair, deg, a, b):
    """The protocol's evaluator: degree 15 on [-6, 6] (the CPU study's) and
    the configuration's degree 62 on [-10, 10], within 1e-4 of the exact
    sigmoid (tests/test_chebyshev.py:88)."""
    rcps, pcps = pair
    xs = np.random.default_rng(11).uniform(a + 0.5, b - 0.5, size=pcps.slots)
    coeffs = RB.chebyshev_coeffs(SIG, a, b, deg)
    rct, pct = _input(rcps, pcps, xs)
    _, ref_refresh, ref_calls = _refresher(pcps)
    port_refresh, _, calls = _refresher(pcps)
    r = RB.evaluate_chebyshev_bsgs(None, rcps, [rct], coeffs, a, b, ref_refresh)[0]
    p = PB.evaluate_chebyshev_bsgs(None, pcps, [pct], coeffs, a, b, port_refresh)[0]
    assert calls[0] == ref_calls[0] > 0
    _same_ct(r, p)
    if deg == 62:
        assert np.abs(_dec(pcps, p, len(xs)) - _sigmoid(xs)).max() < 1e-4
    else:
        want = np.polynomial.chebyshev.chebval((2 * xs - a - b) / (b - a), coeffs)
        assert np.abs(_dec(pcps, p, len(xs)) - want).max() < 1e-4


def test_interactive_ciphertexts_match_reference(pair):
    rcps, pcps = pair
    a, b = -6.0, 6.0
    xs = np.random.default_rng(12).uniform(a, b, size=pcps.slots)
    coeffs = RB.chebyshev_coeffs(SIG, a, b, 7)
    rct, pct = _input(rcps, pcps, xs)
    _, ref_refresh, ref_calls = _refresher(pcps)
    port_refresh, _, calls = _refresher(pcps)
    r = RB.evaluate_chebyshev_interactive(None, rcps, [rct], coeffs, a, b, ref_refresh)[0]
    p = PB.evaluate_chebyshev_interactive(None, pcps, [pct], coeffs, a, b, port_refresh)[0]
    assert calls[0] == ref_calls[0] > 0
    _same_ct(r, p)
    want = np.polynomial.chebyshev.chebval((2 * xs - a - b) / (b - a), coeffs)
    assert np.abs(_dec(pcps, p, len(xs)) - want).max() < 1e-4


def test_linear_ciphertexts_match_reference(pair):
    """evaluate_chebyshev has no refresh: degree 2 fits TEST10's 5 levels."""
    rcps, pcps = pair
    a, b = -2.0, 2.0
    xs = np.random.default_rng(13).uniform(a, b, size=pcps.slots)
    coeffs = np.array([0.5, 0.25, -0.125])
    rct, pct = _input(rcps, pcps, xs)
    r = RB.evaluate_chebyshev(rcps, rct, coeffs, a, b)
    p = PB.evaluate_chebyshev(pcps, pct, coeffs, a, b)
    _same_ct(r, p)
    want = np.polynomial.chebyshev.chebval((2 * xs - a - b) / (b - a), coeffs)
    assert np.abs(_dec(pcps, p, len(xs)) - want).max() < 1e-3
