"""Port parity: the CKKS operations of sfgwas_tpu_torch/crypto/ckks.py that
the ciphertext-matrix suite runs (switching keys, plaintext and
relinearising products, rescale, the unbatched keyswitch, single, batched
and hoisted rotations, the conjugation, constants) and CryptoParams.rotate /
conjugate, against sfgwas_tpu at TEST8 (TEST10 for one rotation case).

Both packages generate their keys from the same generator (the port's are
held bit-equal to the reference's), the ciphertexts are the reference's,
carried across with interop, and every output's residues must be bit-equal;
the decoded values hold tests/test_ckks.py's tolerances."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfgwas_tpu.crypto import ckks as RC
from sfgwas_tpu.crypto.params import get_params as ref_get_params
from sfgwas_tpu.mpc.mhe import CryptoParams as RefCryptoParams
from sfgwas_tpu_torch import interop
from sfgwas_tpu_torch.crypto import ckks as PC
from sfgwas_tpu_torch.crypto.params import get_params as port_get_params
from sfgwas_tpu_torch.mpc.mhe import CryptoParams
from sfgwas_tpu_torch.ops import rns as port_rns


def _u32(a):
    return port_rns.to_u32(a) if isinstance(a, torch.Tensor) else np.asarray(a)


def _same(r, p):
    """Bit-equal residues (arrays, pairs or ciphertexts), equal levels and
    scales."""
    if isinstance(r, (tuple, list)):
        assert len(r) == len(p)
        for a, b in zip(r, p):
            _same(a, b)
        return
    if isinstance(r, dict):
        assert sorted(r) == sorted(p)
        for k in r:
            _same(r[k], p[k])
        return
    if isinstance(r, RC.Ciphertext):
        assert (p.nmod, p.scale) == (r.nmod, r.scale)
        _same((r.c0, r.c1), (p.c0, p.c1))
        return
    if isinstance(r, RC.KSwitchKey):
        _same((r.d0, r.d1), (p.d0, p.d1))
        return
    want = np.asarray(r)
    assert want.dtype == np.uint32
    np.testing.assert_array_equal(_u32(p), want)


class Env:
    """Both contexts, the same keys in both packages (local keygen from one
    seed: secret, public, relinearisation and full rotation keys), and two
    encrypted vectors of the reference, carried across."""

    def __init__(self, preset, shifts):
        self.r = RC.CkksContext(ref_get_params(preset))
        self.p = PC.CkksContext(port_get_params(preset), device="cpu")
        r, p = self.r, self.p
        rg, pg = np.random.default_rng(42), np.random.default_rng(42)
        self.rsk, self.psk = r.gen_secret_key(rg), p.gen_secret_key(pg)
        self.rpk, self.ppk = r.gen_public_key(self.rsk, rg), p.gen_public_key(self.psk, pg)
        self.rrlk, self.prlk = r.gen_relin_key(self.rsk, rg), p.gen_relin_key(self.psk, pg)
        self.gels = [r.galois_for_rotation(k) for k in shifts] + [r.galois_conjugate()]
        self.rrot = {g: r.gen_rot_key(self.rsk, g, rg) for g in self.gels}
        self.prot = {g: p.gen_rot_key(self.psk, g, pg) for g in self.gels}
        assert rg.bit_generator.state == pg.bit_generator.state
        slots = r.params.slots
        vr = np.random.default_rng(5)
        self.a, self.b = vr.normal(size=slots), vr.normal(size=slots)
        self.ra = r.encrypt(r.encode(self.a, r.nq), self.rpk, vr)
        self.rb = r.encrypt(r.encode(self.b, r.nq), self.rpk, vr)
        self.pa, self.pb = self.carry(self.ra), self.carry(self.rb)

    def carry(self, ct):
        return interop.ciphertext(self.p, np.asarray(ct.c0), np.asarray(ct.c1), ct.nmod, ct.scale)

    def dec(self, ct):
        """The port's decrypt and decode under the port's key."""
        return self.p.decode(self.p.decrypt(ct, self.psk))

    def cps(self):
        rcps = RefCryptoParams(self.r, self.rsk, self.rpk, self.rrlk, self.rrot, None)
        pcps = CryptoParams(self.p, self.psk, self.ppk, self.prlk, self.prot, None)
        return rcps, pcps


@pytest.fixture(scope="module")
def env():
    return Env("TEST8", (1, 2, 5, 127))


def _rand_polys(ctx, shape, nmod, seed):
    rng = np.random.default_rng(seed)
    q = np.array(ctx.basis.primes[:nmod], np.int64)[:, None]
    return (rng.integers(0, 1 << 40, size=shape + (nmod, ctx.n)) % q).astype(np.uint32)


def _i32(a):
    return port_rns.as_i32(np.asarray(a))


def test_switching_keys_match(env):
    _same(env.rrlk, env.prlk)
    for g in env.gels:
        _same(env.rrot[g], env.prot[g])
    r, p = env.r, env.p
    rg, pg = np.random.default_rng(3), np.random.default_rng(3)
    s_src = np.asarray(env.rrot[env.gels[0]].d1[0])  # any [nq+1, N] residues
    _same(r.gen_kswitch_key(jnp.asarray(s_src), env.rsk, rg),
          p.gen_kswitch_key(_i32(s_src), env.psk, pg))
    # kswitch_share_many on two keys' random halves and noise
    B, nq = 2, r.nq
    a = np.stack([_rand_polys(r, (nq,), nq + 1, 10 + i) for i in range(B)])
    e = np.stack([_rand_polys(r, (nq,), nq + 1, 20 + i) for i in range(B)])
    sd = _rand_polys(r, (B,), nq + 1, 30)
    want = r.kswitch_share_many(env.rsk.s, jnp.asarray(sd), jnp.asarray(a), jnp.asarray(e))
    _same(want, p.kswitch_share_many(env.psk.s, _i32(sd), _i32(a), _i32(e)))


def test_plain_products_match(env):
    r, p = env.r, env.p
    rpt, ppt = r.encode(env.b, r.nq), p.encode(env.b, p.nq)
    _same(rpt.poly, ppt.poly)
    rp, pp = r.mul_plain(env.ra, rpt), p.mul_plain(env.pa, ppt)
    _same(rp, pp)
    got = env.dec(p.rescale(pp))
    assert np.allclose(got, env.a * env.b, atol=1e-4), np.abs(got - env.a * env.b).max()
    nmod = 7
    pts = _rand_polys(r, (3,), nmod, 1)
    c0, c1 = (_rand_polys(r, (), nmod, s) for s in (2, 3))
    _same(r.mul_plain_many_b(jnp.asarray(c0), jnp.asarray(c1), jnp.asarray(pts), nmod),
          p.mul_plain_many_b(_i32(c0), _i32(c1), _i32(pts), nmod))
    c0s, c1s = (_rand_polys(r, (5,), nmod, s) for s in (4, 5))
    pts = _rand_polys(r, (5,), nmod, 6)
    _same(r.mul_plain_pairs_sum(jnp.asarray(c0s), jnp.asarray(c1s), jnp.asarray(pts), nmod),
          p.mul_plain_pairs_sum(_i32(c0s), _i32(c1s), _i32(pts), nmod))


def test_relinearising_products_match(env):
    """mul_relin (the unbatched keyswitch), mul_relin_many and
    mul_relin_pairs, at the top and at a lower level; the rescaled products
    decode within 1e-4 of a*b."""
    r, p = env.r, env.p
    want = env.a * env.b
    for nmod in (r.nq, 7):
        ra, rb = r.drop_to(env.ra, nmod), r.drop_to(env.rb, 5 if nmod == 7 else nmod)
        pa, pb = p.drop_to(env.pa, nmod), p.drop_to(env.pb, 5 if nmod == 7 else nmod)
        rp, pp = r.mul_relin(ra, rb, env.rrlk), p.mul_relin(pa, pb, env.prlk)
        _same(rp, pp)
        got = env.dec(p.rescale(pp))
        assert np.allclose(got, want, atol=1e-4), np.abs(got - want).max()
        _same(r.mul_relin_many(ra, [ra, rb, rb], env.rrlk),
              p.mul_relin_many(pa, [pa, pb, pb], env.prlk))
        pairs = p.mul_relin_pairs([pa, pb, pa], [pb, pb, pa], env.prlk)
        _same(r.mul_relin_pairs([ra, rb, ra], [rb, rb, ra], env.rrlk), pairs)
        got = env.dec(p.rescale(pairs[1]))
        assert np.allclose(got, env.b * env.b, atol=1e-4)


def test_rescale_forms_match(env):
    r, p = env.r, env.p
    _same(r.rescale_one(env.ra), p.rescale_one(env.pa))
    got = env.dec(p.rescale_one(p.rescale_one(p.mul_const(env.pa, 2.5))))
    assert np.allclose(got, 2.5 * env.a, atol=1e-4)
    with pytest.raises(AssertionError, match="level underflow"):
        p.rescale_one(p.drop_to(env.pa, p.params.base_nmod))
    c0, c1 = (_rand_polys(r, (), 7, s) for s in (7, 8))
    _same(r._rescale_pair(jnp.asarray(c0), jnp.asarray(c1), 6),
          p._rescale_pair(_i32(c0), _i32(c1), 6))
    _same(r._rescale2_pair(jnp.asarray(c0), jnp.asarray(c1), 6),
          p._rescale2_pair(_i32(c0), _i32(c1), 6))
    dst = tuple(range(6))
    _same(r._rescale_poly(jnp.asarray(c0), 6, dst), p._rescale_poly(_i32(c0), 6, dst))


def test_unbatched_keyswitch_pieces_match(env):
    """decompose_ntt, _moddown, keyswitch_decomposed / keyswitch_core under a
    full rotation key, and keyswitch_decomposed_b under stacked keys."""
    r, p = env.r, env.p
    nmod = 7
    d = _rand_polys(r, (), nmod, 11)
    rext, pext = r.decompose_ntt(jnp.asarray(d), nmod), p.decompose_ntt(_i32(d), nmod)
    _same(rext, pext)
    x = _rand_polys(r, (), nmod + 1, 12)
    x[nmod] = _rand_polys(r, (), r.sp_row + 1, 12)[r.sp_row]
    _same(r._moddown(jnp.asarray(x), nmod), p._moddown(_i32(x), nmod))
    g = env.gels[0]
    _same(r.keyswitch_decomposed(rext, env.rrot[g], nmod),
          p.keyswitch_decomposed(pext, env.prot[g], nmod))
    _same(r.keyswitch_core(jnp.asarray(d), env.rrlk, nmod),
          p.keyswitch_core(_i32(d), env.prlk, nmod))
    rcps, pcps = env.cps()
    gs = env.gels[:3]
    rk0, rk1 = rcps.stacked_keys(gs, nmod)
    pk0, pk1 = pcps.stacked_keys(gs, nmod)
    _same((rk0, rk1), (pk0, pk1))
    ext = np.stack([np.asarray(r.decompose_ntt(jnp.asarray(_rand_polys(r, (), nmod, s)), nmod))
                    for s in (13, 14, 15)])
    _same(r.keyswitch_decomposed_b(jnp.asarray(ext), rk0, rk1, nmod),
          p.keyswitch_decomposed_b(_i32(ext), pk0, pk1, nmod))


ROTATIONS = ["rotate", "conjugate", "apply_galois", "automorphism", "rotate_batch",
             "hoisted_rotations_b", "hoisted_rotations", "cps_rotate", "cps_conjugate"]


def _rotation(env, pkg, op):
    """One rotation op applied by one package ("r" or "p") to its copy of
    the inputs; returns (outputs, the decodable ciphertexts with the slot
    shift each should show, None for the conjugation)."""
    ctx = getattr(env, pkg)
    ca, cb = (env.ra, env.rb) if pkg == "r" else (env.pa, env.pb)
    rot = env.rrot if pkg == "r" else env.prot
    cps = env.cps()[0 if pkg == "r" else 1]
    slots = ctx.params.slots
    k = 5
    g = ctx.galois_for_rotation(k)
    if op == "rotate":
        out = [ctx.rotate(ca, k, rot), ctx.rotate(cb, slots - 1, rot), ctx.rotate(ca, 0, rot)]
        return out, [(out[0], env.a, k), (out[1], env.b, slots - 1), (out[2], env.a, 0)]
    if op == "conjugate":
        out = ctx.conjugate(ca, rot)
        return out, [(out, env.a, None)]
    if op == "apply_galois":
        out = ctx.apply_galois(ctx.drop_to(cb, 5), g, rot[g])
        return out, [(out, env.b, k)]
    if op == "automorphism":
        return ctx.automorphism(ca.c0, g), []
    if op in ("cps_rotate", "cps_conjugate"):
        out = [cps.rotate(ca, 2), cps.rotate(cb, 0)] if op == "cps_rotate" else [cps.conjugate(cb)]
        want = [(out[0], env.a, 2), (out[1], env.b, 0)] if op == "cps_rotate" else [
            (out[0], env.b, None)]
        return out, want
    nmod = 7
    shifts = [1, 0, 5, 127]
    if op == "rotate_batch":
        gs = [ctx.galois_for_rotation(s) for s in (1, 5)]
        k0, k1 = cps.stacked_keys(gs, nmod)
        c0s = (jnp if pkg == "r" else torch).stack([ctx.drop_to(c, nmod).c0 for c in (ca, cb)])
        c1s = (jnp if pkg == "r" else torch).stack([ctx.drop_to(c, nmod).c1 for c in (ca, cb)])
        r0, r1 = ctx.rotate_batch(c0s, c1s, gs, k0, k1, nmod)
        out = [RC.Ciphertext(r0[i], r1[i], nmod, ca.scale) if pkg == "r"
               else PC.Ciphertext(r0[i], r1[i], nmod, ca.scale) for i in range(2)]
        return out, [(out[0], env.a, 1), (out[1], env.b, 5)]
    if op == "hoisted_rotations_b":
        gs = [ctx.galois_for_rotation(s) for s in shifts if s]
        k0, k1 = cps.stacked_keys(gs, nmod)
        ct = ctx.drop_to(ca, nmod)
        r0, r1 = ctx.hoisted_rotations_b(ct, shifts, k0, k1)
        mk = RC.Ciphertext if pkg == "r" else PC.Ciphertext
        out = [mk(r0[i], r1[i], nmod, ct.scale) for i in range(len(shifts))]
        return out, [(o, env.a, s) for o, s in zip(out, shifts)]
    assert op == "hoisted_rotations"
    res = ctx.hoisted_rotations(ctx.drop_to(cb, nmod), shifts, rot)
    return res, [(res[s], env.b, s) for s in shifts]


@pytest.mark.parametrize("op", ROTATIONS)
def test_rotations_match(env, op):
    """Every rotation form bit-equal to the reference's; the rotated
    ciphertexts decode within 1e-4 of the rolled slots (the conjugation of
    real data is the identity)."""
    want, _ = _rotation(env, "r", op)
    got, checks = _rotation(env, "p", op)
    _same(want, got)
    for ct, vals, k in checks:
        exp = vals if k is None else np.roll(vals, -k)
        dec = env.dec(ct)
        assert np.allclose(dec, exp, atol=1e-4), (op, k, np.abs(dec - exp).max())


def test_rotation_at_test10():
    """A single rotation and a hoisted batch at TEST10 (N = 2^10)."""
    env = Env("TEST10", (3,))
    for op in ("rotate", "hoisted_rotations"):
        if op == "hoisted_rotations":
            r = env.r.hoisted_rotations(env.ra, [3], env.rrot)
            p = env.p.hoisted_rotations(env.pa, [3], env.prot)
            _same(r, p)
            got = env.dec(p[3])
        else:
            r, p = env.r.rotate(env.rb, 3, env.rrot), env.p.rotate(env.pb, 3, env.prot)
            _same(r, p)
            got = env.dec(p)
        want = np.roll(env.a if op == "hoisted_rotations" else env.b, -3)
        assert np.allclose(got, want, atol=1e-4), np.abs(got - want).max()


def test_constants_match(env):
    r, p = env.r, env.p
    _same(r.mul_const_int(env.ra, -3), p.mul_const_int(env.pa, -3))
    _same(r.add_const(env.ra, 1.25), p.add_const(env.pa, 1.25))
    assert np.allclose(env.dec(p.mul_const_int(env.pa, -3)), -3 * env.a, atol=1e-4)
    assert np.allclose(env.dec(p.add_const(env.pa, 1.25)), env.a + 1.25, atol=1e-5)
