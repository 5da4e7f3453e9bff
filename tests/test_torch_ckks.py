"""Port parity: CKKS keygen, encode/encrypt/decrypt, the keyswitch pieces and
the batched rotations of sfgwas_tpu_torch against sfgwas_tpu at TEST8.
Both packages generate their keys from the same generator; the port's
threefry draws (kernel K4's plain version) give the reference's rotation
keys bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfgwas_tpu.crypto import basics as RB
from sfgwas_tpu.crypto import ckks as RC
from sfgwas_tpu.crypto.params import get_params as ref_get_params
from sfgwas_tpu.mpc.mhe import CryptoParams as RefCryptoParams
from sfgwas_tpu_torch import interop
from sfgwas_tpu_torch.crypto import basics as PB
from sfgwas_tpu_torch.crypto import ckks as PC
from sfgwas_tpu_torch.crypto.params import get_params as port_get_params
from sfgwas_tpu_torch.mpc.mhe import CryptoParams
from sfgwas_tpu_torch.ops import rns as port_rns

PRESET = "TEST8"
NMOD = 7  # the matmult band at TEST8 (base 3 + 2 levels)


def _u32(t):
    return port_rns.to_u32(t)


@pytest.fixture(scope="module")
def pair():
    """(reference ctx, port ctx, reference CryptoParams with local rotation
    keys, port CryptoParams with the port's own keys from the same
    generator, which equal the reference's)."""
    rctx = RC.CkksContext(ref_get_params(PRESET))
    pctx = PC.CkksContext(port_get_params(PRESET), device="cpu")
    slots = rctx.params.slots
    gels = [rctx.galois_for_rotation(k) for k in (1, 2, 5, 11, 33, slots - 1)]
    rng, prng = np.random.default_rng(42), np.random.default_rng(42)
    sk, psk = rctx.gen_secret_key(rng), pctx.gen_secret_key(prng)
    pk, ppk = rctx.gen_public_key(sk, rng), pctx.gen_public_key(psk, prng)
    rot = rctx.gen_rot_keys_batched(sk, gels, rng, key_nmod=rctx.params.mm_nmod)
    prot = pctx.gen_rot_keys_batched(psk, gels, prng, key_nmod=pctx.params.mm_nmod)
    rcps = RefCryptoParams(rctx, sk, pk, None, rot, rng)
    pcps = CryptoParams(pctx, psk, ppk, None, prot, prng)
    carried = interop.bundle_arrays(rcps)
    for g, (d0, d1) in carried["rot_keys"].items():
        assert np.array_equal(_u32(prot[g].d0), d0) and np.array_equal(_u32(prot[g].d1), d1)
    assert np.array_equal(_u32(psk.s), carried["sk"])
    return rctx, pctx, rcps, pcps, gels


def _rand_polys(ctx, shape, nmod, seed):
    rng = np.random.default_rng(seed)
    q = np.array(ctx.basis.primes[:nmod], np.int64)[:, None]
    return (rng.integers(0, 1 << 40, size=shape + (nmod, ctx.n)) % q).astype(np.uint32)


def test_keygen_encode_encrypt_decrypt_match(pair):
    rctx, pctx = pair[0], pair[1]
    seed = 7
    rk, pk_ = np.random.default_rng(seed), np.random.default_rng(seed)
    rsk, psk = rctx.gen_secret_key(rk), pctx.gen_secret_key(pk_)
    assert np.array_equal(_u32(psk.s), np.asarray(rsk.s))
    rpk, ppk = rctx.gen_public_key(rsk, rk), pctx.gen_public_key(psk, pk_)
    assert np.array_equal(_u32(ppk.p0), np.asarray(rpk.p0))
    assert np.array_equal(_u32(ppk.p1), np.asarray(rpk.p1))
    vals = np.random.default_rng(1).normal(size=rctx.params.slots)
    for nmod in (rctx.nq, NMOD):
        rpt, ppt = rctx.encode(vals, nmod), pctx.encode(vals, nmod)
        assert np.array_equal(_u32(ppt.poly), np.asarray(rpt.poly))
        rct, pct = rctx.encrypt(rpt, rpk, rk), pctx.encrypt(ppt, ppk, pk_)
        assert np.array_equal(_u32(pct.c0), np.asarray(rct.c0))
        assert np.array_equal(_u32(pct.c1), np.asarray(rct.c1))
        rdec = rctx.decode(rctx.decrypt(rct, rsk))
        pdec = pctx.decode(pctx.decrypt(pct, psk))
        assert np.array_equal(pdec, rdec)
        assert np.abs(pdec - vals).max() < 1e-6
    smalls = np.stack([rctx.sample_gauss(np.random.default_rng(s)) for s in range(3)])
    rows = tuple(range(NMOD)) + (rctx.sp_row,)
    assert np.array_equal(
        _u32(pctx.small_to_rns_b(smalls, rows)), np.asarray(rctx.small_to_rns_b(smalls, rows))
    )


def test_keyswitch_pieces_match(pair):
    rctx, pctx = pair[0], pair[1]
    d = _rand_polys(rctx, (3,), NMOD, 5)
    ext_r = np.asarray(rctx.decompose_ntt_b(jnp.asarray(d), NMOD))
    ext_p = pctx.decompose_ntt_b(port_rns.as_i32(d), NMOD)
    assert np.array_equal(_u32(ext_p), ext_r)
    x = _rand_polys(rctx, (4,), NMOD + 1, 6)
    x[:, NMOD] = _rand_polys(rctx, (4,), rctx.sp_row + 1, 6)[:, rctx.sp_row]
    want = np.asarray(rctx._moddown_b(jnp.asarray(x), NMOD))
    assert np.array_equal(_u32(pctx._moddown_b(port_rns.as_i32(x), NMOD)), want)
    c = _rand_polys(rctx, (5,), NMOD, 8)
    want = np.asarray(rctx.rescale2_many(jnp.asarray(c), NMOD - 1))
    assert np.array_equal(_u32(pctx.rescale2_many(port_rns.as_i32(c), NMOD - 1)), want)
    # lazy digit sums reduce to the same residues as the u32 Barrett step
    ext_rows = tuple(range(NMOD)) + (rctx.sp_row,)
    lazy = _rand_polys(rctx, (2,), NMOD + 1, 9).astype(np.uint64) * 37
    want = np.asarray(rctx._reduce_u32(jnp.asarray(lazy.astype(np.uint32)), ext_rows))
    got = pctx._reduce_u32(port_rns.as_i32(lazy.astype(np.uint32)).long() & 0xFFFFFFFF, ext_rows)
    assert np.array_equal(_u32(got), want)


def test_stacked_keys_match(pair):
    rcps, pcps, gels = pair[2], pair[3], pair[4]
    for fn in ("stacked_keys", "stacked_keys_inv"):
        r0, r1 = getattr(rcps, fn)(gels, NMOD)
        p0, p1 = getattr(pcps, fn)(gels, NMOD)
        assert np.array_equal(_u32(p0), np.asarray(r0)), fn
        assert np.array_equal(_u32(p1), np.asarray(r1)), fn
    assert pcps.rot_nmod == rcps.rot_nmod


def test_hoisted_and_grouped_rotations_match(pair):
    rctx, pctx, rcps, pcps, gels = pair
    s = 3
    c0 = _rand_polys(rctx, (s,), NMOD, 12)
    c1 = _rand_polys(rctx, (s,), NMOD, 13)
    ik0, ik1 = rcps.stacked_keys_inv(gels, NMOD)
    R0, R1 = rctx.hoisted_rotations_all(
        jnp.asarray(c0), jnp.asarray(c1), rctx.perms_for(gels), ik0, ik1, NMOD
    )
    pk0, pk1 = pcps.stacked_keys_inv(gels, NMOD)
    P0, P1 = pctx.hoisted_rotations_all(
        port_rns.as_i32(c0), port_rns.as_i32(c1), pctx.perms_for(gels), pk0, pk1, NMOD
    )
    assert np.array_equal(_u32(P0), np.asarray(R0))
    assert np.array_equal(_u32(P1), np.asarray(R1))

    R = len(gels)
    g0 = _rand_polys(rctx, (R, s), NMOD, 14)
    g1 = _rand_polys(rctx, (R, s), NMOD, 15)
    r0, r1 = rctx.rotate_grouped_b(
        jnp.asarray(g0), jnp.asarray(g1), rctx.perms_for(gels), ik0, ik1, NMOD
    )
    p0, p1 = pctx.rotate_grouped_b(
        port_rns.as_i32(g0), port_rns.as_i32(g1), pctx.perms_for(gels), pk0, pk1, NMOD
    )
    assert np.array_equal(_u32(p0), np.asarray(r0))
    assert np.array_equal(_u32(p1), np.asarray(r1))


def test_ks_digit_product_plain_matches_numpy():
    """K3's plain version (what its wrapper runs on CPU tensors) against a
    direct numpy contraction, in both of the kernel's layouts."""
    rng = np.random.default_rng(21)
    q = np.array([33554393, 33554467, 33553921], np.uint32)[:, None]
    for G, S, Bk in ((1, 3, 4), (4, 2, 1)):
        J, X, N = 5, 3, 16
        ext = (rng.integers(0, 1 << 40, size=(G, S, J, X, N)) % q).astype(np.uint32)
        k0 = (rng.integers(0, 1 << 40, size=(G, Bk, J, X, N)) % q).astype(np.uint32)
        k1 = (rng.integers(0, 1 << 40, size=(G, Bk, J, X, N)) % q).astype(np.uint32)
        mu = torch.tensor([(1 << 64) // int(v) for v in q[:, 0]], dtype=torch.int64)
        o0, o1 = PC.ks_digit_product(
            port_rns.as_i32(ext), port_rns.as_i32(k0), port_rns.as_i32(k1),
            port_rns.as_i32(q), mu, logn=4,
        )
        e = ext.astype(object)
        for o, k in ((o0, k0), (o1, k1)):
            want = np.einsum("gsjxn,gbjxn->gsbxn", e, k.astype(object)) % q.astype(object)[:, :1]
            assert np.array_equal(_u32(o), want.astype(np.uint32))


def test_port_rotation_keys_rotate(pair):
    """Keys from the port's own local keygen under another generator: a
    hoisted rotation decrypts to the rotated slots."""
    pctx = pair[1]
    rng = np.random.default_rng(99)
    sk = pctx.gen_secret_key(rng)
    pk = pctx.gen_public_key(sk, rng)
    shifts = (1, 5)
    gels = [pctx.galois_for_rotation(k) for k in shifts]
    cps = CryptoParams(pctx, sk, pk, None, pctx.gen_rot_keys_batched(sk, gels, rng, NMOD), rng)
    vals = rng.normal(size=pctx.params.slots)
    ct = pctx.encrypt(pctx.encode(vals, NMOD), pk, rng)
    ik0, ik1 = cps.stacked_keys_inv(gels, NMOD)
    R0, R1 = pctx.hoisted_rotations_all(
        ct.c0[None], ct.c1[None], pctx.perms_for(gels), ik0, ik1, NMOD
    )
    for b, k in enumerate(shifts):
        out = PC.Ciphertext(R0[b, 0], R1[b, 0], NMOD, ct.scale)
        got = pctx.decode(pctx.decrypt(out, sk))
        assert np.abs(got - np.roll(vals, -k)).max() < 1e-5


def test_vectors_and_levels_match(pair):
    """encrypt_float_vector under the same generator, then the level ops
    (clamp_rot, drop_to, rescale, zero_ct) on both sides."""
    rctx, pctx, rcps, pcps = pair[:4]
    rv = RefCryptoParams(rctx, rcps.sk, rcps.pk, None, rcps.rot_keys, np.random.default_rng(4))
    pv = CryptoParams(pctx, pcps.sk, pcps.pk, None, pcps.rot_keys, np.random.default_rng(4))
    vals = np.random.default_rng(3).normal(size=300)
    assert PB.num_ct(pv, len(vals)) == RB.num_ct(rv, len(vals)) == 3
    rcts, pcts = RB.encrypt_float_vector(rv, vals), PB.encrypt_float_vector(pv, vals)
    assert len(pcts) == len(rcts) == 3
    for rct, pct in zip(rcts, pcts):
        for op in (lambda cps, c: c, lambda cps, c: cps.clamp_rot(c),
                   lambda cps, c: cps.ctx.rescale(cps.clamp_rot(c)),
                   lambda cps, c: cps.ctx.drop_to(c, 4)):
            r, p = op(rv, rct), op(pv, pct)
            assert (p.nmod, p.scale) == (r.nmod, r.scale)
            assert np.array_equal(_u32(p.c0), np.asarray(r.c0))
            assert np.array_equal(_u32(p.c1), np.asarray(r.c1))
    got = PB.decode_float_vector(pv, [pctx.decrypt(c, pv.sk) for c in pcts])
    want = RB.decode_float_vector(rv, [rctx.decrypt(c, rv.sk) for c in rcts])
    assert np.array_equal(got, want)
    assert np.abs(got[: len(vals)] - vals).max() < 1e-6
    z = pctx.zero_ct(NMOD)
    assert (z.nmod, z.scale) == (NMOD, rctx.zero_ct(NMOD).scale) and not z.c0.any()
