"""Port parity: the ciphertext-vector and -matrix operations of
sfgwas_tpu_torch/crypto/basics.py against sfgwas_tpu/crypto/basics.py at
TEST8, on the model of tests/test_batched_ops.py.

Both packages hold the same keys (local keygen from one seed; the port's
equal the reference's bit for bit) and encrypt from equal generators; every
op's ciphertexts must be bit-equal with equal levels and scales, and the
decoded values hold tests/test_batched_ops.py's tolerances."""

import numpy as np
import pytest

from sfgwas_tpu.crypto import basics as RB
from sfgwas_tpu.crypto import ckks as RC
from sfgwas_tpu.crypto.params import get_params as ref_get_params
from sfgwas_tpu.mpc.mhe import CryptoParams as RefCryptoParams
from sfgwas_tpu_torch.crypto import basics as PB
from sfgwas_tpu_torch.crypto import ckks as PC
from sfgwas_tpu_torch.crypto.params import get_params as port_get_params
from sfgwas_tpu_torch.mpc.mhe import CryptoParams
from sfgwas_tpu_torch.ops import rns as port_rns

SLOTS = 128


def _keys(ctx, cls, seed=7):
    rng = np.random.default_rng(seed)
    sk = ctx.gen_secret_key(rng)
    pk = ctx.gen_public_key(sk, rng)
    rlk = ctx.gen_relin_key(sk, rng)
    cps = cls(ctx, sk, pk, rlk, {}, rng)
    gels, p, slots = set(), 1, ctx.params.slots
    while p < slots:
        gels.add(ctx.galois_for_rotation(p))
        gels.add(ctx.galois_for_rotation(slots - p))
        p *= 2
    cps.rot_keys.update(ctx.gen_rot_keys_batched(sk, sorted(gels), rng))
    return cps


@pytest.fixture(scope="module")
def pair():
    rcps = _keys(RC.CkksContext(ref_get_params("TEST8")), RefCryptoParams)
    pcps = _keys(PC.CkksContext(port_get_params("TEST8"), device="cpu"), CryptoParams)
    for g, k in rcps.rot_keys.items():
        np.testing.assert_array_equal(port_rns.to_u32(pcps.rot_keys[g].d1), np.asarray(k.d1))
    np.testing.assert_array_equal(port_rns.to_u32(pcps.rlk.d0), np.asarray(rcps.rlk.d0))
    return rcps, pcps


def _reseed(cps, seed):
    cps.enc_rng = np.random.default_rng(seed)
    return cps


def _flat(x):
    """Ciphertexts of a result (a ciphertext, a vector, a matrix, a tuple
    with a level) in order; None and ints pass through."""
    if isinstance(x, (list, tuple)):
        return [c for e in x for c in _flat(e)]
    return [x]


def _same(r, p):
    fr, fp = _flat(r), _flat(p)
    assert len(fr) == len(fp)
    for a, b in zip(fr, fp):
        if a is None or isinstance(a, (int, np.integer)):
            assert a == b
            continue
        if isinstance(a, RC.Plaintext):
            assert (b.nmod, b.scale) == (a.nmod, a.scale)
            np.testing.assert_array_equal(port_rns.to_u32(b.poly), np.asarray(a.poly))
            continue
        assert (b.nmod, b.scale) == (a.nmod, a.scale)
        np.testing.assert_array_equal(port_rns.to_u32(b.c0), np.asarray(a.c0))
        np.testing.assert_array_equal(port_rns.to_u32(b.c1), np.asarray(a.c1))


def _dec(cps, ct):
    return np.real(cps.ctx.decode(cps.ctx.decrypt(ct, cps.sk)))[:SLOTS]


VR = np.random.default_rng(11)
X_V = VR.normal(size=(2, 2 * SLOTS))  # two rows of two ciphertexts
S_V = VR.normal()


def _inputs(B, cps):
    """X, Y: two-ciphertext vectors; M: a 2 x 2 matrix; s: a ciphertext
    holding S_V in every slot; all encrypted from one seeded generator."""
    _reseed(cps, 5)
    X = B.encrypt_float_vector(cps, X_V[0])
    Y = B.encrypt_float_vector(cps, X_V[1])
    s = B.encrypt_float_vector(cps, np.full(SLOTS, S_V))[0]
    return X, Y, [X, Y], s


# op name -> (function of (basics module, cps, X, Y, M, s), expected slot
# values of the first result ciphertext or None, tolerance)
OPS = {
    "encode_float_matrix": (lambda B, c, X, Y, M, s: B.encode_float_matrix(c, X_V), None, 0),
    "encrypt_float_matrix": (lambda B, c, X, Y, M, s: B.encrypt_float_matrix(c, X_V),
                             X_V[0, :SLOTS], 1e-5),
    "encrypt_plain_vector": (lambda B, c, X, Y, M, s: B.encrypt_plain_vector(
        c, B.encode_float_vector(c, X_V[1])), X_V[1, :SLOTS], 1e-5),
    "encrypt_plain_matrix": (lambda B, c, X, Y, M, s: B.encrypt_plain_matrix(
        c, B.encode_float_matrix(c, X_V)), X_V[0, :SLOTS], 1e-5),
    "czeros": (lambda B, c, X, Y, M, s: B.czeros(c, 2), np.zeros(SLOTS), 1e-9),
    "czero_mat": (lambda B, c, X, Y, M, s: B.czero_mat(c, 2, 3), np.zeros(SLOTS), 1e-9),
    "cadd": (lambda B, c, X, Y, M, s: B.cadd(c, X, Y), (X_V[0] + X_V[1])[:SLOTS], 1e-5),
    "csub": (lambda B, c, X, Y, M, s: B.csub(c, X, Y), (X_V[0] - X_V[1])[:SLOTS], 1e-5),
    "cneg": (lambda B, c, X, Y, M, s: B.cneg(c, X), -X_V[0, :SLOTS], 1e-5),
    "cmult": (lambda B, c, X, Y, M, s: B.cmult(c, X, Y), (X_V[0] * X_V[1])[:SLOTS], 1e-4),
    "cpmult": (lambda B, c, X, Y, M, s: B.cpmult(c, X, B.encode_float_vector(c, X_V[1])),
               (X_V[0] * X_V[1])[:SLOTS], 1e-4),
    "cpadd": (lambda B, c, X, Y, M, s: B.cpadd(c, X, B.encode_float_vector(c, X_V[1])),
              (X_V[0] + X_V[1])[:SLOTS], 1e-5),
    "cmult_const": (lambda B, c, X, Y, M, s: B.cmult_const(c, X, 2.5) + B.cmult_const(
        c, Y, -1.5, rescale=False), 2.5 * X_V[0, :SLOTS], 1e-4),
    "cmult_const_mat": (lambda B, c, X, Y, M, s: B.cmult_const_mat(c, M, 0.5),
                        0.5 * X_V[0, :SLOTS], 1e-4),
    "cadd_const": (lambda B, c, X, Y, M, s: B.cadd_const(c, X, 1.25), X_V[0, :SLOTS] + 1.25,
                   1e-5),
    "cmult_scalar": (lambda B, c, X, Y, M, s: B.cmult_scalar(c, X, s), S_V * X_V[0, :SLOTS],
                     1e-4),
    "rotate_left": (lambda B, c, X, Y, M, s: [B.rotate_left(c, X[0], 4),
                                              B.rotate_left(c, X[1], SLOTS)],
                    np.roll(X_V[0, :SLOTS], -4), 1e-4),
    "rotate_right": (lambda B, c, X, Y, M, s: [B.rotate_right(c, X[0], 2),
                                               B.rotate_right(c, X[1], 0)],
                     np.roll(X_V[0, :SLOTS], 2), 1e-4),
    "rotate_and_add": (lambda B, c, X, Y, M, s: B.rotate_and_add(c, X[0], 8),
                       sum(np.roll(X_V[0, :SLOTS], -k) for k in range(8)), 1e-3),
    "inner_sum_all": (lambda B, c, X, Y, M, s: B.inner_sum_all(c, X),
                      np.full(SLOTS, X_V[0].sum()), 1e-3),
    "inner_prod": (lambda B, c, X, Y, M, s: B.inner_prod(c, X, Y),
                   np.full(SLOTS, X_V[0] @ X_V[1]), 1e-2),
    "sq_sum": (lambda B, c, X, Y, M, s: B.sq_sum(c, Y), np.full(SLOTS, X_V[1] @ X_V[1]), 1e-2),
    "cmult_one_to_many": (lambda B, c, X, Y, M, s: B.cmult_one_to_many(c, s, X + Y),
                          S_V * X_V[0, :SLOTS], 1e-4),
    "rotate_and_add_many": (lambda B, c, X, Y, M, s: B.rotate_and_add_many(c, X + Y, 4),
                            sum(np.roll(X_V[0, :SLOTS], -k) for k in range(4)), 1e-3),
    "cmult_pairs": (lambda B, c, X, Y, M, s: B.cmult_pairs(c, X + [s], Y + [X[0]]),
                    (X_V[0] * X_V[1])[:SLOTS], 1e-4),
    "mask": (lambda B, c, X, Y, M, s: [B.mask(c, X[0], 3, False, 2.0), B.mask(c, X[1], 5, True),
                                       B.mask(c, None, 0, True)],
             np.where(np.arange(SLOTS) == 3, 2 * X_V[0, :SLOTS], 0.0), 1e-4),
    "ones_rescale": (lambda B, c, X, Y, M, s: B.ones_rescale(c, X[0]), X_V[0, :SLOTS], 1e-4),
    "mask_trunc": (lambda B, c, X, Y, M, s: [B.mask_trunc(c, X[0], 70, 0.5), B.mask_trunc(
        c, X[1], SLOTS), B.mask_trunc(c, Y[0], 9, target_scale=1.01 * c.ctx.params.scale)],
                   np.where(np.arange(SLOTS) < 70, 0.5 * X_V[0, :SLOTS], 0.0), 1e-4),
    "cmult_with_const": (lambda B, c, X, Y, M, s: B.cmult_with_const(c, X, Y, 0.25),
                         0.25 * (X_V[0] * X_V[1])[:SLOTS], 1e-3),
    "rebalance": (lambda B, c, X, Y, M, s: [B.rebalance(c, X[0]), B.rebalance(c, None)],
                  np.full(SLOTS, X_V[0, :SLOTS].mean()), 1e-3),
    "flatten_levels": (lambda B, c, X, Y, M, s: B.flatten_levels(
        c, [X, [c.ctx.drop_to(Y[0], 5), Y[1]]]), X_V[0, :SLOTS], 1e-5),
    "flatten_levels_vec": (lambda B, c, X, Y, M, s: B.flatten_levels_vec(
        c, [c.ctx.drop_to(X[0], 6), X[1]]), X_V[0, :SLOTS], 1e-5),
    "drop_level": (lambda B, c, X, Y, M, s: B.drop_level(c, [X, [c.ctx.drop_to(Y[0], 3)]], 5),
                   X_V[0, :SLOTS], 1e-5),
    "concat_cipher_matrix": (lambda B, c, X, Y, M, s: B.concat_cipher_matrix(
        [[X[:1], Y[:1]], [], [X[1:], Y[1:]]]), X_V[0, :SLOTS], 1e-5),
    "copy_vec": (lambda B, c, X, Y, M, s: B.copy_vec(X), X_V[0, :SLOTS], 1e-5),
    "copy_mat": (lambda B, c, X, Y, M, s: B.copy_mat(M), X_V[0, :SLOTS], 1e-5),
    "global_to_party_index": (lambda B, c, X, Y, M, s: [
        B.global_to_party_index(c, [0, 300, 200], i, 3) for i in (0, 129, 299, 300, 499)],
        None, 0),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_basics_op_matches_reference(pair, op):
    rcps, pcps = pair
    fn, want, tol = OPS[op]
    r = fn(RB, rcps, *_inputs(RB, rcps))
    p = fn(PB, pcps, *_inputs(PB, pcps))
    _same(r, p)
    if want is not None:
        got = _dec(pcps, _flat(p)[0])
        assert np.allclose(got, want, atol=tol), (op, np.abs(got - want).max())


def test_global_to_party_index_values(pair):
    pcps = pair[1]
    assert PB.global_to_party_index(pcps, [0, 300, 200], 299, 3) == (1, 2, 43)
    assert PB.global_to_party_index(pcps, [0, 300, 200], 300, 3) == (2, 0, 0)
    with pytest.raises(IndexError):
        PB.global_to_party_index(pcps, [0, 300, 200], 500, 3)


def _vals_cts(B, cps, vals):
    _reseed(cps, 9)
    return [B.encrypt_float_vector(cps, np.full(SLOTS, v))[0] for v in vals]


def test_expand_slots_many_matches(pair):
    rcps, pcps = pair
    v = np.random.default_rng(2).normal(size=SLOTS)
    idxs = [0, 3, 17, 101]
    outs = []
    for B, cps in ((RB, rcps), (PB, pcps)):
        _reseed(cps, 2)
        ct = B.encrypt_float_vector(cps, v)[0]
        outs.append(B.expand_slots_many(cps, ct, idxs)
                    + B.expand_slots_many(cps, ct, idxs[:2], cache_key="k", value_scales=[1.0, 1.002]))
    _same(*outs)
    for e, idx in enumerate(idxs):
        assert np.allclose(_dec(pcps, outs[1][e]), v[idx], atol=1e-2), idx


@pytest.mark.parametrize("outputs", [1, 2])
def test_mask_scatter_sum_matches(pair, outputs):
    """One packed output ciphertext, the value folded in (tests/
    test_batched_ops.py:70), and two outputs (:86); an input at a drifted
    scale folds its ratio into its mask value."""
    rcps, pcps = pair
    vals = np.random.default_rng(3 + outputs).normal(size=5 if outputs == 1 else 3)
    if outputs == 1:
        slot_lists, value = [[e, e + 37] for e in range(5)], 0.5
    else:
        slot_lists, value = [[0], [SLOTS + 5], [3, SLOTS + 9]], 1.0
    res = []
    for B, cps in ((RB, rcps), (PB, pcps)):
        cts = _vals_cts(B, cps, vals)
        if outputs == 2:
            cts[1] = type(cts[1])(cts[1].c0, cts[1].c1, cts[1].nmod, cts[1].scale * 0.997)
        res.append(B.mask_scatter_sum(cps, cts, slot_lists, outputs, value=value)
                   + B.mask_scatter_sum(cps, cts, slot_lists, outputs, value=value,
                                        cache_key=("t", outputs)))
    _same(*res)
    dec = [_dec(pcps, ct) for ct in res[1][:outputs]]
    want = np.zeros((outputs, SLOTS))
    for e, sl in enumerate(slot_lists):
        for g in sl:
            want[g // SLOTS, g % SLOTS] += value * vals[e]
    if outputs == 2:  # the drifted input decodes at its declared scale
        want[1, 5] /= 0.997
    assert np.allclose(np.stack(dec), want, atol=1e-2)


def test_add_group_mod_matches(pair):
    rcps, pcps = pair
    vs = [np.random.default_rng(5 + i).normal(size=SLOTS) for i in range(6)]
    groups = [0, 1, 0, 2, 1, 0]
    res = []
    for B, cps in ((RB, rcps), (PB, pcps)):
        _reseed(cps, 5)
        cts = [B.encrypt_float_vector(cps, v)[0] for v in vs]
        out = B.add_group_mod(cps, cts, groups, 3)
        drifted = [type(c)(c.c0, c.c1, c.nmod, c.scale * (1 + 1e-3 * i)) for i, c in enumerate(cts)]
        res.append(out + B.add_group_mod(cps, drifted, groups, 3, out_scale=cts[0].scale))
    _same(*res)
    for g in range(3):
        want = sum(v for v, gg in zip(vs, groups) if gg == g)
        assert np.allclose(_dec(pcps, res[1][g]), want, atol=1e-2)


def test_segment_sum_is_exact():
    """_segsum_mod against a Python-int sum at the largest group the
    reference allows (63 residues just below a 26-bit prime)."""
    import torch

    q = torch.tensor([[(1 << 26) - 5], [33554393]], dtype=torch.int32)
    c = (q[None] - 1 - torch.arange(63)[:, None, None]).expand(63, 2, 4).contiguous().int()
    seg = torch.zeros(63, dtype=torch.int64)
    s0, s1 = PB._segsum_mod(c, c, seg, q, 1)
    want = [sum(int(v) for v in c[:, r, 0]) % int(q[r, 0]) for r in range(2)]
    assert s0[0, :, 0].tolist() == want and torch.equal(s0, s1)


def test_mask_stacks_are_per_bundle(pair):
    """Mask stacks live on their key bundle: a bundle of another preset (or
    a second bundle of the same one) never reads another's stack, whatever
    the addresses of the objects."""
    pcps = pair[1]
    other = _keys(PC.CkksContext(port_get_params("TEST10"), device="cpu"), CryptoParams, seed=8)
    for cps in (pcps, other):
        cps._masks.clear()
        ct = PB.encrypt_float_vector(_reseed(cps, 1), np.ones(cps.slots), nmod=9)[0]
        PB.expand_slots_many(cps, ct, [0, 1], cache_key="same")
    (k1, s1), (k2, s2) = next(iter(pcps._masks.items())), next(iter(other._masks.items()))
    assert k1 == k2 and s1.shape[-1] == pcps.ctx.n and s2.shape[-1] == other.ctx.n != pcps.ctx.n
    assert not hasattr(PB, "_MASK_STACK_CACHE")


def test_cipher_matrix_carried_across(pair):
    """interop carries the reference's cipher matrix (columns of
    ciphertexts, a party's None placeholders kept) into the port, where an
    op gives the reference's result on it."""
    from sfgwas_tpu_torch import interop

    rcps, pcps = pair
    rm = RB.encrypt_float_matrix(_reseed(rcps, 3), X_V)
    arrays = interop.cipher_matrix_arrays(rm + [[None]])
    pm = interop.cipher_matrix(pcps.ctx, arrays)
    assert pm[-1] == [None]
    _same(rm, pm[:-1])
    _same(RB.cmult_const_mat(rcps, rm, 0.5), PB.cmult_const_mat(pcps, pm[:-1], 0.5))
