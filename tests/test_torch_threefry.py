"""Port parity: the threefry draws of sfgwas_tpu_torch against jax.random and
the JAX package at TEST8/TEST10 on the CPU: the key derivation and bits
stream, device_uniform_b (the CRPs, kernel K4's plain version), the
bootstrap mask words and folds (kernel K5's bs_mask) and the local rotation
keygen that draws its uniform halves from them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfgwas_tpu.crypto import ckks as RC
from sfgwas_tpu.crypto.params import get_params as ref_get_params
from sfgwas_tpu.mpc import mhe as RM
from sfgwas_tpu_torch.crypto import ckks as PC
from sfgwas_tpu_torch.crypto.params import get_params as port_get_params
from sfgwas_tpu_torch.mpc import mhe as PM
from sfgwas_tpu_torch.ops import rns as port_rns
from sfgwas_tpu_torch.ops import threefry


def _u32(t):
    return port_rns.to_u32(t)


@pytest.fixture(scope="module")
def ctxs():
    return {
        p: (RC.CkksContext(ref_get_params(p)), PC.CkksContext(port_get_params(p), device="cpu"))
        for p in ("TEST8", "TEST10")
    }


def test_threefry_partitionable_flag_is_pinned():
    """The port reproduces jax's partitionable threefry stream (the default
    of jax 0.9); a jax whose default differs draws other CRPs."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("s0,s1,idx", [(0, 0, 0), (1, 2, 3), (0xDEADBEEF, 0xFFFFFFFF, 40)])
def test_key_derivation_and_bits_match_jax(s0, s1, idx):
    """PRNGKey(s) = (0, s), fold_in = threefry2x32(key, (0, d)), and the
    uint32 bits of a shape with an odd count, word for word."""
    k0 = jax.random.PRNGKey(np.uint32(s0))
    assert tuple(int(v) for v in np.asarray(jax.random.key_data(k0))) == (0, s0)
    k = jax.random.fold_in(jax.random.fold_in(k0, np.uint32(s1)), np.uint32(idx))
    key = threefry.derive_key(s0, s1, idx)
    assert tuple(int(v) for v in np.asarray(jax.random.key_data(k))) == key
    want = np.asarray(jax.random.bits(k, (3, 5, 7), dtype=jnp.uint32)).ravel()
    got = threefry.bits(key, 0, want.size, "cpu").numpy()
    assert np.array_equal(got, want.astype(np.int64))
    tail = threefry.bits(key, 40, 65, "cpu").numpy()
    assert np.array_equal(tail, want[40:].astype(np.int64))


@pytest.mark.parametrize("preset,rows,batch,seed,idx", [
    ("TEST8", (0, 1, 2), 1, (1, 2), 0),
    ("TEST8", tuple(range(10)), 3, (0xDEADBEEF, 0x12345678), 5),  # odd count, idx > 0
    ("TEST10", (0, 4, 13), 5, (4000000000, 7), 296),
])
def test_device_uniform_b_matches_reference(ctxs, preset, rows, batch, seed, idx):
    rctx, pctx = ctxs[preset]
    want = np.asarray(RC.device_uniform_b(
        rctx, rows, batch, (np.uint32(seed[0]), np.uint32(seed[1])), np.uint32(idx)))
    got = PC.device_uniform_b(pctx, rows, batch, seed, idx)
    assert got.shape == (batch, len(rows), pctx.n)
    assert np.array_equal(_u32(got), want)
    # the wrapper takes K4's plain version for the CPU
    mu = port_rns.barrett_mu64(pctx.basis, rows, "cpu")
    assert torch.equal(PC.uniform_mod(pctx._t(rows)["q"], mu, seed, idx, batch, pctx.params.logn),
                       got)


@pytest.mark.parametrize("preset,nrows,ntgt,B,nwords,top_bits", [
    ("TEST8", 3, 9, 2, 3, 23),
    ("TEST8", 1, 1, 1, 1, 1),
    ("TEST10", 4, 11, 3, 5, 24),
])
def test_bs_mask_words_and_folds_match_reference(ctxs, preset, nrows, ntgt, B, nwords, top_bits):
    """The reference's share kernel with c1, s and the noise all zero is its
    mask: h1 = mask_l and h2 = -mask_f in the NTT domain."""
    rctx, pctx = ctxs[preset]
    rows, tgt = tuple(range(nrows)), tuple(range(ntgt))
    n = rctx.n
    z = lambda *s: jnp.zeros(s, jnp.uint32)  # noqa: E731
    seed = (np.uint32(0x9E3779B9), np.uint32(77))
    h1, h2 = RM._bs_share_kernel(rctx, rows, tgt, B, nwords, top_bits, seed, np.uint32(0),
                                 z(B, ntgt, n), z(B, nrows, n), z(rctx.nq + 1, n),
                                 z(B, nrows, n), z(B, ntgt, n))
    tl, tf = PM._bs_tables(pctx, rows, nwords), PM._bs_tables(pctx, tgt, nwords)
    ml, mf = PM.bs_mask(tl, tf, (int(seed[0]), int(seed[1])), 0, B, nwords, top_bits,
                        pctx.params.logn)
    ml, mf = pctx._ntt_b(ml, rows), pctx._ntt_b(mf, tgt)
    assert np.array_equal(_u32(ml.transpose(0, 1)), np.asarray(h1))
    qf = np.array([pctx.basis.primes[r] for r in tgt], np.int64)[None, :, None]
    neg = (qf - _u32(mf.transpose(0, 1)).astype(np.int64)) % qf
    assert np.array_equal(neg.astype(np.uint32), np.asarray(h2))


@pytest.mark.parametrize("chunk", [16, 4])
def test_gen_rot_keys_batched_matches_reference(ctxs, chunk):
    """The repaired local rotation keygen draws exactly as the reference's:
    the same rng gives the same keys, over one chunk or several."""
    rctx, pctx = ctxs["TEST8"]
    slots = rctx.params.slots
    gels = [rctx.galois_for_rotation(k) for k in (1, 2, 5, 11, 33, slots - 1)]
    rr, pr = np.random.default_rng(42), np.random.default_rng(42)
    rsk, psk = rctx.gen_secret_key(rr), pctx.gen_secret_key(pr)
    rk = rctx.gen_rot_keys_batched(rsk, gels, rr, key_nmod=rctx.params.mm_nmod, chunk=chunk)
    pk = pctx.gen_rot_keys_batched(psk, gels, pr, key_nmod=pctx.params.mm_nmod, chunk=chunk)
    assert sorted(pk) == sorted(rk)
    for g in gels:
        assert np.array_equal(_u32(pk[g].d0), np.asarray(rk[g].d0)), g
        assert np.array_equal(_u32(pk[g].d1), np.asarray(rk[g].d1)), g
    assert rr.integers(1 << 30) == pr.integers(1 << 30)  # the rng consumed alike
