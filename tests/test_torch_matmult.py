"""Port parity: the diagonal cache and mat_mult_cached of sfgwas_tpu_torch
against sfgwas_tpu at TEST8 (bit-identical ciphertexts under carried keys)
and against the numpy oracle Q @ X."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from sfgwas_tpu.crypto import basics as RB
from sfgwas_tpu.crypto import ckks as RC
from sfgwas_tpu.crypto.params import get_params as ref_get_params
from sfgwas_tpu.gwas import matmult as RMM
from sfgwas_tpu.mpc.mhe import CryptoParams as RefCryptoParams
from sfgwas_tpu_torch import interop
from sfgwas_tpu_torch.crypto import ckks as PC
from sfgwas_tpu_torch.crypto.params import get_params as port_get_params
from sfgwas_tpu_torch.gwas import matmult as PMM
from sfgwas_tpu_torch.ops import rns as port_rns

PRESET = "TEST8"
SLOTS = 128


def _u32(t):
    return port_rns.to_u32(t)


@pytest.fixture(scope="module")
def setup():
    """2 block rows x 2 block cols at 128 slots, s = 2 encrypted rows; keys,
    ciphertexts and the reference's product made on the reference side."""
    rng = np.random.default_rng(11)
    s, n, m = 2, 200, 150
    Q = rng.normal(size=(s, n)) * 0.5
    X = rng.integers(0, 3, size=(n, m)).astype(np.int8)
    rctx = RC.CkksContext(ref_get_params(PRESET))
    sk = rctx.gen_secret_key(rng)
    pk = rctx.gen_public_key(sk, rng)
    rcps = RefCryptoParams(rctx, sk, pk, None, {}, rng)
    nmod = RMM.mm_nmod(rcps)
    rcache = RMM.preprocess_matrix(rcps, X, nmod)
    d = int(math.ceil(math.sqrt(SLOTS)))
    shifts = set()
    for row in rcache:
        for blk in row:
            shifts.update(int(b) for b in blk.babies)
            shifts.update((int(g) * d) % SLOTS for g in blk.giants)
    shifts.discard(0)
    gels = sorted({rctx.galois_for_rotation(k) for k in shifts})
    rcps.rot_keys.update(
        rctx.gen_rot_keys_batched(sk, gels, rng, key_nmod=rctx.params.mm_nmod)
    )
    A = [
        [rctx.drop_to(RB.encrypt_float_vector(rcps, Q[i, b0 : b0 + SLOTS])[0], nmod)
         for b0 in range(0, n, SLOTS)]
        for i in range(s)
    ]
    rout = RMM.mat_mult_cached(rcps, A, rcache)

    pctx = PC.CkksContext(port_get_params(PRESET), device="cpu")
    pcps = interop.crypto_params(
        pctx,
        np.asarray(sk.s),
        (np.asarray(pk.p0), np.asarray(pk.p1)),
        {g: (np.asarray(k.d0), np.asarray(k.d1)) for g, k in rcps.rot_keys.items()},
    )
    pA = [
        [interop.ciphertext(pctx, np.asarray(ct.c0), np.asarray(ct.c1), ct.nmod, ct.scale)
         for ct in row]
        for row in A
    ]
    return dict(Q=Q, X=X, nmod=nmod, rctx=rctx, rcache=rcache, rout=rout,
                pctx=pctx, pcps=pcps, pA=pA, sk=sk)


def test_diag_cache_matches_reference(setup):
    pcache = PMM.preprocess_matrix(setup["pcps"], setup["X"], setup["nmod"])
    rcache = setup["rcache"]
    assert len(pcache) == len(rcache) == 2 and len(pcache[0]) == len(rcache[0]) == 2
    for prow, rrow in zip(pcache, rcache):
        for pb, rb in zip(prow, rrow):
            assert pb.d == rb.d
            assert np.array_equal(pb.giants, rb.giants)
            assert np.array_equal(pb.babies, rb.babies)
            assert np.array_equal(_u32(pb.polys), np.asarray(rb.polys))
    setup["pcache"] = pcache


def test_mat_mult_cached_bit_identical_and_oracle(setup):
    pcps, pctx = setup["pcps"], setup["pctx"]
    pcache = setup.get("pcache") or PMM.preprocess_matrix(pcps, setup["X"], setup["nmod"])
    pout = PMM.mat_mult_cached(pcps, setup["pA"], pcache)
    rout, rctx, sk = setup["rout"], setup["rctx"], setup["sk"]
    Q, X = setup["Q"], setup["X"]
    want = Q @ X.astype(np.float64)
    m = X.shape[1]
    for i, (prow, rrow) in enumerate(zip(pout, rout)):
        assert len(prow) == len(rrow) == 2
        for pct, rct in zip(prow, rrow):
            assert (pct.nmod, pct.scale) == (rct.nmod, rct.scale)
            assert np.array_equal(_u32(pct.c0), np.asarray(rct.c0))
            assert np.array_equal(_u32(pct.c1), np.asarray(rct.c1))
        got = np.concatenate([pctx.decode(pctx.decrypt(ct, pcps.sk)) for ct in prow])
        ref = np.concatenate([rctx.decode(rctx.decrypt(ct, sk)) for ct in rrow])
        assert np.array_equal(got, ref)
        err = np.abs(got[:m] - want[i]).max()
        assert err < 1e-2, (i, err)


def test_mat_mult_cached_on_carried_cache(setup):
    """The reference's diagonal cache carried across gives the same
    product as the port's own preprocess (one block column of X)."""
    pcps = setup["pcps"]
    blocks = [[(b.giants, b.babies, np.asarray(b.polys), b.d) for b in row[:1]]
              for row in setup["rcache"]]
    carried = interop.diag_cache(pcps.ctx, blocks)
    own = PMM.preprocess_matrix(pcps, setup["X"][:, :SLOTS], setup["nmod"])
    a = PMM.mat_mult_cached(pcps, setup["pA"], carried)
    b = PMM.mat_mult_cached(pcps, setup["pA"], own)
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            assert np.array_equal(_u32(x.c0), _u32(y.c0))
            assert np.array_equal(_u32(x.c1), _u32(y.c1))


def test_plan_bounds():
    """The plan asserts the lazy-sum bound the reference leaves unchecked,
    and splits long giant groups into chunks whose runs K2 sums exactly."""
    pctx = PC.CkksContext(port_get_params(PRESET), device="cpu")
    rng = np.random.default_rng(3)
    cps = interop.crypto_params(
        pctx, np.zeros((pctx.nq + 1, pctx.n), np.uint32),
        (np.zeros((pctx.nq + 1, pctx.n), np.uint32),) * 2, {},
    )
    X = rng.integers(0, 3, size=(SLOTS, SLOTS)).astype(np.int8)
    cache = PMM.preprocess_matrix(cps, X)
    plan = PMM._MatmulPlan(cps, cache, PMM.mm_nmod(cps), row_batch=2)
    assert 1 <= plan.nsub <= plan.max_lazy
    assert plan.k_pad % plan.nsub == 0
    (g,) = plan.groups()[0]
    runs = g["runs"]
    assert runs.longest == np.diff(runs.run_start_host).max() <= PMM.MAC_MAX_TERMS
    assert runs.longest * (max(plan.q_primes) - 1) ** 2 < 2**64
    assert len(set(runs.run_sg_host.tolist())) == runs.nruns
    assert np.array_equal(runs.run_start.numpy(), runs.run_start_host)


def test_mat_mult_cached_split_chunks(setup, monkeypatch):
    """Giant groups split over several chunks (a tiny chunk budget) form
    multi-chunk accumulator runs; the product stays bit-identical."""
    pcps = setup["pcps"]
    nmod = setup["nmod"]
    s = len(setup["pA"])
    monkeypatch.setattr(PMM, "MM_CHUNK_BYTES", 3 * nmod * pcps.ctx.n * 4 * s)
    cache = PMM.preprocess_matrix(pcps, setup["X"], nmod)
    plan = PMM._plan_for(pcps, cache, nmod, row_batch=s)
    assert max(np.diff(g["chunk_start"]).max() for row in plan.groups() for g in row) > 1
    pout = PMM.mat_mult_cached(pcps, setup["pA"], cache)
    for prow, rrow in zip(pout, setup["rout"]):
        for pct, rct in zip(prow, rrow):
            assert np.array_equal(_u32(pct.c0), np.asarray(rct.c0))
            assert np.array_equal(_u32(pct.c1), np.asarray(rct.c1))
