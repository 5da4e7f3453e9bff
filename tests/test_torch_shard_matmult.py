"""Port parity for within-party sharding: mat_mult_sharded and the pipeline
routing of sfgwas_tpu_torch against sfgwas_tpu at TEST8 (bit-identical
ciphertexts under carried keys), at the shapes of tests/test_matmult.py's
sharding tests.  The port shards over three logical CPU shards ([cpu] * 3:
each list entry is its own shard slot); the reference over the 8 virtual
CPU devices of tests/conftest.py."""

import math

import jax
import numpy as np
import pytest
import torch

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
CPU3 = [torch.device("cpu")] * 3
CPU = torch.device("cpu")


def both_packages(Q, X, seed):
    """Keys, rows of A and the diagonal cache of X in both packages (the
    reference's keys and ciphertexts carried to the port), and the
    reference's single-device product."""
    rng = np.random.default_rng(seed)
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
    rcps.rot_keys.update(rctx.gen_rot_keys_batched(sk, gels, rng, key_nmod=rctx.params.mm_nmod))
    A = [[rctx.drop_to(RB.encrypt_float_vector(rcps, Q[i, b0 : b0 + SLOTS])[0], nmod)
          for b0 in range(0, Q.shape[1], SLOTS)] for i in range(len(Q))]
    pctx = PC.CkksContext(port_get_params(PRESET), device="cpu")
    pcps = interop.crypto_params(
        pctx, np.asarray(sk.s), (np.asarray(pk.p0), np.asarray(pk.p1)),
        {g: (np.asarray(k.d0), np.asarray(k.d1)) for g, k in rcps.rot_keys.items()},
    )
    pA = [[interop.ciphertext(pctx, np.asarray(ct.c0), np.asarray(ct.c1), ct.nmod, ct.scale)
           for ct in row] for row in A]
    pcache = PMM.preprocess_matrix(pcps, X, nmod)
    return dict(rcps=rcps, A=A, rcache=rcache, pcps=pcps, pA=pA, pcache=pcache, sk=sk)


def assert_same(port_out, ref_out):
    assert len(port_out) == len(ref_out)
    for prow, rrow in zip(port_out, ref_out):
        assert len(prow) == len(rrow)
        for pct, rct in zip(prow, rrow):
            assert (pct.nmod, pct.scale) == (rct.nmod, rct.scale)
            assert np.array_equal(port_rns.to_u32(pct.c0), np.asarray(rct.c0))
            assert np.array_equal(port_rns.to_u32(pct.c1), np.asarray(rct.c1))


# tests/test_matmult.py:72-145: 1 row against 1 x 3 and 1 x 3 block grids
SHAPES = {"sharded": (13, 1, 120, 300), "routing": (17, 1, 100, 260)}


@pytest.fixture(scope="module", params=sorted(SHAPES))
def pair(request):
    seed, s, n, m = SHAPES[request.param]
    rng = np.random.default_rng(seed)
    Q = rng.normal(size=(s, n)) * 0.5
    X = rng.integers(0, 3, size=(n, m)).astype(np.int8)
    p = both_packages(Q, X, seed)
    p.update(Q=Q, X=X, ref=RMM.mat_mult_cached(p["rcps"], p["A"], p["rcache"]))
    return p


@pytest.fixture(scope="module")
def single_and_ref_sharded(pair):
    """The port's single-device product and the reference's sharded one
    (over jax.local_devices()), which both slot counts compare against."""
    return (PMM.mat_mult_cached(pair["pcps"], pair["pA"], pair["pcache"]),
            RMM.mat_mult_sharded(pair["rcps"], pair["A"], pair["rcache"],
                                 devices=jax.local_devices()))


@pytest.mark.parametrize("slots", [2, 3])
def test_sharded_bit_equal_to_single_device_and_reference(pair, single_and_ref_sharded, slots):
    pcps, pA, pcache = pair["pcps"], pair["pA"], pair["pcache"]
    single, ref_sharded = single_and_ref_sharded
    sharded = PMM.mat_mult_sharded(pcps, pA, pcache, devices=[CPU] * slots)
    assert len(jax.local_devices()) == 8
    assert_same(single, pair["ref"])
    assert_same(sharded, pair["ref"])
    assert_same(sharded, ref_sharded)
    # and the plaintext product
    pctx = pcps.ctx
    got = np.concatenate([pctx.decode(pctx.decrypt(ct, pcps.sk)) for ct in sharded[0]])
    want = (pair["Q"] @ pair["X"].astype(np.float64))[0]
    assert np.abs(got[: len(want)] - want).max() < 1e-2


def test_sharded_one_device_is_the_plain_call(pair, monkeypatch):
    """mat_mult_sharded with one device (or none on a CPU context: [cpu])
    is mat_mult_cached without devices."""
    calls = []
    real = PMM.mat_mult_cached
    monkeypatch.setattr(PMM, "mat_mult_cached",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    out = PMM.mat_mult_sharded(pair["pcps"], pair["pA"], pair["pcache"])
    PMM.mat_mult_sharded(pair["pcps"], pair["pA"], pair["pcache"], devices=[CPU])
    assert calls == [{}, {}]
    assert_same(out, pair["ref"])


def record_groups(monkeypatch):
    """The devices of every plan.groups() call while patched."""
    seen = []
    real = PMM._MatmulPlan.groups
    monkeypatch.setattr(PMM._MatmulPlan, "groups",
                        lambda self, devices=None: seen.append(devices) or real(self, devices))
    return seen


def test_pipeline_routing_sets_and_clears(pair, monkeypatch):
    """set_pipeline_devices routes every product without devices= over the
    list (bit-equal); None, or a list of one, clears it."""
    seen = record_groups(monkeypatch)
    try:
        PMM.set_pipeline_devices(CPU3)
        assert PMM._pipeline_devices == CPU3
        out = PMM.mat_mult_cached(pair["pcps"], pair["pA"], pair["pcache"])
        assert seen == [CPU3]
        assert_same(out, pair["ref"])
        PMM.set_pipeline_devices([CPU])
        assert PMM._pipeline_devices is None
        PMM.set_pipeline_devices(CPU3)
    finally:
        PMM.set_pipeline_devices(None)
    assert PMM._pipeline_devices is None
    assert_same(PMM.mat_mult_cached(pair["pcps"], pair["pA"], pair["pcache"]), pair["ref"])
    assert seen == [CPU3, None]


@pytest.mark.parametrize("slots", [2, 3])
def test_sharded_groups_per_slot(pair, slots):
    """Each shard slot of one device makes one launch per block row (block
    column bj on slot bj % slots), with its own runs on its device; the
    slots' runs together are the unsharded launch's."""
    plan = PMM._plan_for(pair["pcps"], pair["pcache"], PMM.mm_nmod(pair["pcps"]))
    (row,) = plan.groups([CPU] * slots)
    assert len(row) == slots and plan.nbc == 3
    sgs = [set(g["runs"].run_sg_host.tolist()) for g in row]
    for slot, (g, got) in enumerate(zip(row, sgs)):
        assert g["dev"] == CPU and g["runs"].entry_diag.device == CPU
        assert got == {si for si, (bj, _) in enumerate(plan.segments) if bj % slots == slot}
    (one,) = plan.groups()[0]
    assert set(one["runs"].run_sg_host.tolist()) == set().union(*sgs)
    # each slot's polys hold just its own blocks' diagonals
    assert sum(g["runs"].entry_diag.numel() for g in row) == one["runs"].entry_diag.numel()
    assert sum(g["polys"].shape[0] for g in row) == one["polys"].shape[0]


def test_sharded_host_streamed_product(pair):
    """A host-streamed cache, a few diagonals a launch, over three shards:
    each slot's chunks cut into their own bounded launches, bit-equal to
    the reference's product."""
    pcps, nmod = pair["pcps"], PMM.mm_nmod(pair["pcps"])
    cache = PMM.preprocess_matrix(pcps, pair["X"], nmod, host_resident=True)
    group = 5 * nmod * pcps.ctx.n * 4
    out = PMM.mat_mult_cached(pcps, pair["pA"], cache, group_bytes=group, devices=CPU3)
    plan = PMM._plan_for(pcps, cache, nmod, len(pair["pA"]), group_bytes=group)
    (row,) = plan.groups(CPU3)
    (one,) = plan.groups()
    assert plan.stream and len(row) >= len(one) > 4
    slot_of = {si: bj % 3 for si, (bj, _) in enumerate(plan.segments)}
    assert all(len({slot_of[sg] for sg in g["runs"].run_sg_host.tolist()}) == 1 for g in row)
    assert_same(out, pair["ref"])
