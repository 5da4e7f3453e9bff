"""The sharded product on the card, at TEST8: K2 over each shard slot's
runs against the plain version on the same inputs (one, two and three
slots of one card), and the sharded product over two logical shards of the
card bit-equal to the unsharded one.  Every test needs an NVIDIA card and
skips without one.  Run on a machine with the card and the CUDA toolkit:

    python -m pytest --noconftest -q tests/test_torch_shard_cuda.py"""

import math

import numpy as np
import pytest
import torch

from sfgwas_tpu_torch.crypto import basics as B
from sfgwas_tpu_torch.crypto import ckks as PC
from sfgwas_tpu_torch.crypto.params import get_params
from sfgwas_tpu_torch.gwas import matmult as PMM
from sfgwas_tpu_torch.mpc.mhe import CryptoParams
from sfgwas_tpu_torch.ops import cuda_build, rns

pytestmark = pytest.mark.needs_cuda

PRESET = "TEST8"


@pytest.fixture(scope="module")
def product():
    """2 block rows x 3 block columns at 128 slots, 2 encrypted rows, keys
    made on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cuda_build.build()
    dev = torch.device("cuda", 0)
    params = get_params(PRESET)
    ctx = PC.CkksContext(params, device=dev)
    rng = np.random.default_rng(5)
    sk = ctx.gen_secret_key(rng)
    pk = ctx.gen_public_key(sk, rng)
    cps = CryptoParams(ctx, sk, pk, None, {}, rng)
    X = rng.integers(0, 3, size=(200, 300)).astype(np.int8)
    nmod = PMM.mm_nmod(cps)
    cache = PMM.preprocess_matrix(cps, X, nmod)
    d = int(math.ceil(math.sqrt(params.slots)))
    shifts = {int(b) for row in cache for blk in row for b in blk.babies}
    shifts |= {(int(g) * d) % params.slots for row in cache for blk in row for g in blk.giants}
    shifts.discard(0)
    gels = sorted({ctx.galois_for_rotation(k) for k in shifts})
    cps.rot_keys.update(ctx.gen_rot_keys_batched(sk, gels, rng, key_nmod=params.mm_nmod))
    Q = rng.normal(size=(2, 200)) * 0.5
    A = [[ctx.drop_to(B.encrypt_float_vector(cps, Q[i, b0 : b0 + params.slots])[0], nmod)
          for b0 in range(0, 200, params.slots)] for i in range(2)]
    return cps, A, cache, nmod, dev


def _same(out, ref):
    return all(torch.equal(a.c0, b.c0) and torch.equal(a.c1, b.c1)
               for ra, rb in zip(out, ref) for a, b in zip(ra, rb))


@pytest.mark.parametrize("slots", [1, 2, 3])
@pytest.mark.parametrize("row_batch", [1, 2])
def test_slot_launches_equal_plain(product, row_batch, slots):
    cps, A, cache, nmod, dev = product
    ctx = cps.ctx
    q = ctx._t(range(nmod))["q"]
    mu = rns.barrett_mu64(ctx.basis, range(nmod), dev)
    plan = PMM._MatmulPlan(cps, cache, nmod, row_batch)
    shape = (len(plan.segments) + 1, row_batch, nmod, ctx.n)
    launched = 0
    for bi, row in enumerate(plan.groups([dev] * slots if slots > 1 else None)):
        R0, R1 = PMM.baby_rotations(cps, A[:row_batch], plan, bi)
        for g in row:
            k0, k1, p0, p1 = (torch.zeros(shape, dtype=torch.int32, device=dev) for _ in range(4))
            PMM.mac_dense(k0, k1, R0, R1, g["polys"], g["runs"], q, mu, ctx.params.logn)
            PMM.mac_dense_plain(p0, p1, R0, R1, g["polys"], g["runs"], q)
            assert torch.equal(k0, p0) and torch.equal(k1, p1)
            launched += 1
    assert launched == 2 * slots


def test_sharded_product_on_two_logical_shards(product):
    cps, A, cache, nmod, dev = product
    dense = PMM.mat_mult_cached(cps, A, cache)
    cuda_build.reset_launch_counts()
    sharded = PMM.mat_mult_sharded(cps, A, cache, devices=[dev, dev])
    assert cuda_build.REGISTRY["mac_dense"].launches == 2 * 2  # block rows x slots
    assert _same(sharded, dense)
