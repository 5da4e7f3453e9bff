"""Port parity with the reference's default NTT engine on an accelerator,
sfgwas_tpu/ops/ntt4.py (the four-step transform over int8 digit planes).
The port runs every NTT on K1, whose plain version is the butterfly of
sfgwas_tpu_torch/ops/rns.py; these tests hold that butterfly bit-equal to
the reference's ntt4 / ntt4_b wherever those are right, and pin the
reference's single-row order fault, where they are not."""

import jax.numpy as jnp
import numpy as np
import pytest

from sfgwas_tpu.crypto.params import get_params as ref_get_params
from sfgwas_tpu.ops import ntt4 as RN
from sfgwas_tpu.ops import rns as RR
from sfgwas_tpu_torch.crypto.params import get_params as port_get_params
from sfgwas_tpu_torch.ops import rns as PR


def _residues(primes, rows, B_, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, primes[r], (B_, n)) for r in rows]).astype(np.uint32)


def _bases(logn, nmod):
    primes = RR.gen_primes(nmod, logn, 25)
    return RR.RnsBasis(primes, logn), PR.RnsBasis(primes, logn)


def _is_permutation(pi, n):
    return np.array_equal(np.sort(np.asarray(pi)), np.arange(n))


@pytest.mark.parametrize("logn,nmod", [(8, 5), (12, 6), (13, 4)])
def test_butterfly_matches_reference_ntt4(logn, nmod):
    rb, pb = _bases(logn, nmod)
    rows = tuple(range(nmod))
    x = _residues(pb.primes, rows, 1, pb.n, logn)[:, 0]
    got = PR.to_u32(PR._ntt_butterfly(PR.as_i32(x), pb, rows))
    assert np.array_equal(got, np.asarray(RN.ntt4(jnp.asarray(x), rb, rows)))
    assert np.array_equal(PR.to_u32(PR._ntt_butterfly(PR.as_i32(got), pb, rows, True)), x)
    assert np.array_equal(np.asarray(RN.ntt4(jnp.asarray(got), rb, rows, inverse=True)), x)


@pytest.mark.parametrize("Bn", [3, 33])
def test_butterfly_b_matches_reference_ntt4_b(Bn):
    """33 polys: past the reference's 32-poly chunk (its padded lax.map)."""
    rb, pb = _bases(9, 3)
    rows = (0, 1, 2)
    x = _residues(pb.primes, rows, Bn, pb.n, Bn)
    got = PR.to_u32(PR._ntt_b_butterfly(PR.as_i32(x), pb, rows))
    assert np.array_equal(got, np.asarray(RN.ntt4_b(jnp.asarray(x), rb, rows)))
    assert np.array_equal(np.asarray(RN.ntt4_b(jnp.asarray(got), rb, rows, inverse=True)), x)


@pytest.fixture(scope="module")
def pn14():
    return ref_get_params("PN14QP438"), port_get_params("PN14QP438")


@pytest.mark.parametrize("row", ["special", 0])
def test_reference_single_row_order_fault(pn14, row):
    """PN14QP438, one prime row (the special row ModDown inverts, or row
    0): the reference matches its output order on that row alone, its
    values collide (n^2 / 2q ~ 4), so its pi is not a permutation and its
    inverse differs from the butterfly the port runs."""
    rp, pp = pn14
    rows = (rp.sp_row,) if row == "special" else (row,)
    assert not _is_permutation(RN.get_plan(rp.basis, rows).pi, rp.basis.n)
    x = _residues(pp.basis.primes, rows, 1, pp.basis.n, 99)[:, 0]
    fwd = PR.to_u32(PR._ntt_butterfly(PR.as_i32(x), pp.basis, rows))
    assert np.array_equal(PR.to_u32(PR._ntt_butterfly(PR.as_i32(fwd), pp.basis, rows, True)), x)
    ref_back = np.asarray(RN.ntt4(jnp.asarray(fwd), rp.basis, rows, inverse=True))
    assert (ref_back != x).sum() > pp.basis.n // 2


def test_reference_two_rows_are_right(pn14):
    """With two rows the reference's order matching does not collide: its
    pi is a permutation and both directions equal the butterfly."""
    rp, pp = pn14
    rows = (0, 1)
    assert _is_permutation(RN.get_plan(rp.basis, rows).pi, rp.basis.n)
    x = _residues(pp.basis.primes, rows, 1, pp.basis.n, 98)[:, 0]
    fwd = PR.to_u32(PR._ntt_butterfly(PR.as_i32(x), pp.basis, rows))
    assert np.array_equal(np.asarray(RN.ntt4(jnp.asarray(x), rp.basis, rows)), fwd)
    assert np.array_equal(np.asarray(RN.ntt4(jnp.asarray(fwd), rp.basis, rows, inverse=True)), x)
