"""The port's CUDA kernels against their plain torch versions on the card,
at small shapes (TEST8 / TEST10; K1 at every preset's ring size and at the
PN14 product's largest launch).  Every test here needs an NVIDIA card and
skips without one.  Run on a machine with the card and the CUDA toolkit:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(--noconftest: tests/conftest.py sets up jax for the reference's tests,
and these tests import nothing of jax.)"""

import numpy as np
import pytest
import torch

from sfgwas_tpu_torch.crypto import basics as B
from sfgwas_tpu_torch.crypto import ckks as PC
from sfgwas_tpu_torch.crypto.params import PRESETS, get_params, prime_chain
from sfgwas_tpu_torch.gwas import matmult as PMM
from sfgwas_tpu_torch.mpc.mhe import CryptoParams
from sfgwas_tpu_torch.ops import cuda_build, cuda_ntt, rns

pytestmark = pytest.mark.needs_cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cuda_build.build()
    return torch.device("cuda", 0)


def _residues(basis, rows, shape, seed, dev):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, basis.primes[r], size=shape) for r in rows])
    return rns.as_i32(x.astype(np.uint32)).to(dev)


# one preset per ring size the port builds (logn 8, 10, 12, 13, 14, 15)
NTT_PRESETS = ["TEST8", "TEST10", "PN12QP109", "PN13QP218", "PN14QP438", "PN15QP880"]
# polys per block of ntt.cu: 256 threads a block, 32 coefficients a thread
NTT_BLOCK_POLYS = {8: 32, 10: 8, 12: 2, 13: 1, 14: 1, 15: 1}


def _ntt_basis(preset):
    """Three primes of the preset's chain (building all its tables is slow
    at N = 2^15)."""
    spec = PRESETS[preset]
    return rns.RnsBasis(prime_chain(spec)[0][:3], spec.logn)


@pytest.mark.parametrize("case", ["random", "one_poly", "prime_polys", "block_plus_one",
                                  "one_row", "zero", "top"])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("preset", NTT_PRESETS)
def test_ntt_kernel_matches_plain(dev, preset, inverse, case):
    """Random residues of 3 rows x 5 polys; B = 1; a prime batch; one poly
    more than a block takes; one row; every input 0; every input q - 1."""
    basis = _ntt_basis(preset)
    rows = (2,) if case == "one_row" else (0, 1, 2)
    Bn = {"one_poly": 1, "prime_polys": 13,
          "block_plus_one": NTT_BLOCK_POLYS[basis.logn] + 1}.get(case, 5)
    x = _residues(basis, rows, (Bn, basis.n), 1, dev)
    if case in ("zero", "top"):
        q = rns._sel(basis, rows, dev)["q"].view(len(rows), 1, 1)
        x = torch.zeros_like(x) + (q - 1 if case == "top" else 0)
    before = cuda_ntt.NTT_INV.launches if inverse else cuda_ntt.NTT_FWD.launches
    y = cuda_ntt.ntt_b_kernel(x, basis, rows, inverse)
    torch.cuda.synchronize()
    assert torch.equal(y, rns._ntt_b_butterfly(x, basis, rows, inverse))
    after = cuda_ntt.NTT_INV.launches if inverse else cuda_ntt.NTT_FWD.launches
    assert after == before + 1


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_kernel_at_the_grouped_modup_shape(dev, inverse):
    """The PN14 product's largest launch, [8, 3416, 2^14] over the
    ModUp's rows (the 7 active primes and the special prime)."""
    params = get_params("PN14QP438")
    rows = tuple(range(7)) + (params.sp_row,)
    x = _residues(params.basis, rows, (3416, params.n), 3, dev)
    y = cuda_ntt.ntt_b_kernel(x, params.basis, rows, inverse)
    torch.cuda.synchronize()
    assert torch.equal(y, rns._ntt_b_butterfly(x, params.basis, rows, inverse))


def test_ntt_kernel_refuses_bad_input(dev):
    """A wrong ring size or row count raises on the host, a ring size with
    no kernel instance is refused by the launcher; nothing falls back to the
    plain version and nothing is counted."""
    basis = _ntt_basis("TEST10")
    x = _residues(basis, (0, 1), (2, basis.n), 4, dev)
    before = cuda_ntt.NTT_FWD.launches, cuda_ntt.NTT_INV.launches
    with pytest.raises(ValueError, match="rows of N"):
        cuda_ntt.ntt_b_kernel(x, basis, (0, 1, 2))
    with pytest.raises(ValueError, match="rows of N"):
        cuda_ntt.ntt_b_kernel(x[..., : basis.n // 2].contiguous(), basis, (0, 1), True)
    small = rns.RnsBasis(rns.gen_primes(2, 7), 7)
    with pytest.raises(RuntimeError, match="invalid argument"):
        cuda_ntt.ntt_b_kernel(_residues(small, (0, 1), (2, small.n), 5, dev), small, (0, 1))
    assert (cuda_ntt.NTT_FWD.launches, cuda_ntt.NTT_INV.launches) == before


def _ks_case(dev, basis, G, S, Bk, J, seed, X=4):
    rows = tuple(range(X - 1)) + (len(basis.primes) - 1,)
    q = rns._sel(basis, rows, dev)["q"]
    mu = rns.barrett_mu64(basis, rows, dev)
    ext = _residues(basis, rows, (G * S * J, basis.n), seed, dev)
    ext = ext.view(X, G, S, J, basis.n).permute(1, 2, 3, 0, 4).contiguous()
    k0 = _residues(basis, rows, (G * Bk * J, basis.n), seed + 1, dev)
    k0 = k0.view(X, G, Bk, J, basis.n).permute(1, 2, 3, 0, 4).contiguous()
    k1 = torch.flip(k0, dims=(-1,)).contiguous()
    return ext, k0, k1, q, mu


def test_ks_digit_kernel_matches_plain(dev):
    basis = get_params("TEST8").basis
    for G, S, Bk, J in ((1, 3, 5, 4), (4, 2, 1, 4)):
        ext, k0, k1, q, mu = _ks_case(dev, basis, G, S, Bk, J, 2)
        o = PC.ks_digit_product(ext, k0, k1, q, mu, basis.logn)
        p = PC.ks_digit_product_plain(ext, k0, k1, q)
        torch.cuda.synchronize()
        assert torch.equal(o[0], p[0]) and torch.equal(o[1], p[1])


@pytest.mark.parametrize("J", [1, 7, PC.KS_MAX_DIGITS])
@pytest.mark.parametrize("G,S,Bk", [(1, 8, 1), (1, 3, 17), (3, 5, 2), (2, 19, 1)])
def test_ks_digit_kernel_awkward_shapes(dev, J, G, S, Bk):
    """One digit, the main path's 7 and the largest instance; one key, a
    key count that leaves the last 16-key tile part full, several groups,
    and more rows than one block stages at the largest J."""
    basis = get_params("TEST10").basis
    ext, k0, k1, q, mu = _ks_case(dev, basis, G, S, Bk, J, 10 * J + S)
    o = PC.ks_digit_product(ext, k0, k1, q, mu, basis.logn)
    p = PC.ks_digit_product_plain(ext, k0, k1, q)
    torch.cuda.synchronize()
    assert torch.equal(o[0], p[0]) and torch.equal(o[1], p[1])


def test_ks_digit_kernel_refuses_bad_input(dev):
    basis = get_params("TEST8").basis
    q = rns._sel(basis, (0,), dev)["q"]
    mu = rns.barrett_mu64(basis, (0,), dev)
    ext = torch.zeros((1, 1, 1, 1, basis.n), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        PC.ks_digit_product(ext, ext.long(), ext, q, mu, basis.logn)
    with pytest.raises(ValueError, match="dtype"):
        PC.ks_digit_product(ext, ext, ext, q, q, basis.logn)
    with pytest.raises(ValueError, match="digits"):
        big = torch.zeros((1, 1, PC.KS_MAX_DIGITS + 1, 1, basis.n), dtype=torch.int32, device=dev)
        PC.ks_digit_product(big, big, big, q, mu, basis.logn)
    # the wrapper's digit limit is the library's
    assert cuda_build.load("ks_digit").ks_digit_max_digits() == PC.KS_MAX_DIGITS


def _mac_case(dev, basis, S, nb, run_lengths, seed, nmod=3, fill=None):
    """Random rotations, diagonals and a CSR list with the given run
    lengths (runs into accumulator rows in reverse order); fill = q - 1
    sets every residue to its largest value."""
    rng = np.random.default_rng(seed)
    rows = tuple(range(nmod))
    E = sum(run_lengths)
    q = rns._sel(basis, rows, dev)["q"]
    qn = np.array(basis.primes[:nmod], np.int64)[:, None]
    if fill is None:
        R0, R1 = (_residues(basis, rows, (nb * S, basis.n), seed + i, dev)
                  .view(nmod, nb, S, basis.n).permute(1, 2, 0, 3).contiguous() for i in (1, 2))
        polys = _residues(basis, rows, (E, basis.n), seed + 3, dev).transpose(0, 1).contiguous()
    else:
        top = torch.from_numpy((qn - 1).astype(np.int32)).to(dev)  # [nmod, 1]
        R0 = top.view(1, 1, nmod, 1).expand(nb, S, nmod, basis.n).contiguous()
        R1 = R0.clone()
        polys = top.view(1, nmod, 1).expand(E, nmod, basis.n).contiguous()
    nruns = len(run_lengths)
    starts = np.concatenate([[0], np.cumsum(run_lengths)])
    runs = PMM.MacRuns.from_host(rng.permutation(E), rng.integers(0, nb, E), starts,
                                 np.arange(nruns)[::-1], dev)
    acc0 = _residues(basis, rows, ((nruns + 1) * S, basis.n), seed + 4, dev)
    acc0 = acc0.view(nmod, nruns + 1, S, basis.n).permute(1, 2, 0, 3).contiguous()
    return (acc0, torch.flip(acc0, dims=(-1,)).contiguous(), R0, R1, polys, runs, q,
            rns.barrett_mu64(basis, rows, dev))


@pytest.mark.parametrize("S,nb,run_lengths", [
    (8, 5, [1] * 40),  # runs of length 1
    (8, 91, [91]),  # a single run
    (1, 12, [3, 50, 1, 17]),  # one row
    (3, 7, [33, 2, 64, 5, 31]),  # three rows: one block holds all three
    (16, 20, [9, 40]),  # two row groups of 8
])
def test_mac_dense_kernel_awkward_shapes(dev, S, nb, run_lengths):
    basis = get_params("TEST8").basis
    a0, a1, R0, R1, polys, runs, q, mu = _mac_case(dev, basis, S, nb, run_lengths, S + nb)
    p0, p1 = PMM.mac_dense_plain(a0.clone(), a1.clone(), R0, R1, polys, runs, q)
    before = PMM.MAC_DENSE.launches
    k0, k1 = PMM.mac_dense(a0, a1, R0, R1, polys, runs, q, mu, basis.logn)
    torch.cuda.synchronize()
    assert PMM.MAC_DENSE.launches == before + 1
    assert torch.equal(k0, p0) and torch.equal(k1, p1)


def test_mac_dense_kernel_longest_legal_run(dev):
    """One run of MAC_MAX_TERMS entries, every residue q - 1: the largest
    64-bit sum the wrapper lets through, reduced exactly; one entry more
    is refused on the host."""
    basis = get_params("TEST8").basis
    a0, a1, R0, R1, polys, runs, q, mu = _mac_case(
        dev, basis, 2, 4, [PMM.MAC_MAX_TERMS], 7, fill=True)
    p0, p1 = PMM.mac_dense_plain(a0.clone(), a1.clone(), R0, R1, polys, runs, q)
    k0, k1 = PMM.mac_dense(a0, a1, R0, R1, polys, runs, q, mu, basis.logn)
    torch.cuda.synchronize()
    assert torch.equal(k0, p0) and torch.equal(k1, p1)
    runs.longest += 1
    with pytest.raises(ValueError, match="terms in a run"):
        PMM.mac_dense(a0, a1, R0, R1, polys, runs, q, mu, basis.logn)


def test_mac_dense_kernel_refuses_babies_past_shared_memory(dev):
    """1000 babies: one row of their tiles does not fit in shared memory, so
    the kernel's dispatcher refuses the launch and nothing is counted."""
    basis = get_params("TEST8").basis
    a0, a1, R0, R1, polys, runs, q, mu = _mac_case(dev, basis, 1, 1000, [4], 3)
    before = PMM.MAC_DENSE.launches
    with pytest.raises(RuntimeError, match="invalid argument"):
        PMM.mac_dense(a0, a1, R0, R1, polys, runs, q, mu, basis.logn)
    assert PMM.MAC_DENSE.launches == before


def test_mat_mult_cached_kernels_match_plain_path(dev):
    """A TEST8 product with 2 block rows and 2 block columns: the kernel
    path and the plain path give the same ciphertexts, every kernel runs,
    and the decode agrees with Q @ X."""
    params = get_params("TEST8")
    ctx = PC.CkksContext(params, device=dev)
    rng = np.random.default_rng(5)
    sk = ctx.gen_secret_key(rng)
    pk = ctx.gen_public_key(sk, rng)
    cps = CryptoParams(ctx, sk, pk, None, {}, rng)
    s, n, m = 2, 200, 150
    X = rng.integers(0, 3, size=(n, m)).astype(np.int8)
    nmod = PMM.mm_nmod(cps)
    cache = PMM.preprocess_matrix(cps, X, nmod)
    d = cache[0][0].d
    shifts = {int(b) for row in cache for blk in row for b in blk.babies}
    shifts |= {(int(g) * d) % params.slots for row in cache for blk in row for g in blk.giants}
    shifts.discard(0)
    gels = sorted({ctx.galois_for_rotation(k) for k in shifts})
    cps.rot_keys.update(ctx.gen_rot_keys_batched(sk, gels, rng, key_nmod=params.mm_nmod))
    Q = rng.normal(size=(s, n)) * 0.5
    A = [[ctx.drop_to(B.encrypt_float_vector(cps, Q[i, b0:b0 + params.slots])[0], nmod)
          for b0 in range(0, n, params.slots)] for i in range(s)]
    cuda_build.reset_launch_counts()
    out = PMM.mat_mult_cached(cps, A, cache)
    torch.cuda.synchronize()
    # the product's kernels (K1, K2, K3) all run in it
    for name in ("ntt_fwd", "ntt_inv", "ks_digit_product", "mac_dense"):
        assert cuda_build.REGISTRY[name].launches > 0, name
    pcps = CryptoParams(PC.CkksContext(params, device=dev, kernels=False), sk, pk, None,
                        cps.rot_keys, rng)
    pout = PMM.mat_mult_cached(pcps, A, cache)
    want = Q @ X.astype(np.float64)
    for i in range(s):
        for a, b in zip(out[i], pout[i]):
            assert torch.equal(a.c0, b.c0) and torch.equal(a.c1, b.c1)
        got = np.concatenate([ctx.decode(ctx.decrypt(ct, sk)) for ct in out[i]])[:m]
        assert np.abs(got - want[i]).max() < 1e-2


# ---------------------------------------------------------------------------
# K4 (uniform_mod), K5 (bs_mask, bs_combine), K6 (crt_lift)


@pytest.mark.parametrize("preset,batch,rows,seed,idx,logn", [
    ("TEST8", 1, (0,), (1, 2), 0, None),  # one poly of one row
    ("TEST8", 3, (0, 1, 2, 9), (0xDEADBEEF, 0xFFFFFFFF), 7, None),  # odd counts, the special row
    ("TEST10", 5, (0, 3), (12345, 678), 40, None),
    ("PN14QP438", 1, tuple(range(18)), (3, 4), 0, None),  # the public key's draw
    ("PN14QP438", 7, tuple(range(7)) + (17,), (5, 6), 296, None),  # the last rotation-key chunk
    ("TEST8", 1, (4,), (7, 8), 1, 2),  # one thread's 4 columns: the smallest ring
    ("TEST8", 3, (0, 2, 5), (9, 10), 2, 3),  # two threads a row, 9 rows
    ("TEST8", 7000, tuple(range(10)), (11, 12), 3, 2),  # 70000 rows: past the grid's y limit
])
def test_uniform_mod_kernel_matches_plain(dev, preset, batch, rows, seed, idx, logn):
    params = get_params(preset)
    logn = logn or params.logn
    q = rns._sel(params.basis, rows, dev)["q"]
    mu = rns.barrett_mu64(params.basis, rows, dev)
    before = PC.UNIFORM_MOD.launches
    got = PC.uniform_mod(q, mu, seed, idx, batch, logn)
    torch.cuda.synchronize()
    assert PC.UNIFORM_MOD.launches == before + 1
    assert torch.equal(got, PC.uniform_mod_plain(q, seed, idx, batch, 1 << logn))
    assert bool((got >= 0).all()) and bool((got < q.view(1, -1, 1)).all())


def _bs_inputs(dev, preset, rows, tgt_rows, B, nwords, fill, seed):
    from sfgwas_tpu_torch.mpc import mhe as PM

    params = get_params(preset)
    ctx = PC.CkksContext(params, device=dev)
    tl, tf = PM._bs_tables(ctx, rows, nwords), PM._bs_tables(ctx, tgt_rows, nwords)
    L, Lf = len(rows), len(tgt_rows)

    def res(rws, shape, s):
        if fill == "random":
            return _residues(params.basis, rws, shape, s, dev)
        q = rns._sel(params.basis, rws, dev)["q"].view((len(rws),) + (1,) * len(shape))
        return torch.zeros((len(rws),) + shape, dtype=torch.int32, device=dev) + (
            q - 1 if fill == "top" else 0)

    sk = res(ctx.full_rows, (params.n,), seed)
    c1s = res(rows, (B, params.n), seed + 1).transpose(0, 1).contiguous()
    crp = res(tgt_rows, (B, params.n), seed + 2).transpose(0, 1).contiguous()
    e1, m1 = res(rows, (B, params.n), seed + 3), res(rows, (B, params.n), seed + 4)
    e2, m2 = res(tgt_rows, (B, params.n), seed + 5), res(tgt_rows, (B, params.n), seed + 6)
    return PM, params, tl, tf, (c1s, crp, sk, tl["rows"], tf["rows"], e1, m1, e2, m2,
                                tl["q"], tf["q"])


@pytest.mark.parametrize("preset,nrows,ntgt,B,nwords,top_bits,logn", [
    ("TEST8", 1, 1, 1, 1, 1, None),
    ("TEST8", 3, 9, 3, 3, 23, None),
    ("TEST10", 4, 11, 2, 5, 24, None),  # 5 words: the register kernel's 2-chunk hash
    ("PN14QP438", 3, 9, 8, 3, 23, None),  # the band refresh of the chip phase
    ("PN14QP438", 3, 17, 8, 3, 23, None),  # the top-level refresh of the chip phase
    ("PN14QP438", 17, 17, 1, 18, 13, None),  # the widest mask of the preset
    ("PN14QP438", 9, 11, 12, 10, 17, None),  # the QR band refresh (10 words)
    ("PN14QP438", 5, 17, 7, 6, 21, None),  # the association's refresh of 7 products
    ("TEST8", 1, 1, 1, 1, 24, None),  # one word, all 24 bits
    ("TEST8", 2, 5, 3, 2, 1, None),
    ("TEST10", 1, 14, 2, 4, 24, None),  # four words, every row
    ("TEST8", 3, 9, 1, 4, 1, 2),  # one thread's 4 columns: the smallest ring
    ("TEST8", 1, 2, 5, 3, 24, 3),  # two threads a b
    ("TEST8", 1, 1, 70000, 1, 12, 2),  # B past the grid's y limit
    ("TEST8", 2, 3, 66000, 9, 20, 2),  # the same at 9 words
    ("PN12QP109", 3, 5, 2, 3, 24, None),  # primes below 2^24: words above q in the lazy fold
    ("TEST8", 3, 9, 2, 19, 20, None),  # past the register kernel's words: the generic kernel
    ("TEST8", 2, 3, 2, 3, 24, 1),  # N = 2, below a thread's 4 columns: the generic kernel
])
def test_bs_mask_kernel_matches_plain(dev, preset, nrows, ntgt, B, nwords, top_bits, logn):
    PM, params, tl, tf, _ = _bs_inputs(dev, preset, tuple(range(nrows)), tuple(range(ntgt)),
                                       1, nwords, "random", 1)
    logn = logn or params.logn
    seed = (0x9E3779B9, 0x7F4A7C15)
    variant = PM.bs_mask_variant(tl, tf, nwords, logn)
    assert variant == ("register" if nwords <= PM.BS_REG_WORDS and logn >= 2 else "generic")
    kernel = PM.BS_MASK if variant == "register" else PM.BS_MASK_GENERIC
    before = kernel.launches
    got = PM.bs_mask(tl, tf, seed, 3, B, nwords, top_bits, logn)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = PM.bs_mask_plain(tl["pw"], tf["pw"], tl["q"], tf["q"], seed, 3, B, nwords, top_bits,
                            1 << logn)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("split", [1, 2, 4])
@pytest.mark.parametrize("preset,nrows,ntgt,B,nwords,top_bits,logn", [
    ("PN14QP438", 3, 17, 8, 3, 23, None),
    ("PN14QP438", 5, 17, 7, 6, 21, None),
    ("PN14QP438", 17, 17, 1, 18, 13, None),
    ("PN14QP438", 1, 2, 3, 7, 23, 9),  # rows fewer than the split
    ("TEST8", 3, 9, 2, 4, 1, 2),  # N = 4: most of a block's runs idle at the barrier
    ("TEST8", 2, 3, 70000, 9, 20, 2),  # B past the grid's y limit: the tile reused
])
def test_bs_mask_register_kernel_at_each_split(dev, monkeypatch, preset, nrows, ntgt, B, nwords,
                                               top_bits, logn, split):
    """The register kernel with 1, 2 or 4 warps sharing a run of
    coefficients, whichever bs_mask_split would pick."""
    PM, params, tl, tf, _ = _bs_inputs(dev, preset, tuple(range(nrows)), tuple(range(ntgt)),
                                       1, nwords, "random", 1)
    logn = logn or params.logn
    monkeypatch.setattr(PM, "bs_mask_split", lambda *a: split)
    seed = (0x0BADCAFE, split)
    before = PM.BS_MASK.launches
    got = PM.bs_mask(tl, tf, seed, 5, B, nwords, top_bits, logn)
    torch.cuda.synchronize()
    assert PM.BS_MASK.launches == before + 1
    want = PM.bs_mask_plain(tl["pw"], tf["pw"], tl["q"], tf["q"], seed, 5, B, nwords, top_bits,
                            1 << logn)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("nwords", range(5, 19))
def test_bs_mask_register_kernel_every_word_count(dev, nwords):
    """The register kernel at every word count PN14QP438's refreshes from
    five primes up draw (nmod + 1 words at nmod 5..17), on the rows of that
    refresh and every row of the chain as targets; the generic kernel on
    the same tables gives the same bits."""
    nmod = nwords - 1
    PM, params, tl, tf, _ = _bs_inputs(dev, "PN14QP438", tuple(range(nmod)),
                                       tuple(range(get_params("PN14QP438").nq)), 1, nwords,
                                       "random", 1)
    seed, top = (0x12345678, nwords), 1 + (7 * nwords) % 24
    assert PM.bs_mask_variant(tl, tf, nwords, params.logn) == "register"
    before = PM.BS_MASK.launches
    got = PM.bs_mask(tl, tf, seed, nwords, 2, nwords, top, params.logn)
    torch.cuda.synchronize()
    assert PM.BS_MASK.launches == before + 1
    want = PM.bs_mask_plain(tl["pw"], tf["pw"], tl["q"], tf["q"], seed, nwords, 2, nwords, top,
                            params.n)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    lazy = {"lazy": False}
    before = PM.BS_MASK_GENERIC.launches
    gen = PM.bs_mask({**tl, **lazy}, {**tf, **lazy}, seed, nwords, 2, nwords, top, params.logn)
    torch.cuda.synchronize()
    assert PM.BS_MASK_GENERIC.launches == before + 1
    assert torch.equal(gen[0], want[0]) and torch.equal(gen[1], want[1])


@pytest.mark.parametrize("fill", ["random", "zero", "top"])
@pytest.mark.parametrize("preset,nrows,ntgt,B", [
    ("TEST8", 1, 1, 1), ("TEST8", 3, 9, 5), ("PN14QP438", 3, 9, 8), ("PN14QP438", 3, 17, 8),
])
def test_bs_combine_kernel_matches_plain(dev, preset, nrows, ntgt, B, fill):
    PM, params, tl, tf, args = _bs_inputs(dev, preset, tuple(range(nrows)), tuple(range(ntgt)),
                                          B, 2, fill, 7)
    before = PM.BS_COMBINE.launches
    got = PM.bs_combine(*args, tl["mu"], tf["mu"], params.logn)
    torch.cuda.synchronize()
    assert PM.BS_COMBINE.launches == before + 1
    want = PM.bs_combine_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _crt_basis(preset):
    """The preset's whole chain (its Q primes and the special prime) with
    NTT tables for a tiny ring: K6 reads only the primes."""
    q, sp = prime_chain(PRESETS[preset])
    return rns.RnsBasis(q + [sp], 3)


def _bounded(basis, src, dst, M, fill, seed, dev):
    """Residues over src of centred values |v| < Q/8 (or 0, or -1 = q - 1
    in every row), and the exact residues over dst."""
    rng = np.random.default_rng(seed)
    Q = 1
    for r in src:
        Q *= basis.primes[r]
    if fill == "random":
        v = [int(x) * Q // (8 << 62) for x in rng.integers(-(1 << 62), 1 << 62, size=M)]
    else:
        v = [0 if fill == "zero" else -1] * M
    x = np.array([[vv % basis.primes[r] for vv in v] for r in src], np.uint32)
    want = np.array([[vv % basis.primes[r] for vv in v] for r in dst], np.uint32)
    return rns.as_i32(x).to(dev), rns.as_i32(want).to(dev)


@pytest.mark.parametrize("fill", ["random", "zero", "top"])
@pytest.mark.parametrize("preset,l,D,M,cap,offset", [
    ("TEST8", 3, 1, 256, None, 0),
    ("TEST8", 3, 9, 3 * 256 + 1, None, 0),  # M % 4 != 0: one column a thread
    ("TEST8", 3, 9, 3, None, 0),  # M < 4
    ("TEST8", 1, 9, 1024, None, 0),
    ("TEST8", 3, 9, 1024, None, 1),  # x 4 bytes past a 16-byte boundary: one column a thread
    ("TEST8", 3, 3, 1024, 2, 0),  # D = G + 1: groups of 2 and 1 rows
    ("TEST8", 3, 9, 1024, 8, 0),  # groups of 5 and 4
    ("TEST10", 3, 13, 1024, None, 0),  # groups of 5, 5 and 3 rows
    ("PN14QP438", 3, 9, 8 * 16384, None, 0),  # the band-targeted refresh
    ("PN14QP438", 3, 17, 8 * 16384, None, 0),  # the top-level refresh
    ("PN14QP438", 17, 17, 16384, None, 0),
    ("PN15QP880", 24, 34, 4096, None, 0),  # every source row the kernel takes, the whole chain
    ("PN15QP880", 3, 34, 8 * 32768, None, 0),
])
def test_crt_lift_kernel_matches_plain(dev, monkeypatch, preset, l, D, M, cap, offset, fill):
    """cap: the rows a block at most, in place of the wrapper's."""
    if cap:
        monkeypatch.setattr(rns, "CRT_LIFT_GROUP", cap)
    basis = _crt_basis(preset)
    src, dst = tuple(range(l)), tuple(range(D))
    x, want = _bounded(basis, src, dst, M if fill == "random" else min(M, 4096), fill, l, dev)
    if offset:  # the same values, contiguous, offset words past the allocation's start
        buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=dev)
        x = buf[offset:].view(x.shape).copy_(x)
        assert x.is_contiguous() and x.data_ptr() % 16 == 4 * offset
    before = rns.CRT_LIFT.launches
    t = rns._crt_tables(basis, src, dst, dev)
    got = rns.crt_lift(x, t)
    torch.cuda.synchronize()
    assert rns.CRT_LIFT.launches == before + 1
    assert torch.equal(got, rns.crt_lift_plain(x, t))
    assert torch.equal(got, want)


def test_kernel_limits_match_their_wrappers(dev):
    from sfgwas_tpu_torch.mpc import mhe as PM

    assert cuda_build.load("bs_share").bs_max_words() == PM.BS_MAX_WORDS
    assert cuda_build.load("bs_share").bs_reg_words() == PM.BS_REG_WORDS
    from sfgwas_tpu_torch.ops import cuda_ring

    assert cuda_build.load("ring").ring_matmul_max_k() == cuda_ring.RING_MATMUL_MAX_K
    assert cuda_build.load("crt_lift").crt_lift_max_rows() == rns.CRT_LIFT_MAX_ROWS
    assert cuda_build.load("crt_lift").crt_lift_max_group() == rns.CRT_LIFT_MAX_GROUP


def test_bs_share_kernels_match_plain_context(dev):
    """The whole share (K5, K1, K5) against a context that runs plain."""
    from sfgwas_tpu_torch.mpc import mhe as PM

    params = get_params("TEST10")
    kctx = PC.CkksContext(params, device=dev)
    pctx = PC.CkksContext(params, device=dev, kernels=False)
    rows, tgt = tuple(range(3)), tuple(range(7))
    B = 4
    rng = np.random.default_rng(3)
    sk = kctx.gen_secret_key(rng)
    c1s = _residues(params.basis, rows, (B, params.n), 4, dev).transpose(0, 1).contiguous()
    crp = PC.device_uniform_b(kctx, tgt, B, (1, 2), 0)
    assert torch.equal(crp, PC.device_uniform_b(pctx, tgt, B, (1, 2), 0))
    e1 = kctx.small_to_rns_b(np.stack([kctx.sample_gauss(rng) for _ in range(B)]), rows)
    e2 = kctx.small_to_rns_b(np.stack([kctx.sample_gauss(rng) for _ in range(B)]), tgt)
    nwords, top = PM._mask_bits(params, len(rows), 3)
    got = PM.bs_share(kctx, rows, tgt, B, nwords, top, (5, 6), 0, crp, c1s, sk.s, e1, e2)
    want = PM.bs_share(pctx, rows, tgt, B, nwords, top, (5, 6), 0, crp, c1s, sk.s, e1, e2)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_concurrent_first_use_builds_once_and_counts_every_launch(dev, monkeypatch):
    """Three threads launch K6 for the first time together: its library is
    built and bound once, and every launch is counted."""
    import threading

    name = "crt_lift"
    target = cuda_build._target(name)
    target.unlink()
    with cuda_build._lock:
        cuda_build._libs.pop(name, None)
        rns.CRT_LIFT._fn = None
    builds = []
    real_build = cuda_build.build
    monkeypatch.setattr(cuda_build, "build", lambda names: builds.append(list(names))
                        or real_build(names))
    basis = _crt_basis("TEST8")
    x, want = _bounded(basis, (0, 1, 2), tuple(range(9)), 512, "random", 5, dev)
    before = rns.CRT_LIFT.launches
    outs, errs = [], []
    start = threading.Barrier(3)

    def work():
        try:
            start.wait(timeout=60)
            for _ in range(20):
                outs.append(rns.crt_lift_centered_dev(x, basis, (0, 1, 2), tuple(range(9))))
        except BaseException as e:  # noqa: BLE001 - reported below
            errs.append(e)

    threads = [threading.Thread(target=work) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads) and not errs, errs
    torch.cuda.synchronize()
    assert builds == [[name]]
    assert rns.CRT_LIFT.launches == before + 60
    assert all(torch.equal(o, want) for o in outs)


def test_ss_he_round_trip_on_card_matches_cpu(dev):
    """The TEST8 SS<->HE round trip of three parties (ss_to_cmat, a drop
    below the masked decode's floor, cmat_to_ss through the guard's
    collective bootstrap, the reveal) on the card gives the ciphertexts and
    shares of the port's CPU run under the same keys, PRG keys and
    generators, and launches K1, K4, K5 and K6 on the way."""
    from sfgwas_tpu_torch import interop
    from sfgwas_tpu_torch.mpc import mhe as PM
    from sfgwas_tpu_torch.mpc import ss_he as SH
    from sfgwas_tpu_torch.ops import ring as R
    from sfgwas_tpu_torch.parallel.simulate import make_shares, reveal_ints, run_parties

    keys = run_parties(3, lambda mpc: interop.bundle_arrays(
        PM.collective_init(mpc.net, "TEST8", shifts_override=[1], device="cpu")))
    vals = np.random.default_rng(4).normal(scale=50.0, size=(2, 150))
    enc = [int(v) % R.P256 for v in np.round(vals * (1 << 30)).astype(np.int64).reshape(-1)]

    def run(device):
        def fn(mpc):
            mpc.rand.table[mpc.pid] = np.random.Generator(np.random.Philox(key=[9, mpc.pid]))
            ctx = PC.CkksContext(get_params("TEST8"), device=device)
            cps = interop.crypto_params(ctx, enc_rng=np.random.default_rng(100 + mpc.pid),
                                        **keys[mpc.pid])
            cm = SH.ss_to_cmat(mpc, cps, make_shares(mpc, enc).reshape(2, 150, -1))
            cts = None
            if mpc.pid > 0:
                cts = [(rns.to_u32(ct.c0), rns.to_u32(ct.c1)) for row in cm for ct in row]
                cm = [[ctx.drop_to(ct, 4) for ct in row] for row in cm]
            back = SH.cmat_to_ss(mpc, cps, cm, -1, 150)
            return cts, back, reveal_ints(mpc, back.reshape(300, -1))

        return run_parties(3, fn)

    cpu = run("cpu")
    cuda_build.reset_launch_counts()
    card = run(dev)
    torch.cuda.synchronize()
    launched = {k: v.launches for k, v in cuda_build.REGISTRY.items()}
    for k in ("ntt_fwd", "ntt_inv", "uniform_mod", "bs_mask", "bs_combine", "crt_lift"):
        assert launched[k] > 0, k
    for pid in range(3):
        np.testing.assert_array_equal(card[pid][1], cpu[pid][1])
    for pid in (1, 2):
        for (a0, a1), (b0, b1) in zip(card[pid][0], cpu[pid][0]):
            np.testing.assert_array_equal(a0, b0)
            np.testing.assert_array_equal(a1, b1)
        got = np.array([(int(v) - R.P256 if int(v) > R.P256 // 2 else int(v)) / (1 << 30)
                        for v in card[pid][2]])
        assert np.abs(got - vals.reshape(-1)).max() < 1e-3


@pytest.mark.parametrize("J,X", [(9, 10), (7, 8)])
def test_ks_digit_kernel_at_the_qr_shapes(dev, J, X):
    """K3 at the covariate basis' shapes at PN14QP438: the relinearisation
    of the 21 Gram pairs under the shared key (G 1, S 21, Bk 1, J 9, X 10)
    and the rotation ladder of 21 ciphertexts (J 7, X 8)."""
    basis = get_params("PN14QP438").basis
    ext, k0, k1, q, mu = _ks_case(dev, basis, 1, 21, 1, J, 3 + J, X=X)
    o = PC.ks_digit_product(ext, k0, k1, q, mu, basis.logn)
    p = PC.ks_digit_product_plain(ext, k0, k1, q)
    torch.cuda.synchronize()
    assert torch.equal(o[0], p[0]) and torch.equal(o[1], p[1])


@pytest.mark.parametrize("preset,slots,nrows", [("TEST8", 128, [0, 300, 200]),
                                                ("TEST10", 512, [0, 600, 200])])
def test_cholqr_on_card_matches_cpu(dev, preset, slots, nrows):
    """The combined covariate basis (compute_combined_q over net_cholqr_enc,
    2 covariates) of three parties on the card gives the ciphertexts of the
    port's CPU run under the same keys, PRG keys and generators, and
    launches K1, K3, K4, K5 and K6: at TEST8 the QR's drift-compensation
    branch, at TEST10 its scale-reset branch (the one PN14QP438 runs)."""
    from sfgwas_tpu_torch import interop
    from sfgwas_tpu_torch.gwas.assoc import compute_combined_q
    from sfgwas_tpu_torch.mpc import mhe as PM
    from sfgwas_tpu_torch.parallel.simulate import run_parties

    pw = [1 << k for k in range(slots.bit_length() - 1)]
    shifts = pw + [slots - k for k in pw]
    keys = run_parties(3, lambda mpc: interop.bundle_arrays(
        PM.collective_init(mpc.net, preset, shifts_override=shifts, device="cpu")))
    n1 = nrows[1]
    cov = np.random.default_rng(21).normal(size=(sum(nrows), 2)) * np.array([50.0, 0.3])

    def run(device):
        def fn(mpc):
            mpc.rand.table[mpc.pid] = np.random.Generator(np.random.Philox(key=[9, mpc.pid]))
            ctx = PC.CkksContext(get_params(preset), device=device)
            cps = interop.crypto_params(ctx, enc_rng=np.random.default_rng(100 + mpc.pid),
                                        **keys[mpc.pid])
            c = 2 if mpc.pid == 0 else cov[:n1] if mpc.pid == 1 else cov[n1:]
            Q, _ = compute_combined_q(mpc, cps, c, None, nrows, False)
            return None if mpc.pid == 0 else interop.cipher_matrix_arrays(
                [[PC.Ciphertext(ct.c0.cpu(), ct.c1.cpu(), ct.nmod, ct.scale) for ct in col]
                 for col in Q])

        return run_parties(3, fn)

    cpu = run("cpu")
    cuda_build.reset_launch_counts()
    card = run(dev)
    torch.cuda.synchronize()
    launched = {k: v.launches for k, v in cuda_build.REGISTRY.items()}
    for k in ("ntt_fwd", "ntt_inv", "ks_digit_product", "uniform_mod", "bs_mask", "bs_combine",
              "crt_lift"):
        assert launched[k] > 0, k
    for pid in (1, 2):
        assert [len(c) for c in card[pid]] == [len(c) for c in cpu[pid]]
        for ccol, pcol in zip(card[pid], cpu[pid]):
            for (a0, a1, an, as_), (b0, b1, bn, bs) in zip(ccol, pcol):
                assert (an, as_) == (bn, bs)
                np.testing.assert_array_equal(a0, b0)
                np.testing.assert_array_equal(a1, b1)


def test_assoc_on_card_matches_cpu(dev):
    """The linear association statistics (get_association_stats) of three
    parties on tests/test_e2e_gwas.py's shape at TEST8 (24 and 20
    individuals, 50 SNPs in 2 blocks with missing calls read as 0, 2
    covariates) on the card give the ciphertexts of the port's CPU run under
    the same keys, PRG keys and generators, and launch all six kernels."""
    from sfgwas_tpu_torch import interop
    from sfgwas_tpu_torch.gwas.assoc import get_association_stats
    from sfgwas_tpu_torch.mpc import mhe as PM
    from sfgwas_tpu_torch.parallel.simulate import run_parties

    nrows, m = [0, 24, 20], 50
    keys = run_parties(3, lambda mpc: interop.bundle_arrays(
        PM.collective_init(mpc.net, "TEST8", device="cpu")))
    rng = np.random.default_rng(99)
    g = rng.integers(-1, 3, size=(sum(nrows), m)).astype(np.int8)
    pheno = rng.normal(size=sum(nrows)) + 0.3 * np.maximum(g[:, 0], 0)
    cov = rng.normal(size=(sum(nrows), 2))
    rows = {1: slice(0, nrows[1]), 2: slice(nrows[1], sum(nrows))}

    def run(device):
        def fn(mpc):
            pid = mpc.pid
            mpc.rand.table[pid] = np.random.Generator(np.random.Philox(key=[9, pid]))
            ctx = PC.CkksContext(get_params("TEST8"), device=device)
            cps = interop.crypto_params(ctx, enc_rng=np.random.default_rng(100 + pid),
                                        **keys[pid])
            if pid == 0:
                get_association_stats(mpc, cps, None, None, 2, None, nrows)
                return None
            gl = np.maximum(g[rows[pid]], 0)
            stats, filt = get_association_stats(
                mpc, cps, [gl[:, :25], gl[:, 25:]], pheno[rows[pid]], cov[rows[pid]], None,
                nrows)
            return filt, interop.cipher_matrix_arrays(
                [[PC.Ciphertext(ct.c0.cpu(), ct.c1.cpu(), ct.nmod, ct.scale) for ct in stats]])

        return run_parties(3, fn)

    cpu = run("cpu")
    cuda_build.reset_launch_counts()
    card = run(dev)
    torch.cuda.synchronize()
    launched = {k: v.launches for k, v in cuda_build.REGISTRY.items()}
    for k in ("ntt_fwd", "ntt_inv", "mac_dense", "ks_digit_product", "uniform_mod", "bs_mask",
              "bs_combine", "crt_lift"):
        assert launched[k] > 0, k
    for pid in (1, 2):
        np.testing.assert_array_equal(card[pid][0], cpu[pid][0])
        assert len(card[pid][1][0]) == len(cpu[pid][1][0]) == 2
        for (a0, a1, an, as_), (b0, b1, bn, bs) in zip(card[pid][1][0], cpu[pid][1][0]):
            assert (an, as_) == (bn, bs)
            np.testing.assert_array_equal(a0, b0)
            np.testing.assert_array_equal(a1, b1)


def test_cli_on_card_matches_cpu(dev, tmp_path):
    """The CLI's local-sim study (three parties, TEST8, linear skip-PCA, QC
    from precomputed counts) with no --platform runs on the card: the same
    SNP filter as the port's CPU run and statistics within 2e-3 of it (the
    keys differ between the runs, so the decryption noise does)."""
    import json

    from sfgwas_tpu_torch import cli

    nrows, m = [0, 24, 20], 50
    rng = np.random.default_rng(99)
    for pid in (1, 2):
        d = tmp_path / f"party{pid}"
        d.mkdir()
        g = rng.binomial(2, rng.uniform(0.2, 0.5, size=m), size=(nrows[pid], m)).astype(np.int8)
        g[rng.uniform(size=g.shape) < 0.02] = -1
        g[:, :25].tofile(d / "geno.0.bin")
        g[:, 25:].tofile(d / "geno.1.bin")
        (d / "blocksizes.txt").write_text("25\n25\n")
        np.savetxt(d / "pheno.txt", rng.normal(size=nrows[pid]) + 0.3 * np.maximum(g[:, 0], 0))
        np.savetxt(d / "cov.txt", rng.normal(size=(nrows[pid], 2)))
        raw = np.zeros((6, m), "<u4")
        for k in range(3):
            raw[k] = (g == k).sum(0)
        raw[5] = (g < 0).sum(0)
        raw.tofile(d / "gcount.bin")
    p = str(tmp_path / "party{pid}")
    fields = dict(num_inds=nrows, num_snps=m, num_covs=2, ckks_params="TEST8", gmiss=0.2,
                  maf_lb=0.05, hwe_ub=1000.0, skip_pca=True, use_precomputed_geno_count=True,
                  geno_binary_file_prefix=p + "/geno", geno_block_size_file=p + "/blocksizes.txt",
                  pheno_file=p + "/pheno.txt", covar_file=p + "/cov.txt",
                  geno_count_file=p + "/gcount.bin")
    out = {}
    for name, extra in (("cpu", ["--platform", "cpu"]), ("card", [])):
        cfg = tmp_path / f"{name}.toml"
        cfg.write_text("".join(f"{k} = {json.dumps(v)}\n" for k, v in dict(
            fields, cache_dir=str(tmp_path / name / "cache"),
            output_dir=str(tmp_path / name / "out")).items()))
        cuda_build.reset_launch_counts()
        assert cli.main(["--local-sim", "3", "--config-global", str(cfg)] + extra) == 0
        launched = sum(v.launches for v in cuda_build.REGISTRY.values())
        assert (launched > 0) == (name == "card")
        out[name] = [(np.loadtxt(tmp_path / name / "out" / f"party{q}" / "assoc.txt"),
                      np.loadtxt(tmp_path / name / "cache" / f"party{q}" / "gkeep.txt"))
                     for q in (1, 2)]
    for (cs, ck), (gs, gk) in zip(out["cpu"], out["card"]):
        np.testing.assert_array_equal(gk, ck)
        assert gs.shape == cs.shape and np.abs(gs - cs).max() < 2e-3


# ---- K8-K11: the SS ring's device path (ops/cuda_ring.py, csrc/ring.cu)

RING_NAMES = ["LElem256", "LElem128", "LElem2N256", "LElem2N127"]


def _ring(name):
    from sfgwas_tpu_torch.ops import ring as PR

    return getattr(PR, name)


def _ring_elems(ring, shape, seed, dev):
    """Canonical elements of `shape`, the first two 0 and modulus - 1."""
    a = np.array(ring.rand(np.random.default_rng(seed), shape)).reshape(-1, ring.nlimb)
    a[0] = ring.from_ints([0])[0]
    if len(a) > 1:
        a[1] = ring.from_ints([ring.modulus - 1])[0]
    return torch.as_tensor(a.reshape(tuple(shape) + (ring.nlimb,))).to(dev)


@pytest.mark.parametrize("lim", [2**8, 2**31 - 1])
@pytest.mark.parametrize("n,nd", [(1, 1), (129, 3), (1000, "L"), (127, "2L-1"), (5, "2L-1")])
@pytest.mark.parametrize("name", RING_NAMES)
def test_ring_reduce_kernel_matches_plain(dev, name, n, nd, lim):
    """K8 on signed digits in (-lim, lim), at 1..2L-1 digits and element
    counts off the 128-thread block."""
    from sfgwas_tpu_torch.ops import cuda_ring

    ring = _ring(name)
    nd = {"L": ring.nlimb, "2L-1": 2 * ring.nlimb - 1}.get(nd, nd)
    x = np.random.default_rng(n + nd).integers(-lim, lim, size=(n, nd))
    x[0] = lim - 1
    x = torch.as_tensor(x.astype(np.int32)).to(dev)
    before = cuda_ring.RING_REDUCE.launches
    got = cuda_ring.reduce(ring, x)
    torch.cuda.synchronize()
    assert cuda_ring.RING_REDUCE.launches == before + 1
    assert torch.equal(got.cpu(), cuda_ring.reduce_plain(ring, x.cpu()))


@pytest.mark.parametrize("shape_a,shape_b", [((1,), (1,)), ((129,), (129,)), ((3, 11), (11,)),
                                             ((1000,), (1,))])
@pytest.mark.parametrize("name", RING_NAMES)
def test_ring_mul_kernel_matches_plain(dev, name, shape_a, shape_b):
    from sfgwas_tpu_torch.ops import cuda_ring

    ring = _ring(name)
    a, b = _ring_elems(ring, shape_a, 1, dev), _ring_elems(ring, shape_b, 2, dev)
    got = cuda_ring.mul(ring, a, b)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), cuda_ring.mul_plain(ring, a.cpu(), b.cpu()))
    # the top value squared: (modulus - 1)^2
    top = _ring_elems(ring, (2,), 8, dev)[1:]
    assert torch.equal(cuda_ring.mul(ring, top, top).cpu(),
                       cuda_ring.mul_plain(ring, top.cpu(), top.cpu()))


@pytest.mark.parametrize("r,k,c", [
    (1, 1, 1), (6, 6, 6), (3, 900, 2), (2, 33, 130),
    (6, 1, 6),  # k = 1: one term slot of the warp busy
    (5, 3, 7),  # 35 outputs: not a multiple of a block's 4 warps
    (7, 7, 7),  # 49 outputs, past phase 16's largest product (6 x 6 x 6)
    (1, 65, 3),  # k past two rounds of every lane's term slots
])
@pytest.mark.parametrize("name", RING_NAMES)
def test_ring_matmul_kernel_matches_plain(dev, name, r, k, c):
    """K10 at k past the reference's 896-term chunk, and at every product
    (modulus - 1)^2 summed k times."""
    from sfgwas_tpu_torch.ops import cuda_ring

    ring = _ring(name)
    A, B = _ring_elems(ring, (r, k), 3, dev), _ring_elems(ring, (k, c), 4, dev)
    before = cuda_ring.RING_MATMUL.launches
    got = cuda_ring.matmul(ring, A, B)
    torch.cuda.synchronize()
    assert cuda_ring.RING_MATMUL.launches == before + 1
    assert torch.equal(got.cpu(), cuda_ring.matmul_plain(ring, A.cpu(), B.cpu()))
    top = _ring_elems(ring, (1, 2), 5, dev)[:, 1:].expand(r, k, ring.nlimb).contiguous()
    topb = top[:1].reshape(k, 1, ring.nlimb).expand(k, c, ring.nlimb).contiguous()
    assert torch.equal(cuda_ring.matmul(ring, top, topb).cpu(),
                       cuda_ring.matmul_plain(ring, top.cpu(), topb.cpu()))


def test_ring_matmul_refuses_k_past_its_column_sums(dev):
    from sfgwas_tpu_torch.ops import cuda_ring
    from sfgwas_tpu_torch.ops import ring as PR

    k = cuda_ring.RING_MATMUL_MAX_K + 1
    row = torch.zeros((1, 1, 32), dtype=torch.int32, device=dev)  # expanded: no memory
    with pytest.raises(ValueError, match="at most"):
        cuda_ring.matmul(PR.LElem256, row.expand(1, k, 32), row.expand(k, 1, 32))


@pytest.mark.parametrize("n,k", [(1, 1), (129, 37), (7, 1000)])
@pytest.mark.parametrize("name", RING_NAMES)
def test_ring_dot_kernel_matches_plain(dev, name, n, k):
    """K11 at the normaliser's 37 terms a value and beyond."""
    from sfgwas_tpu_torch.ops import cuda_ring

    ring = _ring(name)
    a, cf = _ring_elems(ring, (n, k), 6, dev), _ring_elems(ring, (k,), 7, dev)
    before = cuda_ring.RING_DOT.launches
    got = cuda_ring.dot(ring, a, cf)
    torch.cuda.synchronize()
    assert cuda_ring.RING_DOT.launches == before + 1
    assert torch.equal(got.cpu(), cuda_ring.dot_plain(ring, a.cpu(), cf.cpu()))


def test_ring_kernels_raise_on_what_they_cannot_take(dev):
    from sfgwas_tpu_torch.ops import cuda_ring

    ring = _ring("LElem256")
    with pytest.raises(ValueError):
        cuda_ring.reduce(ring, torch.zeros((2, 2 * ring.nlimb), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        cuda_ring.mul(ring, torch.zeros((2, 32), dtype=torch.int64, device=dev),
                      torch.zeros((2, 32), dtype=torch.int64, device=dev))


# ---- K8 and K9 staged, K8's fused entries (combine, sum_axis, from_i32)

RAGGED_N = [1, 127, 128, 129, 198_674]  # off and on the 128-row block; the sqrt's 2n


def _unaligned(t):
    """t's values in a contiguous view that starts 4 bytes past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    view = flat[1 : t.numel() + 1].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 4
    return view


@pytest.mark.parametrize("n", RAGGED_N)
@pytest.mark.parametrize("nd", [1, 4, 7, "L", "2L-1"])
@pytest.mark.parametrize("name", RING_NAMES)
def test_staged_ring_reduce_matches_plain(dev, name, n, nd):
    """K8 on signed digits of any int32 value at 1, 4, an odd, L and 2L-1
    digits, on an aligned and an unaligned view (the 16-byte and the 4-byte
    copies into the tile)."""
    from sfgwas_tpu_torch.ops import cuda_ring

    ring = _ring(name)
    nd = {"L": ring.nlimb, "2L-1": 2 * ring.nlimb - 1}.get(nd, nd)
    x = np.random.default_rng(n * 7 + nd).integers(-(2**31), 2**31 - 1, size=(n, nd))
    x[0] = 2**31 - 1
    x = torch.as_tensor(x.astype(np.int32)).to(dev)
    want = cuda_ring.reduce_plain(ring, x.cpu())
    for view in (x, _unaligned(x)):
        before = cuda_ring.RING_REDUCE.launches
        got = cuda_ring.reduce(ring, view)
        torch.cuda.synchronize()
        assert cuda_ring.RING_REDUCE.launches == before + 1
        assert torch.equal(got.cpu(), want)


COMBINE_SCALES = [(1, 1), (1, -1), (-1, 0), (-511, 0), (-3, 0), (2, 0), (511, 0), (-511, 511)]


@pytest.mark.parametrize("n", RAGGED_N)
@pytest.mark.parametrize("name", RING_NAMES)
def test_ring_combine_matches_plain(dev, name, n):
    """K8's combine entry at add, sub, neg and mul_int's constants, on
    aligned and unaligned operands, each call one launch."""
    from sfgwas_tpu_torch.ops import cuda_ring

    ring = _ring(name)
    a, b = _ring_elems(ring, (n,), 11, dev), _ring_elems(ring, (n,), 12, dev)
    b[-1] = 255
    for sa, sb in COMBINE_SCALES:
        y = None if sb == 0 else b
        want = cuda_ring.combine_plain(ring, a.cpu(), None if y is None else y.cpu(), sa, sb)
        for x in (a, _unaligned(a)):
            before = cuda_ring.RING_COMBINE.launches
            got = cuda_ring.combine(ring, x, None if y is None else _unaligned(y), sa, sb)
            torch.cuda.synchronize()
            assert cuda_ring.RING_COMBINE.launches == before + 1
            assert torch.equal(got.cpu(), want), (sa, sb)


# broadcast forms read in place: one row against [n, L] (mul_const, a
# constant), [c, 1, L] against [c, n, L] (the 3 x 3 inverse's column
# products), [n, L] against [c, n, L]
BROADCASTS = [((1,), ("n",)), ((), ("n",)), ((3, 1), (3, "n")), (("n",), (3, "n"))]


def _bshape(shape, n):
    return tuple(n if d == "n" else d for d in shape)


@pytest.mark.parametrize("n", RAGGED_N)
@pytest.mark.parametrize("form", range(len(BROADCASTS)))
@pytest.mark.parametrize("name", RING_NAMES)
def test_broadcast_operands_read_in_place(dev, name, form, n):
    """K9 and K8's combine with a broadcast operand on either side, and with
    a transposed one, equal the plain versions on the materialised operands,
    with no copy."""
    from sfgwas_tpu_torch.ops import cuda_ring

    ring = _ring(name)
    sa, sb = BROADCASTS[form]
    a, b = _ring_elems(ring, _bshape(sa, n), 13, dev), _ring_elems(ring, _bshape(sb, n), 14, dev)
    copies = cuda_ring.OPERAND_COPIES
    pairs = [(a, b), (b, a)]
    if b.dim() == 3:  # [3, n, L] against its transpose's transpose
        bt = b.transpose(0, 1).contiguous().transpose(0, 1)
        pairs.append((bt, b))
    for x, y in pairs:
        X, Y = (t.expand(torch.broadcast_shapes(x.shape, y.shape)).contiguous().cpu()
                for t in (x, y))
        before = cuda_ring.RING_MUL.launches
        got = cuda_ring.mul(ring, x, y)
        torch.cuda.synchronize()
        assert cuda_ring.RING_MUL.launches == before + 1
        assert torch.equal(got.cpu(), cuda_ring.mul_plain(ring, X, Y))
        got = cuda_ring.combine(ring, x, y, 1, -1)
        assert torch.equal(got.cpu(), cuda_ring.combine_plain(ring, X, Y, 1, -1))
    assert cuda_ring.OPERAND_COPIES == copies


def test_operands_past_four_axes_are_copied_and_counted(dev):
    """Broadcast axes between an operand's own are read in place up to four
    axes; past four the operand is copied out first and counted."""
    from sfgwas_tpu_torch.ops import cuda_ring

    ring = _ring("LElem256")
    for sa, sb, copied in (((4, 1, 3), (1, 6, 1), 0),
                           ((2, 1, 2, 1, 2, 1, 2), (1, 2, 1, 2, 1, 2, 1), 2)):
        a, b = _ring_elems(ring, sa, 15, dev), _ring_elems(ring, sb, 16, dev)
        copies = cuda_ring.OPERAND_COPIES
        got = cuda_ring.mul(ring, a, b)
        assert cuda_ring.OPERAND_COPIES == copies + copied
        assert torch.equal(got.cpu(), cuda_ring.mul_plain(ring, a.cpu(), b.cpu()))


@pytest.mark.parametrize("n", RAGGED_N)
@pytest.mark.parametrize("k,axis", [(2, 0), (37, 1), (3, 1)])
@pytest.mark.parametrize("name", RING_NAMES)
def test_ring_sum_matches_plain(dev, name, n, k, axis):
    """K8's sum entry over the leading and a middle axis, all digits 255 and
    random, one launch."""
    from sfgwas_tpu_torch.ops import cuda_ring

    ring = _ring(name)
    shape = (k, n) if axis == 0 else (2, k, n) if k == 3 else (n, k)
    for a in (_ring_elems(ring, shape, 17, dev),
              torch.full(shape + (ring.nlimb,), 255, dtype=torch.int32, device=dev)):
        before = cuda_ring.RING_SUM.launches
        got = cuda_ring.sum_axis(ring, a, axis)
        torch.cuda.synchronize()
        assert cuda_ring.RING_SUM.launches == before + 1
        assert torch.equal(got.cpu(), cuda_ring.sum_plain(ring, a.cpu(), axis))


@pytest.mark.parametrize("n", RAGGED_N)
@pytest.mark.parametrize("name", RING_NAMES)
def test_ring_from_i32_matches_plain(dev, name, n):
    from sfgwas_tpu_torch.ops import cuda_ring

    ring = _ring(name)
    v = np.random.default_rng(n).integers(-(2**31), 2**31 - 1, size=n).astype(np.int32)
    v[0] = -1
    v = torch.as_tensor(v).to(dev)
    before = cuda_ring.RING_FROM_I32.launches
    got = cuda_ring.from_i32(ring, v)
    torch.cuda.synchronize()
    assert cuda_ring.RING_FROM_I32.launches == before + 1
    assert torch.equal(got.cpu(), cuda_ring.from_i32_plain(ring, v.cpu()))


@pytest.mark.parametrize("n", RAGGED_N)
@pytest.mark.parametrize("name", RING_NAMES)
def test_staged_ring_mul_matches_plain(dev, name, n):
    """K9 on aligned and unaligned operands."""
    from sfgwas_tpu_torch.ops import cuda_ring

    ring = _ring(name)
    a, b = _ring_elems(ring, (n,), 18, dev), _ring_elems(ring, (n,), 19, dev)
    want = cuda_ring.mul_plain(ring, a.cpu(), b.cpu())
    for x, y in ((a, b), (_unaligned(a), b), (a, _unaligned(b))):
        assert torch.equal(cuda_ring.mul(ring, x, y).cpu(), want)


def _device_kernels(fn, reps=3):
    """The device kernels fn() launches, reps calls under torch.profiler
    (after one call outside it)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


# ring op (its operands on the card) -> its kernel's device function
FUSED_OPS = {
    "add": (lambda r, a, b, i: r.add(a, b), "ring_combine_kernel"),
    "add_row": (lambda r, a, b, i: r.add(a, b[:1]), "ring_combine_kernel"),
    "sub": (lambda r, a, b, i: r.sub(a, b), "ring_combine_kernel"),
    "neg": (lambda r, a, b, i: r.neg(a), "ring_combine_kernel"),
    "mul_int": (lambda r, a, b, i: r.mul_int(a, -37), "ring_combine_kernel"),
    "sum": (lambda r, a, b, i: r.sum(a.reshape(3, -1, a.shape[-1]), axis=0), "ring_sum_kernel"),
    "from_i32": (lambda r, a, b, i: r.from_i32(i), "ring_from_i32_kernel"),
    "mul_row": (lambda r, a, b, i: r.mul(a, b[:1]), "ring_mul_kernel"),
    "mul_const": (lambda r, a, b, i: r.mul_const(a, b[0]), "ring_mul_kernel"),
    "mul_column": (lambda r, a, b, i: r.mul(a.reshape(3, -1, a.shape[-1]),
                                            b[:3].reshape(3, 1, -1)), "ring_mul_kernel"),
    "add_transposed": (lambda r, a, b, i: r.add(a[:9].reshape(3, 3, -1),
                                                 b[:9].reshape(3, 3, -1).transpose(0, 1)),
                       "ring_combine_kernel"),
}


@pytest.mark.parametrize("op", sorted(FUSED_OPS))
def test_ring_op_in_device_mode_is_one_launch(dev, monkeypatch, op):
    """In device mode each of these ring ops on operands on the card runs one
    launch of its kernel and no other device work (no copy of a broadcast or
    transposed operand)."""
    from sfgwas_tpu_torch.ops import cuda_ring
    from sfgwas_tpu_torch.ops import ring as PR

    ring = _ring("LElem256")
    monkeypatch.setattr(ring, "host", False)
    a, b = _ring_elems(ring, (3 * 70,), 20, dev), _ring_elems(ring, (3 * 70,), 21, dev)
    i32 = torch.arange(-100, 110, dtype=torch.int32, device=dev)
    fn, kernel = FUSED_OPS[op]
    copies = cuda_ring.OPERAND_COPIES
    names = _device_kernels(lambda: fn(ring, a, b, i32))
    assert len(names) == 3 and all(kernel in nm for nm in names), names
    assert cuda_ring.OPERAND_COPIES == copies
    got = PR.to_host(fn(ring, a, b, i32))
    cpu = fn(ring, a.cpu(), b.cpu(), i32.cpu())
    np.testing.assert_array_equal(got, cpu.numpy())


def test_ss_device_mode_on_card_matches_host_mode(dev, monkeypatch):
    """sqrt_and_sqrt_inverse and a 3 x 3 matrix_inverse_sqrt_svd with the
    shares on the card (ring.host False) equal host mode bit for bit."""
    from sfgwas_tpu_torch.mpc import linalg as PL
    from sfgwas_tpu_torch.ops import ring as PR
    from sfgwas_tpu_torch.parallel import simulate as PS

    A = np.array([[2.0, 0.3, -0.1], [0.1, 1.5, 0.2], [0.0, 0.4, 3.0]])
    x = [0.01, 0.5, 3.9, 250.0]
    vals = [int(round(v * (1 << 30))) for v in list(A.reshape(-1)) + x]

    def run(to_dev):
        def party(mpc):
            mpc.rand.table[mpc.pid] = np.random.Generator(np.random.Philox(key=[5, mpc.pid]))
            sh = PS.make_shares(mpc, vals)
            sh = torch.as_tensor(sh).to(dev) if to_dev else sh
            s = mpc.sqrt_and_sqrt_inverse(sh[9:])
            B = PL.matrix_inverse_sqrt_svd(mpc, sh[:9].reshape((3, 3, -1)))
            if to_dev and mpc.pid:  # the data parties' outputs stay on the card
                assert all(isinstance(v, torch.Tensor) and v.is_cuda for v in (*s, B))
            return [PR.to_host(v) for v in (*s, B)]

        return PS.run_parties(3, party)

    host = run(False)
    monkeypatch.setattr(PR.LElem256, "host", False)
    on_card = run(True)
    for pid in range(3):
        for g, w in zip(on_card[pid], host[pid]):
            assert np.array_equal(g, w), pid
