"""Port parity: PCA's host-streamed diagonal caches and lazily normalised
products in sfgwas_tpu_torch (gwas/matmult.py: host_block_diagonals and its
spill files, preprocess_matrix(cache_file=..., host_resident=...), the .npz
diagonal cache, the plan's streaming mode, qx_lazy_norm_stream,
qxt_lazy_norm_stream) against sfgwas_tpu's at TEST8 on the CPU.

- A host-streamed cache, multiplied in MAC launches of a few diagonals
  each, and a device-resident one whose giant step keyswitches a few
  segments at a time, give the reference's product bit for bit (keys,
  ciphertexts and product made as tests/test_torch_matmult.py makes them: 2
  x 2 blocks at 128 slots, 2 encrypted rows).
- The spill files (.hi.npy, .lo.npy, .meta.npz) and the .npz diagonal cache
  of the two packages are equal byte for byte (the .npz archives member by
  member: a zip entry's header carries its write time), and each package
  multiplies with the other's to the same product.
- Both lazily normalised products, three parties of each package under the
  reference's collective keys (tests/test_torch_assoc.py's harness), are
  bit-equal to the reference's and decrypt within 2e-2 of numpy."""

import math
import zipfile

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
from test_torch_assoc import NROWS, ref_keys, run, assert_same_cts, flat  # noqa: F401

PRESET = "TEST8"
SLOTS = 128


@pytest.fixture(scope="module")
def setup():
    """A 200 x 150 int8 matrix (2 x 2 blocks), 2 encrypted rows, local keys
    with the rotations its plan needs, the reference's device-resident
    cache and product, and the same keys and ciphertexts in the port."""
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
    rcps.rot_keys.update(rctx.gen_rot_keys_batched(sk, gels, rng, key_nmod=rctx.params.mm_nmod))
    A = [[rctx.drop_to(RB.encrypt_float_vector(rcps, Q[i, b0 : b0 + SLOTS])[0], nmod)
          for b0 in range(0, n, SLOTS)] for i in range(s)]
    rout = RMM.mat_mult_cached(rcps, A, rcache)

    pctx = PC.CkksContext(port_get_params(PRESET), device="cpu")
    pcps = interop.crypto_params(
        pctx, np.asarray(sk.s), (np.asarray(pk.p0), np.asarray(pk.p1)),
        {g: (np.asarray(k.d0), np.asarray(k.d1)) for g, k in rcps.rot_keys.items()},
    )
    pA = [[interop.ciphertext(pctx, np.asarray(ct.c0), np.asarray(ct.c1), ct.nmod, ct.scale)
           for ct in row] for row in A]
    return dict(X=X, nmod=nmod, rcps=rcps, A=A, rcache=rcache, want=_ref_out(rout),
                pcps=pcps, pA=pA)


def _port_out(out):
    return [(port_rns.to_u32(ct.c0), port_rns.to_u32(ct.c1), ct.nmod, ct.scale)
            for row in out for ct in row]


def _ref_out(out):
    return [(np.asarray(ct.c0), np.asarray(ct.c1), ct.nmod, ct.scale)
            for row in out for ct in row]


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {name: z.read(name) for name in z.namelist()}


def test_host_streamed_product_matches_reference(setup, tmp_path):
    """Host chunks (spilled and memory-mapped back), 5 diagonals a launch:
    the reference's device-resident product, bit for bit; the unspilled
    chunks at the default budget (one launch a block row) too."""
    pcps, nmod, pA = setup["pcps"], setup["nmod"], setup["pA"]
    cache = PMM.preprocess_matrix(pcps, setup["X"], nmod, cache_file=str(tmp_path / "x.npz"),
                                  host_resident=True)
    assert all(b.polys is None and b.chunks is not None for row in cache for b in row)
    group = 5 * nmod * pcps.ctx.n * 4
    out = PMM.mat_mult_cached(pcps, pA, cache, group_bytes=group)
    plan = PMM._plan_for(pcps, cache, nmod, row_batch=len(pA), group_bytes=group)
    assert plan.stream and min(len(g) for g in plan.groups()) > 4
    assert_same_cts(setup["want"], _port_out(out))
    cache2 = PMM.preprocess_matrix(pcps, setup["X"], nmod, host_resident=True)
    out2 = PMM.mat_mult_cached(pcps, pA, cache2)
    assert [len(g) for g in PMM._plan_for(pcps, cache2, nmod, len(pA)).groups()] == [1, 1]
    assert_same_cts(setup["want"], _port_out(out2))


def test_giant_step_in_batches_matches_reference(setup, monkeypatch):
    """The giant step keyswitched a few segments at a time (a byte budget
    of 3 segments' ciphertexts) gives the same product."""
    pcps, nmod, pA = setup["pcps"], setup["nmod"], setup["pA"]
    cache = PMM.preprocess_matrix(pcps, setup["X"], nmod)
    seg_bytes = len(pA) * nmod * pcps.ctx.n * 4
    nrot = len(PMM._plan_for(pcps, cache, nmod, len(pA)).giant_index(pcps.ctx)["gels"])
    assert nrot > 6
    monkeypatch.setattr(PMM, "GIANT_BATCH_BYTES", 3 * seg_bytes)
    assert_same_cts(setup["want"], _port_out(PMM.mat_mult_cached(pcps, pA, cache)))


def test_spill_files_equal_and_cross_load(setup, tmp_path):
    X, nmod, rcps, pcps = setup["X"], setup["nmod"], setup["rcps"], setup["pcps"]
    rprefix, pprefix = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    RMM.preprocess_matrix(rcps, X, nmod, cache_file=rprefix, host_resident=True)
    PMM.preprocess_matrix(pcps, X, nmod, cache_file=pprefix, host_resident=True)
    for bi in (0, 128):
        for bj in (0, 128):
            for ext in (".hi.npy", ".lo.npy"):
                with open(f"{rprefix}.w{bi}_{bj}{ext}", "rb") as f:
                    want = f.read()
                with open(f"{pprefix}.w{bi}_{bj}{ext}", "rb") as f:
                    assert f.read() == want, (bi, bj, ext)
            assert (_members(f"{pprefix}.w{bi}_{bj}.meta.npz")
                    == _members(f"{rprefix}.w{bi}_{bj}.meta.npz"))
    # each package streams the other's spill files (existing spills load as
    # they are: a zero matrix in the call proves nothing was encoded anew)
    zero = np.zeros_like(X)
    pc = PMM.preprocess_matrix(pcps, zero, nmod, cache_file=rprefix, host_resident=True)
    assert_same_cts(setup["want"], _port_out(PMM.mat_mult_cached(pcps, setup["pA"], pc)))
    rc = RMM.preprocess_matrix(rcps, zero, nmod, cache_file=pprefix, host_resident=True)
    assert_same_cts(setup["want"], _ref_out(RMM.mat_mult_cached(rcps, setup["A"], rc)))


def test_diag_cache_npz_equal_and_cross_load(setup, tmp_path):
    X, nmod, rcps, pcps = setup["X"], setup["nmod"], setup["rcps"], setup["pcps"]
    rpath, ppath = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    RMM._save_diag_cache(rpath, setup["rcache"])
    PMM.preprocess_matrix(pcps, X, nmod, cache_file=ppath, disk_cache=True)
    assert _members(ppath) == _members(rpath)
    # without disk_cache nothing is written
    PMM.preprocess_matrix(pcps, X, nmod, cache_file=str(tmp_path / "none.npz"))
    assert not (tmp_path / "none.npz").exists()
    # the port loads the reference's file (preprocess_matrix finds it; a
    # zero matrix in the call proves nothing was encoded anew) ...
    zero = np.zeros_like(X)
    loaded = PMM.preprocess_matrix(pcps, zero, nmod, cache_file=rpath)
    assert_same_cts(setup["want"], _port_out(PMM.mat_mult_cached(pcps, setup["pA"], loaded)))
    # ... and the reference the port's
    rc = RMM._load_diag_cache(ppath)
    assert_same_cts(setup["want"], _ref_out(RMM.mat_mult_cached(rcps, setup["A"], rc)))


# --- the lazily normalised products, three parties under collective keys

KP, NSNP = 3, 150


def _norm_data():
    rng = np.random.default_rng(23)
    n = sum(NROWS)
    X = rng.integers(0, 3, size=(n, NSNP)).astype(np.int8)
    mean = X.mean(0)
    stdinv = 1 / np.maximum(X.std(0), 0.1)
    return X, mean, stdinv, rng.normal(size=(KP, NSNP)) * 0.3, rng.normal(size=(KP, n)) * 0.3


def _split(pid):
    return slice(0, NROWS[1]) if pid == 1 else slice(NROWS[1], sum(NROWS))


POST_QX, POST_QXT = 1 / math.sqrt(NSNP), 1 / math.sqrt(sum(NROWS))


def _norm_body(mpc, cps, m):
    """Each data party's qx (its individuals) and qxt (its share of the SNP
    sums), then every party's rows decrypted collectively."""
    if mpc.pid == 0:
        return None
    X, mean, stdinv, qs, qi = _norm_data()
    B, MM, M = m["B"], m["MM"], m["M"]
    Xl = X[_split(mpc.pid)]
    nind = Xl.shape[0]
    x_cache = MM.preprocess_matrix(cps, Xl)
    xt_cache = MM.preprocess_matrix(cps, np.ascontiguousarray(Xl.T))
    x_mean = B.encrypt_float_vector(cps, mean)
    x_stdinv = B.encrypt_float_vector(cps, stdinv)
    qx = MM.qx_lazy_norm_stream(cps, mpc, B.encrypt_float_matrix(cps, qs), xt_cache, x_mean,
                                x_stdinv, nind, post_scale=POST_QX)
    qxt = MM.qxt_lazy_norm_stream(cps, mpc, B.encrypt_float_matrix(cps, qi[:, _split(mpc.pid)]),
                                  x_cache, x_mean, x_stdinv, post_scale=POST_QXT)
    out = {"qx": flat(qx), "qxt": flat(qxt)}
    if "torch" in B.__name__:
        for name, cm, width in (("qx", qx, None), ("qxt", qxt, NSNP)):
            dec = {}
            for p in (1, 2):
                nct = -(-NROWS[p] // cps.slots) if width is None else -(-width // cps.slots)
                cts = [ct for row in cm for ct in row] if mpc.pid == p else [None] * (KP * nct)
                pts = M.collective_decrypt_many(mpc.net, cps, cts, p)
                vals = np.stack([cps.ctx.decode(pt) for pt in pts]).reshape(KP, -1)
                dec[p] = vals[:, : (width or NROWS[p])]
            out[f"{name}_dec"] = dec
    return out


@pytest.fixture(scope="module")
def norm(ref_keys):
    return run("ref", ref_keys, _norm_body), run("port", ref_keys, _norm_body)


def test_lazy_norm_products_match_reference(norm):
    ref, port = norm
    for pid in (1, 2):
        for name in ("qx", "qxt"):
            assert_same_cts(ref[pid][name], port[pid][name])


def test_lazy_norm_products_match_numpy(norm):
    """qx = ((Q*s) X^T - ((Q*s) m) 1^T) / sqrt(m) over each party's
    individuals; the qxt of both parties sum to ((Q X) - (Q 1) m^T) * s /
    sqrt(n)."""
    port = norm[1]
    X, mean, stdinv, qs, qi = _norm_data()
    xs = (X - mean) * stdinv
    for pid in (1, 2):
        want = qs @ xs[_split(pid)].T * POST_QX
        assert np.abs(port[pid]["qx_dec"][pid] - want).max() < 2e-2
    got = sum(port[1]["qxt_dec"][p] for p in (1, 2))
    assert np.abs(got - qi @ xs * POST_QXT).max() < 2e-2
