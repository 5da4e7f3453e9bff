"""Port parity: the streamed genotype product and A A^T B of
sfgwas_tpu_torch (gwas/matmult.py: mat_mult_stream, dc_matmul_aat_b) and
the standard-deviation inverse (gwas/assoc.py: compute_std_inv) against
sfgwas_tpu's at TEST8 on the CPU, three parties of each package (dealer 0,
data parties 1 and 2, hub 1).  The linear association statistics end to
end are in tests/test_torch_assoc_stats.py.

Both packages run under the reference's collective keys (the protocol's
default shift set, carried across with interop), from the same PRG keys,
the same local generators and the same encryption generators; every output
ciphertext must be bit-equal to the reference's, with the same level and
scale, and decrypt to numpy's values within the reference tests'
tolerances."""

import dataclasses
import functools

import numpy as np
import pytest

from sfgwas_tpu.crypto import basics as RB
from sfgwas_tpu.gwas import assoc as RA
from sfgwas_tpu.gwas import matmult as RMM
from sfgwas_tpu.mpc import mhe as RM
from sfgwas_tpu.parallel import simulate as RS
from sfgwas_tpu_torch import interop
from sfgwas_tpu_torch.crypto import basics as PB
from sfgwas_tpu_torch.crypto import ckks as PC
from sfgwas_tpu_torch.crypto.params import get_params as port_get_params
from sfgwas_tpu_torch.gwas import assoc as PA
from sfgwas_tpu_torch.gwas import matmult as PMM
from sfgwas_tpu_torch.mpc import mhe as PM
from sfgwas_tpu_torch.parallel import simulate as PS

PRESET = "TEST8"
NROWS = [0, 24, 20]

REF = dict(B=RB, M=RM, MM=RMM, A=RA, S=RS)
PORT = dict(B=PB, M=PM, MM=PMM, A=PA, S=PS)


@functools.lru_cache(maxsize=None)
def _ref_keys():
    return RS.run_parties(3, lambda mpc: RM.collective_init(mpc.net, PRESET))


@pytest.fixture(scope="module")
def ref_keys():
    """The reference's 3-party collective keys with the default shift set,
    as the protocol generates them: made once a test process and shared by
    every module that imports this fixture (each holds both packages to
    each other under the same keys)."""
    return _ref_keys()


def _seeded(mpc):
    """The local PRG (the dealer's secret draws) and the encryption
    generator, seeded alike in both packages."""
    mpc.rand.table[mpc.pid] = np.random.Generator(np.random.Philox(key=[9, mpc.pid]))
    return np.random.default_rng(100 + mpc.pid)


def run(pkg, ref_keys, body, **cps_fields):
    """body(mpc, cps, modules) at three parties of one package, under the
    reference's keys (with cps_fields set on each bundle)."""
    m = REF if pkg == "ref" else PORT
    bundles = {p: interop.bundle_arrays(ref_keys[p]) for p in range(3)}

    def fn(mpc):
        enc_rng = _seeded(mpc)
        if pkg == "ref":
            cps = dataclasses.replace(ref_keys[mpc.pid], enc_rng=enc_rng, **cps_fields)
        else:
            ctx = PC.CkksContext(port_get_params(PRESET), device="cpu")
            cps = interop.crypto_params(ctx, enc_rng=enc_rng, **bundles[mpc.pid])
            cps = dataclasses.replace(cps, **cps_fields)
        return body(mpc, cps, m)

    return m["S"].run_parties(3, fn)


def assert_same_cts(ref, port):
    """Two lists of (c0, c1, nmod, scale): bit-equal residues, the same
    level and scale."""
    assert len(ref) == len(port) > 0
    for (r0, r1, rn, rs), (p0, p1, pn, ps) in zip(ref, port):
        assert (pn, ps) == (rn, rs)
        assert r0.dtype == p0.dtype == np.uint32
        np.testing.assert_array_equal(p0, r0)
        np.testing.assert_array_equal(p1, r1)


def flat(cm):
    """A cipher matrix (or vector) as its list of (c0, c1, nmod, scale)."""
    if cm and not isinstance(cm[0], list):
        cm = [cm]
    return [ct for col in interop.cipher_matrix_arrays(cm) for ct in col]


def decrypt_rows(mpc, cps, m, cols, nrows):
    """Every data party's rows of a row-partitioned cipher matrix (columns
    of ciphertexts), decrypted collectively: [sum(nrows), ncols]."""
    slots = cps.slots
    blocks = []
    for p in (1, 2):
        nct = -(-nrows[p] // slots)
        cts = [ct for col in cols for ct in col] if mpc.pid == p else [None] * (len(cols) * nct)
        pts = m["M"].collective_decrypt_many(mpc.net, cps, cts, p)
        vals = np.stack([cps.ctx.decode(pt) for pt in pts]).reshape(len(cols), nct * slots)
        blocks.append(vals[:, : nrows[p]].T)
    return np.concatenate(blocks)


# --- mat_mult_stream (tests/test_matmult.py:30-73)

S_ROWS, MN = 2, (200, 150)  # 2 block rows x 2 block columns at 128 slots


def _stream_data():
    rng = np.random.default_rng(11)
    return rng.normal(size=(S_ROWS, MN[0])) * 0.5, rng.integers(0, 3, size=MN).astype(np.int8)


def _stream_body(mpc, cps, m):
    Qm, X = _stream_data()
    if mpc.pid == 0:
        return None
    slots = cps.slots
    nbr = -(-MN[0] // slots)
    A = [
        [m["B"].encrypt_float_vector(cps, Qm[i, b0 : b0 + slots])[0] if mpc.pid == 1 else None
         for b0 in range(0, MN[0], slots)]
        for i in range(S_ROWS)
    ]
    A = [[m["M"].broadcast_ciphertext(mpc.net, cps, A[i][j], 1) for j in range(nbr)]
         for i in range(S_ROWS)]
    out, dsum, dsq = m["MM"].mat_mult_stream(cps, A, X, compute_sums=True)
    pre = m["MM"].preprocess_matrix_host(cps, X)
    out_pre, s2, q2 = m["MM"].mat_mult_stream(cps, A, None, host_pre=pre)
    assert s2 is None and q2 is None
    res = {"out": flat(out), "out_pre": flat(out_pre), "dsum": dsum, "dsq": dsq}
    if m is PORT:
        pts = m["M"].collective_decrypt_many(mpc.net, cps, [ct for row in out for ct in row], -1)
        dec = np.stack([cps.ctx.decode(pt) for pt in pts]).reshape(S_ROWS, -1)
        res["dec"] = dec[:, : MN[1]]
    return res


@pytest.fixture(scope="module")
def streamed(ref_keys):
    return run("ref", ref_keys, _stream_body), run("port", ref_keys, _stream_body)


def test_mat_mult_stream_matches_reference(streamed):
    ref, port = streamed
    for pid in (1, 2):
        assert_same_cts(ref[pid]["out"], port[pid]["out"])
        assert_same_cts(ref[pid]["out_pre"], port[pid]["out_pre"])
        # the prefetched path is the same product
        assert_same_cts(port[pid]["out"], port[pid]["out_pre"])


def test_mat_mult_stream_values_and_sums(streamed):
    port = streamed[1]
    Qm, X = _stream_data()
    want = Qm @ X.astype(np.float64)
    for pid in (1, 2):
        assert np.abs(port[pid]["dec"] - want).max() < 1e-2
        np.testing.assert_array_equal(port[pid]["dsum"], X.astype(np.float64).sum(0))
        np.testing.assert_array_equal(port[pid]["dsq"], (X.astype(np.float64) ** 2).sum(0))


def test_mat_mult_stream_squared_block(ref_keys):
    """square=True multiplies by the block's elementwise square."""
    X = np.random.default_rng(12).integers(-1, 3, size=(30, 20)).astype(np.int8)
    q = np.random.default_rng(13).normal(size=30)

    def body(mpc, cps, m):
        if mpc.pid == 0:
            return None
        ct = m["B"].encrypt_float_vector(cps, q)[0] if mpc.pid == 1 else None
        A = [[m["M"].broadcast_ciphertext(mpc.net, cps, ct, 1)]]
        out, dsum, _ = m["MM"].mat_mult_stream(cps, A, X, compute_sums=True, square=True)
        pts = m["M"].collective_decrypt_many(mpc.net, cps, out[0], -1)
        return flat(out), cps.ctx.decode(pts[0])[: X.shape[1]], dsum

    ref, port = run("ref", ref_keys, body), run("port", ref_keys, body)
    assert_same_cts(ref[1][0], port[1][0])
    assert np.abs(port[1][1] - q @ (X.astype(np.float64) ** 2)).max() < 1e-2
    np.testing.assert_array_equal(port[1][2], X.astype(np.float64).sum(0))


# --- dc_matmul_aat_b, both branches


def _aatb_data():
    rng = np.random.default_rng(14)
    n = sum(NROWS)
    return rng.normal(size=(n, 2)) / np.sqrt(n), rng.normal(size=(n, 2))


def _aatb_body(batched: bool):
    Af, Bf = _aatb_data()
    split = {1: slice(0, NROWS[1]), 2: slice(NROWS[1], sum(NROWS))}

    def body(mpc, cps, m):
        B_ = m["B"]
        if mpc.pid == 0:  # the data parties' protocol
            return None
        A = [B_.encrypt_float_vector(cps, Af[split[mpc.pid], j]) for j in range(2)]
        if batched:
            Bm = [B_.encrypt_float_vector(cps, Bf[split[mpc.pid], j]) for j in range(2)]
            fn = None
        else:
            Bm = [B_.encode_float_vector(cps, Bf[split[mpc.pid], j]) for j in range(2)]

            def fn(cp, a, bm, j):
                return B_.cpmult(cp, a, bm[j])

        out = m["MM"].dc_matmul_aat_b(cps, mpc, A, Bm, NROWS, 2, fn)
        res = {"out": flat(out)}
        if m is PORT:
            res["dec"] = decrypt_rows(mpc, cps, m, out, NROWS)
        return res

    return body


@pytest.mark.parametrize("batched", [False, True], ids=["inner_fn", "batched"])
def test_dc_matmul_aat_b_matches_reference(ref_keys, batched):
    body = _aatb_body(batched)
    ref, port = run("ref", ref_keys, body), run("port", ref_keys, body)
    Af, Bf = _aatb_data()
    want = Af @ (Af.T @ Bf)
    for pid in (1, 2):
        assert_same_cts(ref[pid]["out"], port[pid]["out"])
        assert np.abs(port[pid]["dec"] - want).max() < 2e-2


def test_match_vec_drops_to_the_lower_level():
    ctx = PC.CkksContext(port_get_params(PRESET), device="cpu")
    cps = PM.CryptoParams(ctx, None, None, None, {}, None)
    hi, lo = ctx.zero_ct(ctx.nq), ctx.zero_ct(ctx.nq - 2)
    got = PMM._match_vec(cps, [hi, lo], [lo, hi])
    assert [ct.nmod for ct in got] == [ctx.nq - 2, ctx.nq - 2]


# --- compute_std_inv

NSNP_BLOCKS = (100, 90)  # two blocks: one ciphertext of 128 slots each


def _std_inv_data():
    rng = np.random.default_rng(15)
    return rng.uniform(0.5, 4.0, size=sum(NSNP_BLOCKS)), float(rng.uniform(0.5, 4.0))


def _std_inv_body(mpc, cps, m):
    varx_all, vary = _std_inv_data()
    slots = cps.slots
    filt = np.concatenate([np.arange(slots) < k for k in NSNP_BLOCKS])
    nsnps = int(filt.sum())
    if mpc.pid > 0:
        x = np.zeros(len(filt))
        x[filt] = varx_all
        share = np.where(np.arange(len(filt)) % 2 == mpc.pid - 1, x, 0.0)
        varx = m["M"].aggregate_cvec(mpc.net, cps, m["B"].encrypt_float_vector(cps, share))
        yv = np.full(slots, vary if mpc.pid == 1 else 0.0)
        vy = m["M"].aggregate_ct(mpc.net, cps, m["B"].encrypt_float_vector(cps, yv)[0])
        fl = filt
    else:
        varx, vy, fl = [None] * len(NSNP_BLOCKS), None, None
    sx, sy = m["A"].compute_std_inv(mpc, cps, varx, vy, nsnps, fl)
    if mpc.pid == 0:
        return None
    res = {"x": flat(sx), "y": flat([sy])}
    if m is PORT:
        pts = m["M"].collective_decrypt_many(mpc.net, cps, list(sx) + [sy], -1)
        dec = [cps.ctx.decode(pt) for pt in pts]
        res["dx"] = np.concatenate(dec[:-1])[filt]
        res["dy"] = dec[-1]
    return res


def test_compute_std_inv_matches_reference(ref_keys):
    ref, port = run("ref", ref_keys, _std_inv_body), run("port", ref_keys, _std_inv_body)
    varx, vary = _std_inv_data()
    for pid in (1, 2):
        assert_same_cts(ref[pid]["x"], port[pid]["x"])
        assert_same_cts(ref[pid]["y"], port[pid]["y"])
        assert np.abs(port[pid]["dx"] - 1 / np.sqrt(varx)).max() < 1e-3
        # every slot of stdinvy holds 1/sqrt(vary)
        assert np.abs(port[pid]["dy"] - 1 / np.sqrt(vary)).max() < 1e-3


def test_release_plan_drops_the_staged_plan():
    ctx = PC.CkksContext(port_get_params(PRESET), device="cpu")
    cps = PM.CryptoParams(ctx, None, None, None, {}, None)
    X = np.random.default_rng(16).integers(0, 3, size=(20, 30)).astype(np.int8)
    cache = PMM.finish_preprocess_matrix(cps, PMM.preprocess_matrix_host(cps, X), PMM.mm_nmod(cps))
    plan = PMM._plan_for(cps, cache, PMM.mm_nmod(cps))
    assert PMM._plan_cache.get(id(cache)) is plan
    PMM.release_plan(cache)
    assert id(cache) not in PMM._plan_cache
    PMM.release_plan(cache)  # a second release is a no-op
