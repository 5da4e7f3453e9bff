"""Port parity: the MHE collective layer of sfgwas_tpu_torch against
sfgwas_tpu at TEST8 on the CPU.

Units are held bit for bit on the same inputs (bs_share, the CRT lifts,
kswitch_share and the ciphertext arithmetic).  The reference draws its
noise and mask seeds from unseeded generators, so whole protocol runs are
held by their public, seed-derived parts (the CRPs: pk.p1 and every
rotation key's d1) and by decoded value, as tests/test_mhe.py holds the
reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfgwas_tpu.crypto import ckks as RC
from sfgwas_tpu.crypto.params import get_params as ref_get_params
from sfgwas_tpu.mpc import mhe as RM
from sfgwas_tpu.ops import rns as ref_rns
from sfgwas_tpu.parallel.simulate import run_parties
from sfgwas_tpu_torch import interop
from sfgwas_tpu_torch.crypto import basics as PB
from sfgwas_tpu_torch.crypto import ckks as PC
from sfgwas_tpu_torch.crypto.params import get_params as port_get_params
from sfgwas_tpu_torch.mpc import mhe as PM
from sfgwas_tpu_torch.ops import rns as port_rns
from sfgwas_tpu_torch.parallel.simulate import run_network_parties

PRESET = "TEST8"
SHIFTS = [1, 2, 4, 8, 16, 32, 64, 127, 126, 124, 120, 112, 96]  # tests/test_mhe.py:13
SLOTS = 128
VALS = {p: np.random.default_rng(10 + p).normal(size=SLOTS) for p in (1, 2)}


def _u32(t):
    return port_rns.to_u32(t)


def _i32(a):
    return port_rns.as_i32(np.asarray(a))


@pytest.fixture(scope="module")
def ctxs():
    return RC.CkksContext(ref_get_params(PRESET)), PC.CkksContext(port_get_params(PRESET),
                                                                  device="cpu")


def _rand(ctx, shape, rows, seed):
    rng = np.random.default_rng(seed)
    q = np.array([ctx.basis.primes[r] for r in rows], np.int64)[:, None]
    return (rng.integers(0, 1 << 40, size=shape + (len(rows), ctx.n)) % q).astype(np.uint32)


def test_bs_share_matches_reference(ctxs):
    rctx, pctx = ctxs
    rows, tgt = tuple(range(3)), tuple(range(9))
    B = 3
    nwords, top = PM._mask_bits(pctx.params, len(rows), 3)
    bound = rctx.params.q_prod(len(rows)).bit_length() - 3 - 1  # mhe.py:705-708, 3 parties
    assert (nwords, top) == ((bound + 23) // 24, bound - 24 * ((bound + 23) // 24 - 1))
    crp, c1s = _rand(rctx, (B,), tgt, 1), _rand(rctx, (B,), rows, 2)
    sk = _rand(rctx, (), rctx.full_rows, 3)
    e1, e2 = _rand(rctx, (B,), rows, 4), _rand(rctx, (B,), tgt, 5)
    seed = (np.uint32(123456789), np.uint32(987654321))
    r1, r2 = RM._bs_share_kernel(rctx, rows, tgt, B, nwords, top, seed, np.uint32(0),
                                 *(jnp.asarray(a) for a in (crp, c1s, sk, e1, e2)))
    p1, p2 = PM.bs_share(pctx, rows, tgt, B, nwords, top, (123456789, 987654321), 0,
                         *(_i32(a) for a in (crp, c1s, sk, e1, e2)))
    assert np.array_equal(_u32(p1), np.asarray(r1))
    assert np.array_equal(_u32(p2), np.asarray(r2))


@pytest.mark.parametrize("fill", ["bounded", "zero", "minus_one"])
@pytest.mark.parametrize("src,dst", [((0, 1, 2), tuple(range(9))), ((0, 1, 2, 3, 4), (0, 2, 9))])
def test_crt_lift_matches_reference_and_host(fill, src, dst):
    """The device lift (kernel K6's plain version) against the reference's
    crt_lift_centered_dev and host crt_lift_centered, and against the exact
    residues of v, on values the bootstrap bounds (|v| < Q/8), zero and -1."""
    rb, pb = ref_get_params(PRESET).basis, port_get_params(PRESET).basis
    Q = 1
    for r in src:
        Q *= pb.primes[r]
    rng = np.random.default_rng(len(src))
    if fill == "bounded":
        v = [int(x) * (Q >> 66) // 8 for x in rng.integers(-(1 << 62), 1 << 62, size=700)]
    else:
        v = [0 if fill == "zero" else -1] * 300
    x = np.array([[vv % pb.primes[r] for vv in v] for r in src], np.uint32)
    exact = np.array([[vv % pb.primes[r] for vv in v] for r in dst], np.uint32)
    got = _u32(port_rns.crt_lift_centered_dev(_i32(x), pb, src, dst))
    assert np.array_equal(got, np.asarray(ref_rns.crt_lift_centered_dev(jnp.asarray(x), rb, src,
                                                                         dst)))
    host = ref_rns.crt_lift_centered(x, [rb.primes[r] for r in src], [rb.primes[r] for r in dst])
    assert np.array_equal(got, exact) and np.array_equal(host, exact)


def test_kswitch_share_and_arithmetic_match(ctxs):
    rctx, pctx = ctxs
    nq = rctx.nq
    a, e = _rand(rctx, (nq,), rctx.full_rows, 6), _rand(rctx, (nq,), rctx.full_rows, 7)
    s_t, s_d = _rand(rctx, (), rctx.full_rows, 8), _rand(rctx, (), rctx.full_rows, 9)
    for diag in (s_d, None):
        want = rctx.kswitch_share(jnp.asarray(s_t), None if diag is None else jnp.asarray(diag),
                                  jnp.asarray(a), jnp.asarray(e))
        got = pctx.kswitch_share(_i32(s_t), None if diag is None else _i32(diag), _i32(a),
                                 _i32(e))
        assert np.array_equal(_u32(got), np.asarray(want))
    assert pctx.galois_conjugate() == rctx.galois_conjugate()

    def cts(ctx, conv, nmod, scale, seed):
        c = _rand(rctx, (2,), tuple(range(nmod)), seed)
        return (RC if ctx is rctx else PC).Ciphertext(conv(c[0]), conv(c[1]), nmod, scale)

    sc = rctx.params.scale
    cases = [  # (a nmod, a scale, b nmod, b scale)
        (9, sc, 9, sc), (9, sc, 7, sc * (1 + 1e-4)),  # equal; drift below _SCALE_EQ
        (9, sc * 1.01, 9, sc), (7, sc, 9, sc * 0.98),  # drift aligned exactly (a level burnt)
        (4, sc, 4, sc * 1.01),  # at the floor: the counted tolerance
    ]
    for i, (na, sa, nb, sb) in enumerate(cases):
        ra, rb_ = cts(rctx, jnp.asarray, na, sa, 20 + i), cts(rctx, jnp.asarray, nb, sb, 40 + i)
        pa, pb_ = cts(pctx, _i32, na, sa, 20 + i), cts(pctx, _i32, nb, sb, 40 + i)
        for op in ("add", "sub"):
            r, p = getattr(rctx, op)(ra, rb_), getattr(pctx, op)(pa, pb_)
            assert (p.nmod, p.scale) == (r.nmod, r.scale), (op, i)
            assert np.array_equal(_u32(p.c0), np.asarray(r.c0)), (op, i)
            assert np.array_equal(_u32(p.c1), np.asarray(r.c1)), (op, i)
        r, p = rctx.neg(ra), pctx.neg(pa)
        assert np.array_equal(_u32(p.c0), np.asarray(r.c0))
        vals = np.random.default_rng(i).normal(size=SLOTS)
        rpt, ppt = rctx.encode(vals, nb, sb), pctx.encode(vals, nb, sb)
        r, p = rctx.add_plain(ra, rpt), pctx.add_plain(pa, ppt)
        assert (p.nmod, p.scale) == (r.nmod, r.scale), i
        assert np.array_equal(_u32(p.c0), np.asarray(r.c0)), i
        assert np.array_equal(_u32(p.c1), np.asarray(r.c1)), i
    assert pctx.scale_drift_accepts == rctx.scale_drift_accepts > 0
    assert pctx.scale_drift_max == rctx.scale_drift_max


@pytest.fixture(scope="module")
def ref_keys():
    """The reference's 3-party collective keys with the reference test's
    shift set."""
    return run_parties(3, lambda mpc: RM.collective_init(mpc.net, PRESET, shifts_override=SHIFTS))


def _port_party(cps_for):
    """A party function: keys from cps_for(net), then encrypt VALS[pid],
    aggregate, drop to nmod 3, bootstrap to the band (scale reset) and to
    the top, decrypt both; returns the key bundle, the decodes, the refreshed
    levels and scales, and the aggregated low ciphertexts as numpy."""

    def fn(net):
        cps = cps_for(net)
        if net.pid == 0:
            return cps, None
        ctx = cps.ctx
        agg = PM.aggregate_cvec(net, cps, PB.encrypt_float_vector(cps, VALS[net.pid]))
        low = [ctx.drop_to(ct, 3) for ct in agg]
        band = PM.collective_bootstrap_many(net, cps, low, -1, target_nmod=ctx.params.mm_nmod)
        top = PM.bootstrap_vec(net, cps, low, -1)
        pts = PM.collective_decrypt_many(net, cps, band + top, -1)
        return cps, {
            "dec": [ctx.decode(pt) for pt in pts],
            "levels": [band[0].nmod, top[0].nmod], "scales": [band[0].scale, top[0].scale],
            "low": [(port_rns.to_u32(c.c0), port_rns.to_u32(c.c1), c.nmod, c.scale) for c in low],
        }

    return fn


@pytest.fixture(scope="module")
def port_run():
    return run_network_parties(
        3, _port_party(lambda net: PM.collective_init(net, PRESET, shifts_override=SHIFTS,
                                                      device="cpu")), timeout=600)


def test_collective_keys_public_parts_match_reference(ref_keys, port_run):
    """The CRPs come from the shared global PRG: pk.p1 and every rotation
    key's d1 are bit-equal at every data party, and the key sets agree."""
    for pid in (1, 2):
        rc, pc = ref_keys[pid], port_run[pid][0]
        assert np.array_equal(_u32(pc.pk.p1), np.asarray(rc.pk.p1))
        assert sorted(pc.rot_keys) == sorted(rc.rot_keys)
        for g, k in rc.rot_keys.items():
            assert np.array_equal(_u32(pc.rot_keys[g].d1), np.asarray(k.d1)), g
            assert pc.rot_keys[g].d0.shape == k.d0.shape
        assert pc.rlk.d0.shape == rc.rlk.d0.shape
    # the data parties hold one collective key
    assert torch.equal(port_run[1][0].pk.p0, port_run[2][0].pk.p0)
    assert not port_run[0][0].sk.s.any()


def test_collective_decrypt_and_bootstrap_decode(port_run):
    """As tests/test_mhe.py:57-84: the refreshed sums decode within 1e-3,
    the band refresh at exactly the preset scale."""
    params = port_get_params(PRESET)
    want = VALS[1] + VALS[2]
    for pid in (1, 2):
        out = port_run[pid][1]
        assert out["levels"] == [params.mm_nmod, params.nq]
        assert out["scales"][0] == params.scale
        for dec in out["dec"]:
            assert np.abs(dec - want).max() < 1e-3


def test_port_protocol_under_reference_keys(ref_keys, port_run):
    """The reference's collective keys carried across (interop): the port's
    decrypt and bootstrap decode what the reference's decrypt and bootstrap
    of the same ciphertexts decode."""
    bundles = {p: interop.bundle_arrays(ref_keys[p]) for p in range(3)}
    pctx = {}

    def cps_for(net):
        pctx[net.pid] = PC.CkksContext(port_get_params(PRESET), device="cpu")
        return interop.crypto_params(pctx[net.pid], enc_rng=np.random.default_rng(net.pid),
                                     **bundles[net.pid])

    port = run_network_parties(3, _port_party(cps_for), timeout=600)
    low = port[1][1]["low"]

    def ref_fn(mpc):
        cps = ref_keys[mpc.pid]
        if mpc.pid == 0:
            return None
        cts = [RC.Ciphertext(jnp.asarray(c0), jnp.asarray(c1), n, s) for c0, c1, n, s in low]
        band = RM.collective_bootstrap_many(mpc.net, cps, cts, -1,
                                            target_nmod=cps.params.mm_nmod)
        pts = RM.collective_decrypt_many(mpc.net, cps, cts + band, -1)
        return [cps.ctx.decode(pt) for pt in pts]

    ref = run_parties(3, ref_fn)
    want = VALS[1] + VALS[2]
    for pid in (1, 2):
        got = port[pid][1]["dec"]
        assert np.abs(got[0] - ref[pid][1]).max() < 1e-3  # band refresh
        assert np.abs(got[1] - ref[pid][0]).max() < 1e-3  # the top refresh vs the input
        assert np.abs(ref[pid][0] - want).max() < 1e-3
        assert port[pid][1]["low"][0][2] == 3
    # the port encrypted under the reference's public key: the same low
    # ciphertexts at both data parties
    assert all(np.array_equal(a[0], b[0]) for a, b in zip(port[1][1]["low"], port[2][1]["low"]))


def test_memoised_crps_are_not_written(port_run):
    """Party 1's and party 2's rotation keys share their d1 tensors through
    the CRP memo; a protocol run over the same keys leaves every memoised
    CRP as it was."""
    memo = dict(PM.CrpStream._memo.items())
    assert memo, "the run's CRPs are memoised while its keys live"
    k1, k2 = port_run[1][0], port_run[2][0]
    g = next(iter(k1.rot_keys))
    assert k1.rot_keys[g].d1.data_ptr() == k2.rot_keys[g].d1.data_ptr()
    before = {k: v.clone() for k, v in memo.items()}
    run_network_parties(3, _port_party(lambda net: port_run[net.pid][0]), timeout=600)
    for k, v in memo.items():
        assert torch.equal(v, before[k]), k


def test_protocol_over_byte_frames():
    """The same protocol over a transport that serializes every message
    (the codec path of Network, as a socket transport runs it): residues
    arrive as numpy arrays, and the bootstrap takes its broadcast path, in
    which every party finalizes from the aggregated shares."""
    import threading

    from sfgwas_tpu_torch.mpc.prg import Random
    from sfgwas_tpu_torch.parallel.transport import LocalCluster, LocalTransport, Network

    class Framed(LocalTransport):
        zero_copy = False

    cluster = LocalCluster(3)
    fn = _port_party(lambda net: PM.collective_init(net, PRESET, shifts_override=SHIFTS[:3],
                                                    device="cpu"))
    res, errs = [None] * 3, []

    def work(pid):
        try:
            net = Network(Framed(cluster, pid, 0), pid, 3, 1, Random(pid, 3))
            res[pid] = (fn(net), net.sent_bytes)
        except BaseException as e:  # noqa: BLE001 - reported below
            errs.append(e)

    threads = [threading.Thread(target=work, args=(p,)) for p in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errs and not any(t.is_alive() for t in threads), errs
    want = VALS[1] + VALS[2]
    for pid in (1, 2):
        (cps, out), sent = res[pid]
        assert isinstance(cps.pk.p0, torch.Tensor) and cps.rot_keys
        assert out["levels"] == [cps.params.mm_nmod, cps.params.nq]
        for dec in out["dec"]:
            assert np.abs(dec - want).max() < 1e-3
        assert sent[1 if pid == 2 else 2] > 0
    # the data parties agree on the public key that crossed as bytes
    assert torch.equal(res[1][0][0].pk.p0, res[2][0][0].pk.p0)


def test_matrix_and_transport_helpers():
    """bootstrap_mat_all over unbalanced row partitions, bootstrap_mat,
    aggregate_cmat, aggregate_int_vec, the ciphertext send/recv and
    broadcasts, and collective_decrypt_many with a source broadcast."""
    rng = np.random.default_rng(31)
    vals = {p: rng.normal(size=(2, SLOTS)) for p in (1, 2)}

    def fn(net):
        cps = PM.collective_init(net, PRESET, shifts_override=SHIFTS[:2], device="cpu")
        ints = PM.aggregate_int_vec(net, np.array([net.pid, 1]))
        if net.pid == 0:
            return ints
        ctx, band = cps.ctx, cps.params.mm_nmod
        enc = [PB.encrypt_float_vector(cps, vals[net.pid][i])[0] for i in range(2)]
        cm = [enc] if net.pid == 1 else [[enc[0]], [enc[1]]]
        mine = PM.bootstrap_mat_all(net, cps, cm, band)
        out = {"ints": ints, "shape": [len(r) for r in mine]}
        for src in (1, 2):
            flat = [ct for row in mine for ct in row] if net.pid == src else [None, None]
            out[src] = [ctx.decode(pt) for pt in PM.collective_decrypt_many(net, cps, flat, src)]
        summed = PM.aggregate_cmat(net, cps, [[enc[0]]])
        again = PM.bootstrap_mat(net, cps, summed, -1)
        out["sum"] = ctx.decode(PM.collective_decrypt(net, cps, again[0][0], -1))
        if net.pid == 1:
            PM.send_ciphertext(net, enc[1], 2)
            got = PM.broadcast_ciphertext(net, cps, enc[0], 1)
        else:
            got = PM.recv_ciphertext(net, 1)
            got = PM.aggregate_ct(net, cps, ctx.add(got, PM.broadcast_ciphertext(net, cps, None, 1)))
        if net.pid == 1:
            got = PM.aggregate_ct(net, cps, ctx.zero_ct(got.nmod))
        out["pair"] = ctx.decode(PM.collective_decrypt(net, cps, got, -1))
        return out

    res = run_network_parties(3, fn, timeout=600)
    assert np.array_equal(res[0], [0, 1])
    for pid in (1, 2):
        out = res[pid]
        assert np.array_equal(out["ints"], [3, 2])
        assert out["shape"] == ([2] if pid == 1 else [1, 1])
        for src in (1, 2):
            for i in range(2):
                assert np.abs(out[src][i] - vals[src][i]).max() < 1e-3
        assert np.abs(out["sum"] - vals[1][0] - vals[2][0]).max() < 1e-3
        assert np.abs(out["pair"] - vals[1][1] - vals[1][0]).max() < 1e-3
