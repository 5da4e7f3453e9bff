"""Port parity: the SS<->HE bridge of sfgwas_tpu_torch (mpc/ss_he.py, the
big-integer encode of crypto/encoding.py, utils/ddfloat.py and the word
helpers of ops/rns.py) against sfgwas_tpu's at TEST8 on the CPU, and the
native ring engine's failure path.

Both packages run three parties (dealer 0, data parties 1 and 2, hub 1)
under the reference's collective keys (carried across with interop), from
the same PRG keys, the same local generators and the same encryption
generators (cps.enc_rng), so the ciphertexts of ss_to_cmat and the shares of
cmat_to_ss are bit-equal; the decoded values hold tests/test_mhe.py's
tolerances."""

import dataclasses

import numpy as np
import pytest

from sfgwas_tpu.crypto.params import get_params as ref_get_params
from sfgwas_tpu.mpc import mhe as RM
from sfgwas_tpu.mpc import ss_he as RH
from sfgwas_tpu.ops import rns as ref_rns
from sfgwas_tpu.parallel import simulate as RS
from sfgwas_tpu.utils import ddfloat as RD
from sfgwas_tpu_torch import interop
from sfgwas_tpu_torch.crypto import ckks as PC
from sfgwas_tpu_torch.crypto.params import get_params as port_get_params
from sfgwas_tpu_torch.mpc import mhe as PM
from sfgwas_tpu_torch.mpc import ss_he as PH
from sfgwas_tpu_torch.ops import native_ring
from sfgwas_tpu_torch.ops import ring as PR
from sfgwas_tpu_torch.ops import rns as port_rns
from sfgwas_tpu_torch.parallel import simulate as PS
from sfgwas_tpu_torch.utils import ddfloat as PD

PRESET = "TEST8"
F = 30
P = PR.P256
VALS = np.random.default_rng(3).normal(scale=50.0, size=(2, 150))  # 2 rows of 2 cts
LOW_NMOD = 4  # below the masked decode's floor at TEST8 (tests/test_mhe.py:168-190)


def _u32(a):
    """Residues as uint32 (the port holds them as int32 tensors)."""
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _centered(v):
    v = int(v)
    return (v - P if v > P // 2 else v) / (1 << F)


@pytest.fixture(scope="module")
def ref_keys():
    """The reference's 3-party collective keys (one rotation key)."""
    return RS.run_parties(3, lambda mpc: RM.collective_init(mpc.net, PRESET, shifts_override=[1]))


def _seed(mpc):
    """The local generator (the dealer's secret draws) seeded alike in both
    packages."""
    mpc.rand.table[mpc.pid] = np.random.Generator(np.random.Philox(key=[9, mpc.pid]))
    return np.random.default_rng(100 + mpc.pid)  # the party's encryption generator


def _ref_party(ref_keys, low):
    def fn(mpc):
        cps = dataclasses.replace(ref_keys[mpc.pid], enc_rng=_seed(mpc))
        return _round_trip(mpc, cps, RH, RM, RS, low)

    return fn


def _port_party(ref_keys, low, device="cpu"):
    bundles = {p: interop.bundle_arrays(ref_keys[p]) for p in range(3)}

    def fn(mpc):
        enc_rng = _seed(mpc)
        ctx = PC.CkksContext(port_get_params(PRESET), device=device)
        cps = interop.crypto_params(ctx, enc_rng=enc_rng, **bundles[mpc.pid])
        return _round_trip(mpc, cps, PH, PM, PS, low)

    return fn


def _round_trip(mpc, cps, H, M, S, low):
    """ss_to_cmat of VALS (shared), the collective decrypt of every
    ciphertext, optionally a drop below the decode floor, cmat_to_ss back
    and the reveal; every party returns its ciphertexts (numpy), shares and
    revealed ints."""
    enc = [v % P for v in np.round(VALS * (1 << F)).astype(np.int64).reshape(-1).tolist()]
    sh = S.make_shares(mpc, enc).reshape(2, VALS.shape[1], -1)
    cm = H.ss_to_cmat(mpc, cps, sh)
    out = {}
    if mpc.pid > 0:
        out["cts"] = [(_u32(a.c0), _u32(a.c1), a.nmod, a.scale) for row in cm for a in row]
        pts = M.collective_decrypt_many(mpc.net, cps, [ct for row in cm for ct in row], -1)
        out["dec"] = np.stack([cps.ctx.decode(pt) for pt in pts])
        if low:
            cm = [[cps.ctx.drop_to(ct, LOW_NMOD) for ct in row] for row in cm]
    back = H.cmat_to_ss(mpc, cps, cm, -1, VALS.shape[1])
    out["shares"] = np.asarray(back)
    out["rev"] = S.reveal_ints(mpc, back.reshape(-1, back.shape[-1]))
    return out


def _run(ref_keys, low):
    ref = RS.run_parties(3, _ref_party(ref_keys, low))
    port = PS.run_parties(3, _port_party(ref_keys, low))
    return ref, port


@pytest.fixture(scope="module")
def runs(ref_keys):
    return {low: _run(ref_keys, low) for low in (False, True)}


@pytest.mark.parametrize("low", [False, True])
def test_ss_to_cmat_ciphertexts_match_reference(runs, low):
    ref, port = runs[low]
    for pid in (1, 2):
        r, p = ref[pid], port[pid]
        assert len(p["cts"]) == len(r["cts"]) == 4
        for (pc0, pc1, pn, ps), (rc0, rc1, rn, rs) in zip(p["cts"], r["cts"]):
            assert (pn, ps) == (rn, rs) and rc0.dtype == np.uint32
            np.testing.assert_array_equal(pc0, rc0)
            np.testing.assert_array_equal(pc1, rc1)


@pytest.mark.parametrize("low", [False, True])
def test_cmat_to_ss_shares_match_reference(runs, low):
    """The shares at every party, the dealer's zeros included, and the
    revealed ints; with low=True the conversion first refreshes the
    ciphertexts (the collective bootstrap) from below the decode floor."""
    ref, port = runs[low]
    for pid in range(3):
        np.testing.assert_array_equal(port[pid]["shares"], ref[pid]["shares"])
        assert port[pid]["shares"].dtype == np.int32
    for pid in (1, 2):
        assert [int(v) for v in port[pid]["rev"]] == [int(v) for v in ref[pid]["rev"]]


@pytest.mark.parametrize("low", [False, True])
def test_round_trip_within_tolerance(runs, low):
    """tests/test_mhe.py:158-165 and :168-190: the decrypt within 1e-4, the
    revealed shares within 1e-3 (after the refresh when low)."""
    _, port = runs[low]
    for pid in (1, 2):
        dec = port[pid]["dec"].reshape(2, -1)[:, :150]
        assert np.allclose(dec, VALS, atol=1e-4), np.abs(dec - VALS).max()
        got = np.array([_centered(v) for v in port[pid]["rev"]]).reshape(VALS.shape)
        assert np.allclose(got, VALS, atol=1e-3), np.abs(got - VALS).max()


def test_vector_and_single_ciphertext_forms(ref_keys):
    """ss_to_cvec / ss_to_ciphertext and cvec_to_ss / ciphertext_to_ss with
    a source party broadcasting: shares bit-equal to the reference's."""
    vals = [2.5, -1.25, 4.0, 0.5]
    enc = [int(round(v * (1 << F))) % P for v in vals]
    bundles = {p: interop.bundle_arrays(ref_keys[p]) for p in range(3)}

    def body(mpc, cps, H, S):
        sh = S.make_shares(mpc, enc)
        cv = H.ss_to_cvec(mpc, cps, sh)
        ct = H.ss_to_ciphertext(mpc, cps, sh)
        a = H.cvec_to_ss(mpc, cps, cv if mpc.pid == 1 else [None], 1, len(vals))
        b = H.ciphertext_to_ss(mpc, cps, ct if mpc.pid == 2 else None, 2, len(vals))
        return a, b, S.reveal_ints(mpc, a), S.reveal_ints(mpc, b)

    def ref_fn(mpc):
        return body(mpc, dataclasses.replace(ref_keys[mpc.pid], enc_rng=_seed(mpc)), RH, RS)

    def port_fn(mpc):
        enc_rng = _seed(mpc)
        ctx = PC.CkksContext(port_get_params(PRESET), device="cpu")
        return body(mpc, interop.crypto_params(ctx, enc_rng=enc_rng, **bundles[mpc.pid]), PH, PS)

    ref, port = RS.run_parties(3, ref_fn), PS.run_parties(3, port_fn)
    for pid in range(3):
        for i in (0, 1):
            np.testing.assert_array_equal(port[pid][i], ref[pid][i])
    for pid in (1, 2):
        for i in (2, 3):
            assert [int(v) for v in port[pid][i]] == [int(v) for v in ref[pid][i]]
            assert np.allclose([_centered(v) for v in port[pid][i]], vals, atol=1e-3)


# ---------------------------------------------------------------------------
# the big-integer encode, the double-double embeddings and the word helpers


def _big_ints(n, bits, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 24, size=(-(-bits // 24), n), dtype=np.int64)
    return [sum(int(w[k, j]) << (24 * k) for k in range(w.shape[0])) - (1 << (bits - 1))
            for j in range(n)], w


@pytest.mark.parametrize("what", ["encode_big", "decode_big", "dd_embed_inv", "dd_embed",
                                  "dd_from_words", "dd_embed_inv_dd", "dd_round_ints"])
def test_big_encode_and_dd_embeddings_match_reference(what):
    from sfgwas_tpu.crypto import ckks as RC

    rctx = RC.CkksContext(ref_get_params(PRESET))
    pctx = PC.CkksContext(port_get_params(PRESET), device="cpu")
    re, pe = rctx.encoder, pctx.encoder
    scale = rctx.params.scale / float(1 << F)
    ints, w = _big_ints(re.slots, 94, 5)
    coeffs, _ = _big_ints(re.n, 140, 6)
    calls = {
        "encode_big": lambda E, D: E.encode_big(ints, scale, 7),
        "decode_big": lambda E, D: E.decode_big(re.encode_big(ints, scale, 7), 7, scale),
        "dd_embed_inv": lambda E, D: D.dd_embed_inv(E, ints, scale),
        "dd_embed": lambda E, D: D.dd_embed(E, coeffs, scale),
        "dd_from_words": lambda E, D: np.stack(D.dd_from_words(w)),
        "dd_embed_inv_dd": lambda E, D: D.dd_embed_inv_dd(E, D.dd_from_words(w), scale),
        "dd_round_ints": lambda E, D: D.dd_round_ints(D.dd_div_f(D.dd_from_ints(coeffs), 3.0)),
    }
    want, got = calls[what](re, RD), calls[what](pe, PD)
    if isinstance(want, list):
        assert got == want
    else:
        assert np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, want)
    if what == "decode_big":  # and the round trip is exact to a unit
        assert max(abs(a - b) for a, b in zip(got, ints)) <= 1


def test_word_helpers_match_reference():
    """words_sample_centered draws the reference's words and leaves the
    generator where the reference does; words_mod_prime, the host exact CRT
    lift and the word ladder give the reference's residues."""
    g1, g2 = np.random.default_rng(8), np.random.default_rng(8)
    w = port_rns.words_sample_centered(g1, 94, 300)
    np.testing.assert_array_equal(w, ref_rns.words_sample_centered(g2, 94, 300))
    assert g1.bit_generator.state == g2.bit_generator.state
    assert w.min() >= -(1 << 23) and w[-1].max() < (1 << 21)
    basis = port_get_params(PRESET).basis
    for q in basis.primes[:3]:
        np.testing.assert_array_equal(port_rns.words_mod_prime(w, q),
                                      ref_rns.words_mod_prime(w, q))
    src, dst = [basis.primes[r] for r in (0, 1, 2)], [basis.primes[r] for r in range(9)]
    Q = src[0] * src[1] * src[2]
    v = [int(x) * (Q >> 40) // 2 for x in np.random.default_rng(9).integers(-(1 << 40), 1 << 40,
                                                                          size=257)]
    x = np.array([[vv % q for vv in v] for q in src], np.uint32)
    got = port_rns.crt_lift_centered(x, src, dst)
    np.testing.assert_array_equal(got, ref_rns.crt_lift_centered(x, src, dst))
    np.testing.assert_array_equal(got, np.array([[vv % q for vv in v] for q in dst], np.uint32))
    # the port's K6 plain version agrees with the exact host lift
    t = port_rns._crt_tables(basis, (0, 1, 2), tuple(range(9)), "cpu")
    np.testing.assert_array_equal(port_rns.to_u32(port_rns.crt_lift_plain(port_rns.as_i32(x), t)),
                                  got)


# ---------------------------------------------------------------------------
# the native engine: built at first use, and a failure raises


def test_failed_native_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "ring.cpp"
    bad.write_text("this is not C++;\n")
    with pytest.raises(native_ring.NativeBuildError, match="error"):
        native_ring.build(bad, tmp_path / "libbad.so")
    assert not (tmp_path / "libbad.so").exists()
    junk = tmp_path / "libjunk.so"
    junk.write_bytes(b"not a shared library")
    with pytest.raises(native_ring.NativeBuildError, match="cannot load"):
        native_ring.load(junk)
    # a ring on the engine raises at its first op; the numpy path is not
    # taken in its place
    monkeypatch.setattr(native_ring, "_LIB", None)
    monkeypatch.setattr(native_ring, "SRC", bad)
    monkeypatch.setattr(native_ring, "BUILD_DIR", tmp_path / "build")
    a = PR.LElem256.from_ints([1, 2])
    with pytest.raises(native_ring.NativeBuildError):
        PR.LElem256.add(a, a)
    plain = PR.field_for_size(256, native=False)
    np.testing.assert_array_equal(plain.add(a, a), plain.from_ints([2, 4]))


def test_native_engine_is_built_from_the_port():
    """The engine comes from the port's own source into its _build/."""
    lib = native_ring.lib()
    path = native_ring.target()
    assert path.parent == native_ring.PKG / "_build" and path.exists()
    assert native_ring.SRC == native_ring.PKG / "native" / "ring.cpp"
    assert lib._name == str(path)
