"""Secret-share <-> homomorphic-encryption conversions (counterpart of
sfgwas_tpu/mpc/ss_he.py: SSToCMat / CMatToSS of the Go sfgwas' mpc/ss.go).

Parties mask with *small* statistical masks (data_bits + 30-bit sigma), so
the double-double embedding (utils/ddfloat.py) keeps every encode/decode
error below the HE noise floor.

SS -> HE: each data party i samples rho_i (centered, < 2^b); shares' =
  share_i - rho_i are revealed to c = x - sum(rho_i) (no wraparound:
  b + log n << field bits); Enc(x) = sum_i Enc(rho_i) + plaintext(c),
  aggregated through the hub.

HE -> SS: each party adds an encoded small slot mask mu_i and smudging noise
  to its partial decryption; the hub decodes x + sum(mu_i) and keeps it
  minus its own mask as its share; the others hold -mu_i.

Fixed-point convention: SS integers x at frac_bits f are CKKS slot values
x / 2^f; the conversions encode integers at scale ct.scale / 2^f.

The shares and the masks live in host numpy; the polynomials go to the
context's device (the card unless the context runs on the CPU) for the NTT
(kernel K1 on the card), the encryption and the collective rounds.  The
hub's read-back of the unmasked polynomial (span he2ss_pull) is the one
device -> host copy the protocol needs.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from ..crypto import ckks as C
from ..ops import ring as R
from ..ops import rns
from ..ops.rns import add_mod, mul_mod_barrett
from ..utils import prof
from . import mhe
from .mhe import CryptoParams
from .mpc import MPC

SIGMA_STAT = 30  # statistical hiding bits


def _words_to_ints(w: np.ndarray) -> List[int]:
    """Signed word array [nwords, n] -> python ints."""
    out = []
    nw, n = w.shape
    for j in range(n):
        v = 0
        for k in range(nw):
            v += int(w[k, j]) << (rns._WB * k)
        out.append(v)
    return out


def _words_to_ring_digits(w: np.ndarray, ring: R.Ring) -> np.ndarray:
    """Signed word array [nwords, n] -> canonical ring digits [n, nlimb]."""
    nw, n = w.shape
    digits = np.zeros((n, ring.nlimb), dtype=np.int32)
    for k in range(nw):
        base = 3 * k  # 24-bit words = 3 digit bytes
        digits[:, base] += (w[k] & 0xFF).astype(np.int32)
        digits[:, base + 1] += ((w[k] >> 8) & 0xFF).astype(np.int32)
        digits[:, base + 2] += (w[k] >> 16).astype(np.int32)  # keeps sign
    return ring.reduce(digits)


def _ntt_poly(ctx: C.CkksContext, poly: np.ndarray, rows):
    """A host coefficient-domain poly [len(rows), N] (uint32) -> NTT domain
    on the context's device."""
    return ctx._ntt(ctx.to_dev(poly), rows)


def _ss_to_cmat(mpc: MPC, cps: CryptoParams, rm) -> List[List[C.Ciphertext]]:
    """RMat shares [r, n, L] -> CipherMatrix (r rows x ceil(n/slots) cts),
    known to all data parties.  Party 0 returns None."""
    if mpc.pid == 0:
        return None
    ring = mpc.ring
    ctx = cps.ctx
    slots = cps.slots
    r, n = rm.shape[0], rm.shape[1]
    f = mpc.frac_bits
    b = mpc.data_bits + SIGMA_STAT + int(math.ceil(math.log2(mpc.nparty))) + 2

    w = rns.words_sample_centered(cps.enc_rng, b, r * n)
    rho_digits = _words_to_ring_digits(w, ring).reshape(r, n, ring.nlimb)
    shares2 = ring.sub(rm, rho_digits)
    c = mpc.reveal_sym(shares2)
    c_ints = ring.centered_ints(c.reshape(r * n, ring.nlimb))
    rho_ints = _words_to_ints(w)

    nmod = ctx.nq
    rows = tuple(range(nmod))
    scale = ctx.params.scale
    enc_scale = scale / float(1 << f)  # slot value = int / 2^f at scale Delta
    out = []
    for i in range(r):
        row = []
        for s0 in range(0, n, slots):
            sl = slice(i * n + s0, i * n + min(s0 + slots, n))
            poly = ctx.encoder.encode_big(rho_ints[sl], enc_scale, nmod)
            pt = C.Plaintext(_ntt_poly(ctx, poly, rows), nmod, scale)
            row.append(ctx.encrypt(pt, cps.pk, cps.enc_rng))
        out.append(row)
    out = mhe.aggregate_cmat(mpc.net, cps, out)

    # add the public part c and declare the fixed-point scale
    q = ctx._t(rows)["q"]
    for i in range(r):
        for j, s0 in enumerate(range(0, n, slots)):
            sl = slice(i * n + s0, i * n + min(s0 + slots, n))
            cpoly = _ntt_poly(ctx, ctx.encoder.encode_big(c_ints[sl], enc_scale, nmod), rows)
            ct = out[i][j]
            out[i][j] = C.Ciphertext(add_mod(ct.c0, cpoly, q), ct.c1, nmod, scale)
    return out


def ss_to_cvec(mpc, cps, rv):
    out = ss_to_cmat(mpc, cps, rv[None] if rv.ndim == 2 else rv)
    return out[0] if out else None


def ss_to_ciphertext(mpc, cps, rv):
    cv = ss_to_cvec(mpc, cps, rv)
    return cv[0] if cv else None


def _cmat_to_ss(mpc: MPC, cps: CryptoParams, cm, source_pid: int, n_elem_row: int) -> np.ndarray:
    """CipherMatrix -> RMat shares [r, n_elem_row, L] (CMatToSS,
    mpc/ss.go:146-281)."""
    ring = mpc.ring
    ctx = cps.ctx
    slots = cps.slots
    f = mpc.frac_bits
    if mpc.pid == 0:
        r = len(cm) if cm else 1
        return ring.zeros((r, n_elem_row))
    if source_pid > 0:
        # non-source parties may pass None / [None...] placeholders; the
        # broadcast fills them (broadcast_ciphertext ignores ct on receivers)
        cm = [
            [
                mhe.broadcast_ciphertext(mpc.net, cps, ct, source_pid)
                for ct in (row if row is not None else [None])
            ]
            for row in cm
        ]
    r = len(cm)
    b = mpc.data_bits + SIGMA_STAT

    # Level-headroom guard.  The masked plaintext (data + statistical mask +
    # smudging) must fit q_prod(nmod); ciphertexts can arrive near the
    # modulus floor where it does not (the association's variance chain
    # arrives at nmod 3).  The conversion then restores its own
    # precondition with ONE batched collective refresh to the shallowest
    # sufficient level at or above the matmult band (bootstrap is the
    # level/scale reset point).
    def _need_bits(scale: float) -> int:
        return int(math.log2(scale / float(1 << f))) + b + 10 + 1

    lens = [len(row) for row in cm]
    flat = [ct for row in cm for ct in row]
    if any(ctx.params.q_prod(ct.nmod).bit_length() <= _need_bits(ct.scale) for ct in flat):
        tgt = max(ctx.params.mm_nmod, max(ct.nmod for ct in flat))
        while (
            tgt < ctx.nq
            and ctx.params.q_prod(tgt).bit_length() <= _need_bits(ctx.params.scale) + 1
        ):
            tgt += 1
        flat = mhe.collective_bootstrap_many(mpc.net, cps, flat, -1, target_nmod=tgt)
        cm, ofs = [], 0
        for L in lens:
            cm.append(flat[ofs : ofs + L])
            ofs += L

    out_rows = []
    for i in range(r):
        shares_row = []
        for ct in cm[i]:
            nmod = ct.nmod
            rows = tuple(range(nmod))
            t = ctx._t(rows)
            enc_scale = ct.scale / float(1 << f)
            # headroom check: masked plaintext must fit the modulus
            need_bits = int(math.log2(enc_scale)) + b + 10
            assert ctx.params.q_prod(nmod).bit_length() > need_bits + 1, (
                f"ciphertext level too low for HE->SS conversion: nmod={nmod} "
                f"({ctx.params.q_prod(nmod).bit_length()} bits) < need "
                f"{need_bits + 1} (scale={ct.scale:.3e}, frac={f})"
            )
            with prof.span("he2ss_mask_enc"):
                w = rns.words_sample_centered(cps.enc_rng, b, slots)
                mu_ints = _words_to_ints(w)
                mask_poly = _ntt_poly(ctx, ctx.encoder.encode_big(mu_ints, enc_scale, nmod), rows)
            e = ctx.small_to_rns(ctx.sample_gauss(cps.enc_rng, 6.36), rows)
            share = add_mod(
                add_mod(mul_mod_barrett(ct.c1, cps.sk.s[:nmod], t["q"], t["mu"]), e, t["q"]),
                mask_poly,
                t["q"],
            )
            agg = mhe._aggregate_mod(mpc.net, ctx, share, rows)
            m = add_mod(ct.c0, agg, t["q"])
            mu_digits = _words_to_ring_digits(w, ring)
            if mpc.pid == mpc.hub_pid:
                coeff = ctx._ntt(m, rows, inverse=True)
                with prof.span("he2ss_pull"):
                    coeff_np = rns.to_u32(coeff)
                with prof.span("he2ss_decode"):
                    y = ctx.encoder.decode_big(coeff_np, nmod, enc_scale)
                    y_digits = ring.from_ints(y[:slots])
                my = ring.sub(y_digits, mu_digits)
            else:
                my = ring.neg(mu_digits)
            shares_row.append(my)
        row = np.concatenate([np.asarray(s) for s in shares_row], axis=0)[:n_elem_row]
        out_rows.append(row)
    return np.stack(out_rows)


def cvec_to_ss(mpc, cps, cv, source_pid, n_elem):
    return cmat_to_ss(mpc, cps, [cv], source_pid, n_elem)[0]


def ciphertext_to_ss(mpc, cps, ct, source_pid, n_elem):
    # non-source parties pass ct=None; the [None] placeholder carries the
    # (statically known) 1-ciphertext shape so cmat_to_ss can receive into it
    return cvec_to_ss(mpc, cps, [ct], source_pid, n_elem)


def cmat_to_ss(*a, **k):
    with prof.span("he2ss"):
        return _cmat_to_ss(*a, **k)


def ss_to_cmat(*a, **k):
    with prof.span("ss2he"):
        return _ss_to_cmat(*a, **k)
