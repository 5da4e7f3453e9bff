"""Binary-share comparison protocols, the default path
(``mpc_boolean_shares = true``) (counterpart of sfgwas_tpu/mpc/boolean.py).

IsPositive2N / NormalizerEvenExp2N and the carry machinery of the Go
sfgwas (mpc/mpc.go:893-1865), with two differences:

* bit shares are *unpacked* GF(2) int8 lanes instead of 64-bit packed BElem
  words -- shifted-array Kogge-Stone networks replace the bit-twiddling, with
  identical round complexity (log2(nbits) Beaver-AND rounds);
* the share conversion prime -> power-of-two ring is a digit
  reinterpretation: both moduli are delta-below-a-power-of-two
  (ops/ring.py), so the conversion noise is a small multiple of delta
  absorbed by the 2^15 shift (mpc/mpc.go:1690-1708).

Bit layout convention: LSB-first [n, nbits].
"""

from __future__ import annotations


import numpy as np

from ..ops import ring as R
from ..ops.ring import GF2
from .mpc import _bits_lsb, _np


def _to_pow2(mpc, a, plus_one_shift: bool):
    """Reinterpret field shares as power-of-two-ring shares of
    shift * (x [+ 1]) [- 1], shift = 2^15 (mpc/mpc.go:1690-1708)."""
    ring = mpc.ring
    ring2 = R.pow2_ring_for(ring)
    el = a
    if plus_one_shift and mpc.pid == mpc.hub_pid:
        el = ring.add(el, np.broadcast_to(ring.const_np(1), el.shape))
    el = ring.mul_int(el, 1 << 15)
    # canonical field digits < modulus < 2^bits2N: same digit array is a
    # valid pow2-ring element
    x2 = _np(el)
    if ring2.nlimb != ring.nlimb:  # pragma: no cover
        raise ValueError("ring/pow2 companion digit mismatch")
    x2 = ring2.reduce(x2)
    if plus_one_shift and mpc.pid == mpc.hub_pid:
        x2 = ring2.sub(x2, np.broadcast_to(ring2.const_np(1), x2.shape))
    return ring2, x2


# ---------------------------------------------------------------------------
# GF(2) carry networks (Kogge-Stone)


def _shift_up(x, span, fill):
    """Shift along the bit axis towards higher indices by `span`:
    out[:, i] = x[:, i - span], filled with `fill` below."""
    n, m = x.shape
    pad = np.full((n, span), fill, x.dtype)
    return np.concatenate([pad, x[:, : m - span]], axis=1)


def _shift_down(x, span, fill):
    n, m = x.shape
    pad = np.full((n, span), fill, x.dtype)
    return np.concatenate([x[:, span:], pad], axis=1)


def _beaver_and(mpc, a, b):
    """Elementwise secure AND of GF(2) shares (one reveal round)."""
    (ar, br), (am, bm) = mpc.beaver_partition_many([a, b], GF2)
    return mpc.beaver_reconstruct(mpc.beaver_mult_elem(ar, am, br, bm, GF2), GF2)


def carries_of_add_public(mpc, a_pub, b, num_bits):
    """All carry bits of a_pub + b (carry INTO each position; c[:,0] = 0).

    a_pub: [n, m] public bits (same on data parties; pid 0 passes zeros),
    b:     [n, m] GF(2) shares.  Replaces SuffixCarryAux / CarryOverPublic
    (mpc/mpc.go:1332-1537) with an unpacked Kogge-Stone network."""
    m = num_bits
    g = GF2.mul(b, a_pub)  # local: XOR-shares AND public
    p = b
    if mpc.pid == mpc.hub_pid:
        p = GF2.add(p, a_pub)
    g = g[:, :m]
    p = p[:, :m]
    span = 1
    while span < m:
        g_lo = _shift_up(g, span, 0)
        p_lo = _shift_up(p, span, 1 if mpc.pid == mpc.hub_pid else 0)
        # batch the two ANDs in one beaver round
        pr, pm = mpc.beaver_partition(p, GF2)
        lr, lm = mpc.beaver_partition(np.concatenate([g_lo, p_lo], 1), GF2)
        prod = mpc.beaver_mult_elem(
            np.concatenate([pr, pr], 1), np.concatenate([pm, pm], 1), lr, lm, GF2
        )
        prod = mpc.beaver_reconstruct(prod, GF2)
        g = GF2.add(g, prod[:, :m])
        p = prod[:, m:]
        span *= 2
    # carry into position i = G over [0, i-1]
    return _shift_up(g, 1, 0)


def binary_add_public(mpc, a_pub, b, num_bits):
    """Sum bits of a_pub + b mod 2^num_bits (mpc/mpc.go:1318-1327)."""
    c = carries_of_add_public(mpc, a_pub, b, num_bits)
    s = GF2.add(b[:, :num_bits], c)
    if mpc.pid == mpc.hub_pid:
        s = GF2.add(s, a_pub[:, :num_bits])
    return s


def carry_out_public(mpc, a_pub, b, num_bits):
    """Final carry bit of a_pub + b over num_bits bits
    (CarryOutPublic, mpc/mpc.go:1542-1554)."""
    if num_bits == 0:
        return GF2.zeros((b.shape[0],))
    c = carries_of_add_public(mpc, a_pub, b, num_bits)
    # carry OUT of the top = G over [0, num_bits-1]; recompute from shift:
    # carries_of_add returns carry INTO each position, so the carry out of
    # position num_bits-1 is the generate over the full span.  Recover it by
    # one more combine step: g_total = c[num_bits] which we dropped -- so
    # compute directly instead.
    g = GF2.mul(b[:, :num_bits], a_pub[:, :num_bits])
    p = b[:, :num_bits]
    if mpc.pid == mpc.hub_pid:
        p = GF2.add(p, a_pub[:, :num_bits])
    span = 1
    m = num_bits
    while span < m:
        g_lo = _shift_up(g, span, 0)
        p_lo = _shift_up(p, span, 1 if mpc.pid == mpc.hub_pid else 0)
        pr, pm = mpc.beaver_partition(p, GF2)
        lr, lm = mpc.beaver_partition(np.concatenate([g_lo, p_lo], 1), GF2)
        prod = mpc.beaver_mult_elem(
            np.concatenate([pr, pr], 1), np.concatenate([pm, pm], 1), lr, lm, GF2
        )
        prod = mpc.beaver_reconstruct(prod, GF2)
        g = GF2.add(g, prod[:, :m])
        p = prod[:, m:]
        span *= 2
    return g[:, m - 1]


def suffix_all_zero(mpc, x_bits, num_bits):
    """z[:, i] = AND_{j >= i} NOT x_j  -- ones strictly above the MSB
    (the BinaryPrefixOr of mpc/mpc.go:1161-1316 after input inversion)."""
    z = x_bits[:, :num_bits]
    if mpc.pid == mpc.hub_pid:
        z = GF2.add(z, np.ones_like(z))  # NOT
    span = 1
    while span < num_bits:
        z_hi = _shift_down(z, span, 1 if mpc.pid == mpc.hub_pid else 0)
        z = _beaver_and(mpc, z, z_hi)
        span *= 2
    return z


def bit2a(mpc, bits_gf2):
    """Convert GF(2) shares of bits to field shares of the same bits
    (the rConv trick of mpc/mpc.go:1811-1830).  bits: [n] -> [n, nlimb].

    Stays in int32 end-to-end: canonical digits are < 2^8 and the +-1 sign
    flip keeps |values| < 2^8, so the int64 widening this used to do only
    tripled the [n, nlimb] temp traffic (the normalizer calls this at
    n = num_snps * k/2 — ~3.7M rows at example scale, where fresh host
    pages fault in at a few hundred MB/s)."""
    ring = mpc.ring
    n = bits_gf2.shape[0]
    r_field, r_bits = mpc.share_random_bits(ring, GF2, n, 1, 1, True)
    masked = GF2.add(bits_gf2, r_bits[:, 0])
    v = mpc.reveal_sym(masked, GF2)
    v = np.asarray(v, np.int32)  # public bits (garbage at pid 0)
    sign = np.int32(1) - np.int32(2) * v  # +-1
    out = ring.reduce(np.asarray(r_field, np.int32) * sign[:, None])
    if mpc.pid == mpc.hub_pid:
        out = np.asarray(out, np.int32)
        out[..., 0] += v
        out = ring.reduce(out)
    return out


# ---------------------------------------------------------------------------
# IsPositive2N / NormalizerEvenExp2N


def is_positive_2n(mpc, a):
    """Sign test via the power-of-two ring (mpc/mpc.go:1674-1830)."""
    ring = mpc.ring
    n = a.shape[0]
    ring2, x2 = _to_pow2(mpc, a, plus_one_shift=True)
    num_bits = ring2.bits

    r, r_bits = mpc.share_random_bits(ring2, GF2, n, num_bits, num_bits, True)
    a_rev = mpc.reveal_sym(ring2.add(x2, r), ring2)

    # t = complement of r:  x = a - r = (a+1) + t mod 2^num_bits
    t_bits = r_bits
    if mpc.pid == mpc.hub_pid:
        t_bits = GF2.add(t_bits, np.ones_like(t_bits))
    a_plus1 = ring2.add(a_rev, np.broadcast_to(ring2.const_np(1), a_rev.shape))
    if mpc.pid == 0:
        a_bits = GF2.zeros((n, num_bits))
    else:
        a_bits = _bits_lsb(ring2, np.asarray(a_plus1), num_bits, GF2)

    carry_msb = carry_out_public(
        mpc, a_bits[:, : num_bits - 1], t_bits[:, : num_bits - 1], num_bits - 1
    )
    msb = GF2.add(carry_msb, t_bits[:, num_bits - 1])
    if mpc.pid == mpc.hub_pid:
        msb = GF2.add(msb, a_bits[:, num_bits - 1])
        msb = GF2.add(msb, np.ones_like(msb))  # flip: positive -> 1
    return bit2a(mpc, msb)


def normalizer_even_exp_2n(mpc, a, k):
    """Power-of-two multipliers (b, sqrt(b)) via the binary path
    (mpc/mpc.go:893-1045).  Requires a > 0 with bit length <= k."""
    ring = mpc.ring
    n = a.shape[0]
    buffer_bits = 15
    k = k + buffer_bits

    ring2, x2 = _to_pow2(mpc, a, plus_one_shift=False)
    num_bits = ring2.bits

    r, r_bits = mpc.share_random_bits(ring2, GF2, n, num_bits, num_bits, True)
    a_rev = mpc.reveal_sym(ring2.add(x2, r), ring2)

    t_bits = r_bits
    if mpc.pid == mpc.hub_pid:
        t_bits = GF2.add(t_bits, np.ones_like(t_bits))
    a_plus1 = ring2.add(a_rev, np.broadcast_to(ring2.const_np(1), a_rev.shape))
    if mpc.pid == 0:
        a_bits = GF2.zeros((n, num_bits))
    else:
        a_bits = _bits_lsb(ring2, np.asarray(a_plus1), num_bits, GF2)

    x_bits = binary_add_public(mpc, a_bits, t_bits, num_bits)
    pref = suffix_all_zero(mpc, x_bits, num_bits)

    # half-bit positions k-2, k-4, ..., 0 (descending)
    positions = list(range(k - 2, -1, -2))
    half = np.asarray(pref)[:, positions]  # [n, num_half] GF(2) shares
    num_half = len(positions)

    hb_field = bit2a(mpc, half.reshape(n * num_half)).reshape(
        (n, num_half, ring.nlimb)
    )
    dev = R._dev(a)
    if not ring.host and dev is not None:  # the weighted sums below are its widest op
        hb_field = R.to_device(hb_field, dev)

    # coefficients 4^{j+1} - 4^j and 2^{j+1} - 2^j mod p
    p = ring.modulus
    c4 = [((pow(4, j + 1, p) - pow(4, j, p)) % p) for j in range(num_half)]
    c2 = [((pow(2, j + 1, p) - pow(2, j, p)) % p) for j in range(num_half)]
    c4d = np.asarray(ring.from_ints(c4))  # [num_half, L]
    c2d = np.asarray(ring.from_ints(c2))

    def weighted(coeffs):  # [num_half, L] -> ONE fused contraction
        # (mul-then-sum would band-embed the [n, num_half, L] operand:
        # 30 GB at the 100k-SNP example_data scale)
        return ring.dot_coeffs(hb_field, coeffs)

    normalizer = weighted(c4d)
    normalizer_sqrt = weighted(c2d)
    if mpc.pid == mpc.hub_pid:
        one = np.broadcast_to(ring.const_np(1), normalizer.shape)
        normalizer = ring.add(normalizer, one)
        normalizer_sqrt = ring.add(normalizer_sqrt, one)
    return normalizer, normalizer_sqrt
