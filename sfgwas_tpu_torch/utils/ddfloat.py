"""Double-double (float64-pair, ~106-bit) arithmetic and the canonical-
embedding FFT on the host (a copy of sfgwas_tpu/utils/ddfloat.py: numpy,
and mpmath for the twiddle tables).

This replaces the lattigo fork's exact big-value encoder
(``EncodeRVecNew``/``DecodeRVec``, used by the Go sfgwas' SS<->HE conversion
at mpc/ss.go:125,260).  The conversions mask with *small* statistical masks
(<= ~2^95, see mpc/ss_he.py), so a 106-bit embedding keeps the absolute
error of encode/decode well below one fixed-point unit.

All vector ops are numpy-vectorized error-free transformations (Dekker /
Knuth, no FMA required); twiddles are precomputed to 60 digits with mpmath.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

Dd = Tuple[np.ndarray, np.ndarray]  # (hi, lo)


def two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    s = a + b
    err = b - (s - a)
    return s, err


_SPLITTER = 134217729.0  # 2^27 + 1


def split(a):
    t = _SPLITTER * a
    hi = t - (t - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    p = a * b
    ahi, alo = split(a)
    bhi, blo = split(b)
    err = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, err


def dd(hi, lo=None) -> Dd:
    hi = np.asarray(hi, np.float64)
    lo = np.zeros_like(hi) if lo is None else np.asarray(lo, np.float64)
    return (hi, lo)


def dd_add(x: Dd, y: Dd) -> Dd:
    s, e = two_sum(x[0], y[0])
    e = e + x[1] + y[1]
    return quick_two_sum(s, e)


def dd_sub(x: Dd, y: Dd) -> Dd:
    return dd_add(x, (-y[0], -y[1]))


def dd_mul(x: Dd, y: Dd) -> Dd:
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return quick_two_sum(p, e)


def dd_mul_f(x: Dd, f: float) -> Dd:
    p, e = two_prod(x[0], np.float64(f))
    e = e + x[1] * f
    return quick_two_sum(p, e)


def dd_div_f(x: Dd, f: float) -> Dd:
    q0 = x[0] / f
    p, pe = two_prod(q0, np.float64(f))
    r = ((x[0] - p) - pe) + x[1]
    q1 = r / f
    return quick_two_sum(q0, q1)


def dd_neg(x: Dd) -> Dd:
    return (-x[0], -x[1])


def dd_from_ints(vals: List[int]) -> Dd:
    hi = np.empty(len(vals), np.float64)
    lo = np.empty(len(vals), np.float64)
    for i, v in enumerate(vals):
        v = int(v)
        h = float(v)
        hi[i] = h
        lo[i] = float(v - int(h))
    return (hi, lo)


def dd_round_ints(x: Dd) -> List[int]:
    out = []
    hi, lo = x
    for i in range(len(hi)):
        n0 = int(round(float(hi[i])))
        rem = (float(hi[i]) - n0) + float(lo[i])
        out.append(n0 + int(round(rem)))
    return out


# complex dd: (re, im) each a Dd


def cdd(re: Dd, im: Dd):
    return (re, im)


def cdd_add(x, y):
    return (dd_add(x[0], y[0]), dd_add(x[1], y[1]))


def cdd_sub(x, y):
    return (dd_sub(x[0], y[0]), dd_sub(x[1], y[1]))


def cdd_mul(x, y):
    re = dd_sub(dd_mul(x[0], y[0]), dd_mul(x[1], y[1]))
    im = dd_add(dd_mul(x[0], y[1]), dd_mul(x[1], y[0]))
    return (re, im)


def cdd_conj(x):
    return (x[0], dd_neg(x[1]))


_tw_cache = {}


def _twiddles(n: int):
    """(cos, sin) dd tables for e^{2 pi i k / n}, k in [0, n) -- plus the
    psi tables e^{+- i pi k / n}."""
    if n in _tw_cache:
        return _tw_cache[n]
    import mpmath

    mpmath.mp.dps = 60
    cos_hi = np.empty(n)
    cos_lo = np.empty(n)
    sin_hi = np.empty(n)
    sin_lo = np.empty(n)
    pc_hi = np.empty(n)
    pc_lo = np.empty(n)
    ps_hi = np.empty(n)
    ps_lo = np.empty(n)
    two_pi = 2 * mpmath.pi
    pi = mpmath.pi
    for k in range(n):
        c = mpmath.cos(two_pi * k / n)
        s = mpmath.sin(two_pi * k / n)
        h = float(c)
        cos_hi[k], cos_lo[k] = h, float(c - mpmath.mpf(h))
        h = float(s)
        sin_hi[k], sin_lo[k] = h, float(s - mpmath.mpf(h))
        c = mpmath.cos(pi * k / n)
        s = mpmath.sin(pi * k / n)
        h = float(c)
        pc_hi[k], pc_lo[k] = h, float(c - mpmath.mpf(h))
        h = float(s)
        ps_hi[k], ps_lo[k] = h, float(s - mpmath.mpf(h))
    out = {
        "cos": (cos_hi, cos_lo),
        "sin": (sin_hi, sin_lo),
        "psi_cos": (pc_hi, pc_lo),
        "psi_sin": (ps_hi, ps_lo),
    }
    _tw_cache[n] = out
    return out


def _bitrev_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    perm = np.zeros(n, dtype=np.int64)
    for i in range(n):
        r = 0
        x = i
        for _ in range(bits):
            r = (r << 1) | (x & 1)
            x >>= 1
        perm[i] = r
    return perm


def cdd_fft(x, n: int, sign: int):
    """In-place-style iterative radix-2 FFT of complex-dd vector x
    (tuple of (re_dd, im_dd)), X_k = sum_i x_i e^{sign * 2 pi i ik / n}."""
    tw = _twiddles(n)
    perm = _bitrev_perm(n)
    re = (x[0][0][perm].copy(), x[0][1][perm].copy())
    im = (x[1][0][perm].copy(), x[1][1][perm].copy())
    size = 2
    while size <= n:
        half = size // 2
        step = n // size
        # twiddle indices for j in [0, half): w^{sign * j * step}
        j = np.arange(half)
        idx = (j * step) % n
        wc = (tw["cos"][0][idx], tw["cos"][1][idx])
        ws_ = (tw["sin"][0][idx] * sign, tw["sin"][1][idx] * sign)
        # reshape views: [nblocks, size]
        re_h = (re[0].reshape(-1, size), re[1].reshape(-1, size))
        im_h = (im[0].reshape(-1, size), im[1].reshape(-1, size))
        u_re = (re_h[0][:, :half], re_h[1][:, :half])
        u_im = (im_h[0][:, :half], im_h[1][:, :half])
        v_re = (re_h[0][:, half:], re_h[1][:, half:])
        v_im = (im_h[0][:, half:], im_h[1][:, half:])
        # t = w * v
        t_re = dd_sub(dd_mul(wc, v_re), dd_mul(ws_, v_im))
        t_im = dd_add(dd_mul(wc, v_im), dd_mul(ws_, v_re))
        nr0, nr1 = dd_add(u_re, t_re), dd_sub(u_re, t_re)
        ni0, ni1 = dd_add(u_im, t_im), dd_sub(u_im, t_im)
        re = (
            np.concatenate([nr0[0], nr1[0]], axis=1).reshape(-1),
            np.concatenate([nr0[1], nr1[1]], axis=1).reshape(-1),
        )
        im = (
            np.concatenate([ni0[0], ni1[0]], axis=1).reshape(-1),
            np.concatenate([ni0[1], ni1[1]], axis=1).reshape(-1),
        )
        size *= 2
    return (re, im)


# ---------------------------------------------------------------------------
# canonical embedding (mirrors crypto/encoding.py float paths)


def dd_embed_inv(encoder, z_ints: List[int], scale: float) -> List[int]:
    """slots (big ints) -> rounded coefficient ints of sigma^{-1}(z)*scale."""
    n = encoder.n
    slots = encoder.slots
    zs = dd_from_ints(z_ints)
    A_re = dd(np.zeros(n))
    A_im = dd(np.zeros(n))
    A_re[0][encoder.pos] = zs[0]
    A_re[1][encoder.pos] = zs[1]
    A_re[0][encoder.pos_conj] = zs[0]
    A_re[1][encoder.pos_conj] = zs[1]
    # imaginary parts zero for real input
    X = cdd_fft((A_re, A_im), n, sign=-1)  # matches fft(A): e^{-2pi i ik/N}
    # multiply by psi^{-i} = e^{-i pi i / n}: (cos, -sin)
    tw = _twiddles(n)
    pc = tw["psi_cos"]
    ps = (-tw["psi_sin"][0], -tw["psi_sin"][1])
    re = dd_sub(dd_mul(X[0], pc), dd_mul(X[1], ps))
    # scale/n; scale is an exact float64 (< 2^53)
    re = dd_div_f(dd_mul_f(re, scale), float(n))
    return dd_round_ints(re)


def dd_embed(encoder, coeff_ints: List[int], scale: float) -> List[int]:
    """coefficient ints -> rounded big-int slot values (real parts)."""
    n = encoder.n
    a = dd_from_ints(coeff_ints)
    a = dd_div_f(a, scale)
    tw = _twiddles(n)
    x_re = dd_mul(a, tw["psi_cos"])
    x_im = dd_mul(a, tw["psi_sin"])
    X = cdd_fft((x_re, x_im), n, sign=+1)
    hi, lo = X[0]
    out_hi = hi[encoder.pos]
    out_lo = lo[encoder.pos]
    return dd_round_ints((out_hi, out_lo))


def dd_from_words(w: np.ndarray, word_bits: int = 24) -> Dd:
    """Vectorized: signed word arrays [nwords, n] -> dd values (exact for
    |v| < 2^106)."""
    acc = dd(np.zeros(w.shape[1]))
    for k in range(w.shape[0]):
        term = dd(w[k].astype(np.float64) * float(2.0 ** (word_bits * k)))
        acc = dd_add(acc, term)
    return acc


def dd_embed_inv_dd(encoder, z: Dd, scale: float) -> List[int]:
    """Like dd_embed_inv but takes slot values already in dd form."""
    n = encoder.n
    A_re = dd(np.zeros(n))
    A_im = dd(np.zeros(n))
    A_re[0][encoder.pos] = z[0]
    A_re[1][encoder.pos] = z[1]
    A_re[0][encoder.pos_conj] = z[0]
    A_re[1][encoder.pos_conj] = z[1]
    X = cdd_fft((A_re, A_im), n, sign=-1)
    tw = _twiddles(n)
    pc = tw["psi_cos"]
    ps = (-tw["psi_sin"][0], -tw["psi_sin"][1])
    re = dd_sub(dd_mul(X[0], pc), dd_mul(X[1], ps))
    re = dd_div_f(dd_mul_f(re, scale), float(n))
    return dd_round_ints(re)
