"""RNS modular arithmetic for the CKKS polynomial rings, in PyTorch
(counterpart of sfgwas_tpu/ops/rns.py).

Residues are torch.int32 tensors with a leading prime axis; every value is
a canonical residue below its prime (< 2^26).  Products are computed
exactly in int64 ((a*b) % q < 2^52), so results match the reference's
wrapping-uint32 Shoup/Barrett arithmetic bit for bit: both produce the
canonical residue.

The NTT is the CUDA kernel K1 (ops/cuda_ntt.py) on the card; the butterfly
functions below are its plain versions.  The collective bootstrap's CRT lift
is the CUDA kernel K6 (crt_lift below, source csrc/crt_lift.cu).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence

import numpy as np
import torch

from .cuda_build import CudaKernel, check, ptr


def is_prime(n: int) -> bool:
    if n < 4:
        return n in (2, 3)
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = pow(x, 2, n)
            if x == n - 1:
                break
        else:
            return False
    return True


def gen_primes(count: int, logn: int, prime_bits: int = 25) -> List[int]:
    """NTT-friendly primes q = 1 mod 2N, alternating around 2^prime_bits."""
    two_n = 1 << (logn + 1)
    center = 1 << prime_bits
    lo = center - (center % two_n) + 1
    hi = lo + two_n
    out: List[int] = []
    while len(out) < count:
        for cand in (hi, lo):
            if len(out) >= count:
                break
            if cand.bit_length() <= 32 and cand > two_n and is_prime(cand) and cand not in out:
                out.append(cand)
        lo -= two_n
        hi += two_n
        if lo < (1 << (prime_bits - 2)):
            raise RuntimeError("not enough NTT primes")
    return out


def _find_psi(q: int, two_n: int) -> int:
    """Primitive 2N-th root of unity mod q."""
    assert (q - 1) % two_n == 0
    for g in range(2, 10000):
        psi = pow(g, (q - 1) // two_n, q)
        if pow(psi, two_n // 2, q) != 1:  # order exactly 2N
            return psi
    raise RuntimeError("no 2N-th root found")


def bitrev_table(logn: int) -> np.ndarray:
    """rev[j] = bit reversal of j over logn bits (uint64)."""
    idx = np.arange(1 << logn, dtype=np.uint64)
    rev = np.zeros_like(idx)
    for b in range(logn):
        rev |= ((idx >> np.uint64(b)) & np.uint64(1)) << np.uint64(logn - 1 - b)
    return rev


def shoup(c: np.ndarray, q: np.ndarray) -> np.ndarray:
    """floor(c * 2^32 / q) companion table (host); c < 2^26."""
    return (
        (c.astype(np.uint64) << np.uint64(32)) // q.astype(np.uint64)
    ).astype(np.uint32)


class RnsBasis:
    """Prime chain + NTT tables for R_Q = Z_Q[X]/(X^N + 1).

    The tables are built on the host as uint32 numpy arrays (identical to
    the reference's); _sel() hands out int32 torch copies per (rows,
    device)."""

    def __init__(self, primes: Sequence[int], logn: int):
        self.primes = list(primes)
        self.logn = logn
        self.n = 1 << logn
        L = len(self.primes)
        n = self.n
        q = np.array(self.primes, dtype=np.uint64)
        self.bar_shift = 52
        mu = (1 << self.bar_shift) // q.astype(object)

        rev = bitrev_table(logn)
        psi_rev = np.zeros((L, n), dtype=np.uint32)
        ipsi_rev = np.zeros((L, n), dtype=np.uint32)
        ninv = np.zeros((L,), dtype=np.uint32)

        def powmod_vec(base: int, e: np.ndarray, qi: int) -> np.ndarray:
            out = np.ones(n, dtype=np.uint64)
            b = np.uint64(base)
            qv = np.uint64(qi)
            for bit in range(int(e.max()).bit_length()):
                sel = (e >> np.uint64(bit)) & np.uint64(1)
                out = np.where(sel == 1, (out * b) % qv, out)
                b = (b * b) % qv
            return out

        for i, qi in enumerate(self.primes):
            psi = _find_psi(qi, 2 * n)
            ipsi = pow(psi, -1, qi)
            psi_rev[i] = powmod_vec(psi, rev, qi).astype(np.uint32)
            ipsi_rev[i] = powmod_vec(ipsi, rev, qi).astype(np.uint32)
            ninv[i] = pow(n, -1, qi)
        qcol = q.astype(np.uint32)[:, None]
        # q_l mod q_i and q_l^{-1} mod q_i for base extension / rescale: [L, L]
        qmod = np.zeros((L, L), dtype=np.uint32)
        qinv = np.zeros((L, L), dtype=np.uint32)
        for l_ in range(L):
            for i in range(L):
                qmod[l_, i] = self.primes[l_] % self.primes[i]
                if i != l_:
                    qinv[l_, i] = pow(self.primes[l_], -1, self.primes[i])
        self.qmod = qmod
        self.qinv = qinv
        self._np = dict(
            q=qcol,
            mu=np.array(mu, dtype=np.uint64).astype(np.uint32)[:, None],
            psi=psi_rev,
            psi_s=shoup(psi_rev, np.broadcast_to(qcol, psi_rev.shape)),
            ipsi=ipsi_rev,
            ipsi_s=shoup(ipsi_rev, np.broadcast_to(qcol, ipsi_rev.shape)),
            ninv=ninv[:, None],
            ninv_s=shoup(ninv[:, None], qcol),
        )
        self._cache: Dict = {}

    def __hash__(self):
        return hash((tuple(self.primes), self.logn))

    def __eq__(self, other):
        return (
            isinstance(other, RnsBasis)
            and other.primes == self.primes
            and other.logn == self.logn
        )


def as_i32(a: np.ndarray) -> torch.Tensor:
    """uint32 residues (host) -> int32 torch tensor with the same bits."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    if not a.flags.writeable:  # e.g. a view of a jax array
        a = a.copy()
    return torch.from_numpy(a.view(np.int32))


def to_u32(t: torch.Tensor) -> np.ndarray:
    """int32 torch residues -> uint32 numpy with the same bits."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def _sel(basis: RnsBasis, rows, device) -> Dict[str, torch.Tensor]:
    """Per-row-subset tables as contiguous int32 tensors on `device`,
    cached per (rows, device).  q and mu are [L, 1]; psi* are [L, N]."""
    device = torch.device(device)
    key = ("sel", tuple(rows), str(device))
    if key not in basis._cache:
        idx = np.asarray(rows, dtype=np.int64)
        basis._cache[key] = {
            k: as_i32(v[idx]).to(device) for k, v in basis._np.items()
        }
    return basis._cache[key]


def barrett_mu64(basis: RnsBasis, rows, device) -> torch.Tensor:
    """mu = floor(2^64 / q) per row as an int64 tensor [L] on `device`
    (the bits of a uint64; every mu is below 2^63), cached per (rows,
    device).  The kernels K2 and K3 reduce a 64-bit sum a with it:
    qhat = umulhi64(a, mu), r = a - qhat*q, one conditional subtract; K4
    and K5 read their 32-bit constants off it (floor(2^32 / q) is its high
    word)."""
    device = torch.device(device)
    key = ("mu64", tuple(rows), str(device))
    if key not in basis._cache:
        mu = [(1 << 64) // basis.primes[r] for r in rows]
        basis._cache[key] = torch.tensor(mu, dtype=torch.int64).to(device)
    return basis._cache[key]


# ---------------------------------------------------------------------------
# elementwise modular arithmetic on canonical int32 residues


def _csub(x, q):
    return torch.where(x >= q, x - q, x)


def add_mod(a, b, q):
    return _csub(a + b, q)


def sub_mod(a, b, q):
    return _csub(a + q - b, q)


def neg_mod(a, q):
    return torch.where(a == 0, a, q - a)


def mul_mod(a, b, q):
    """(a * b) mod q, exact in int64; int32 canonical result."""
    return torch.remainder(a.long() * b.long(), q.long()).to(torch.int32)


def mul_mod_shoup(a, w, w_shoup, q):
    """a * w mod q.  The reference computes this with a Shoup companion
    w_shoup and wrapping uint32 arithmetic; the exact int64 product gives
    the same canonical residue, so w_shoup is not needed here (the CUDA
    kernels use it)."""
    del w_shoup
    return mul_mod(a, w, q)


def mul_mod_barrett(a, b, q, mu):
    """a * b mod q.  The reference's 13-bit-digit Barrett reduction with
    mu = floor(2^52/q) gives the canonical residue that the exact int64
    product gives here."""
    del mu
    return mul_mod(a, b, q)


# ---------------------------------------------------------------------------
# NTT dispatch and the plain butterflies


def ntt(x, basis: RnsBasis, rows, inverse: bool = False, plain: bool = False):
    """Negacyclic NTT over the given prime rows.  x: [len(rows), N] int32;
    standard order in -> bit-reversed out (forward); inverse undoes it."""
    return ntt_b(x[:, None], basis, rows, inverse, plain)[:, 0]


def ntt_b(x, basis: RnsBasis, rows, inverse: bool = False, plain: bool = False):
    """Batched negacyclic NTT: x [L, B, N] with len(rows) == L; the batch
    axis shares each row's twiddles.  Runs the CUDA kernel K1
    (ops/cuda_ntt.py) unless plain=True is asked for."""
    if plain:
        return _ntt_b_butterfly(x, basis, rows, inverse)
    from . import cuda_ntt

    return cuda_ntt.ntt_b_kernel(x.contiguous(), basis, rows, inverse)


def _ntt_butterfly(x, basis: RnsBasis, rows, inverse: bool = False):
    """Plain butterfly NTT on one [L, N] matrix."""
    return _ntt_b_butterfly(x[:, None], basis, rows, inverse)[:, 0]


def _ntt_b_butterfly(x, basis: RnsBasis, rows, inverse: bool = False):
    """Plain batched butterfly NTT (the plain version of kernel K1):
    Cooley-Tukey forward with bit-reversed output, Gentleman-Sande inverse
    with the n^-1 fold, in int64 with exact products."""
    n = basis.n
    t = _sel(basis, rows, x.device)
    L, Bdim = x.shape[0], x.shape[1]
    q = t["q"].long().view(L, 1, 1, 1)
    y = x.long().contiguous()
    if not inverse:
        tw = t["psi"].long()
        m = 1
        while m < n:
            half = n // (2 * m)
            yv = y.view(L, Bdim, m, 2, half)
            S = tw[:, m : 2 * m].view(L, 1, m, 1)
            U = yv[:, :, :, 0, :]
            V = torch.remainder(yv[:, :, :, 1, :] * S, q)
            y = torch.stack(
                [_csub(U + V, q), _csub(U + q - V, q)], dim=3
            ).view(L, Bdim, n)
            m *= 2
        return y.to(torch.int32)
    tw = t["ipsi"].long()
    m = n
    while m > 1:
        h = m // 2
        half = n // m
        yv = y.view(L, Bdim, h, 2, half)
        S = tw[:, h : 2 * h].view(L, 1, h, 1)
        U = yv[:, :, :, 0, :]
        V = yv[:, :, :, 1, :]
        lo = _csub(U + V, q)
        hi = torch.remainder(_csub(U + q - V, q) * S, q)
        y = torch.stack([lo, hi], dim=3).view(L, Bdim, n)
        m = h
    ninv = t["ninv"].long().view(L, 1, 1)
    return torch.remainder(y * ninv, q.view(L, 1, 1)).to(torch.int32)


# ---------------------------------------------------------------------------
# host <-> residue conversions


def ints_to_rns(coeffs, primes) -> np.ndarray:
    """Host: array of python ints [N] -> residues [L, N] uint32."""
    out = np.zeros((len(primes), len(coeffs)), dtype=np.uint32)
    for i, q in enumerate(primes):
        out[i] = np.array([int(c) % q for c in coeffs], dtype=np.uint64).astype(
            np.uint32
        )
    return out


def rns_to_ints(res, primes) -> np.ndarray:
    """Host: residues [L, N] -> centered python ints via CRT."""
    res = np.asarray(res)
    L = res.shape[0]
    Q = 1
    for q in primes[:L]:
        Q *= q
    out = np.zeros(res.shape[1], dtype=object)
    for i in range(L):
        qi = primes[i]
        Qi = Q // qi
        inv = pow(Qi % qi, -1, qi)
        out = (out + res[i].astype(object) * ((Qi * inv) % Q)) % Q
    half = Q >> 1
    for j in range(len(out)):
        if out[j] > half:
            out[j] -= Q
    return out


# ---------------------------------------------------------------------------
# Signed 24-bit word arithmetic on the host: the statistical masks of the
# SS<->HE conversions (mpc/ss_he.py) and the exact CRT lift, the host oracle
# of kernel K6

_WB = 24  # word bits; products q_i(25b) * word(24b) < 2^49, sums of ~20 fit


def _int_to_words(v: int, nwords: int) -> np.ndarray:
    return np.array(
        [(v >> (_WB * k)) & ((1 << _WB) - 1) for k in range(nwords)], dtype=np.int64
    )


def crt_lift_centered(res: np.ndarray, primes_src, dst_primes) -> np.ndarray:
    """res: [l, N] residues mod primes_src -> centered value v (|v| < Q/2)
    re-reduced mod each of dst_primes: returns [len(dst), N] uint32.

    Exact: v = sum_i res_i * T_i mod Q computed in 24-bit words with
    conditional big-subtractions of Q, then centered and folded mod the
    destination primes."""
    res = np.asarray(res, dtype=np.int64)
    l, n = res.shape
    Q = 1
    for q in primes_src[:l]:
        Q *= q
    # v = sum_i res_i * T_i can reach (sum_i q_i) * Q ~ 2^26 * l * Q, so the
    # word array and the shifted-subtract ladder must cover that headroom
    slack = max(p.bit_length() for p in primes_src[:l]) + l.bit_length() + 2
    nwords = (Q.bit_length() + slack + _WB) // _WB + 1
    Tw = np.zeros((l, nwords), dtype=np.int64)
    for i in range(l):
        qi = primes_src[i]
        Ti = (Q // qi) * pow(Q // qi, -1, qi) % Q
        Tw[i] = _int_to_words(Ti, nwords)
    # v_words[k, j] = sum_i res[i, j] * Tw[i, k]   (< l * 2^25 * 2^24 < 2^54)
    vw = np.einsum("ij,ik->kj", res, Tw)  # [nwords, N] int64
    vw = _word_carry(vw)
    # binary shifted-subtract ladder: v < 2^slack * Q -> v mod Q
    Qw = _int_to_words(Q, nwords)
    for s in range(slack, -1, -1):
        vw = _cond_sub_words(vw, _int_to_words(Q << s, nwords))
    # centered: if v >= Q/2: v -= Q
    half_w = _int_to_words(Q // 2, nwords)
    ge = _ge_words(vw, half_w)
    vw2 = _sub_words(vw, Qw)  # may go negative; tracked in signed words
    vw = np.where(ge[None, :], vw2, vw)
    # fold words into each destination prime
    out = np.zeros((len(dst_primes), n), dtype=np.uint32)
    for d, qd in enumerate(dst_primes):
        pw = np.array(
            [pow(1 << (_WB * k), 1, qd) for k in range(nwords)], dtype=np.int64
        )
        acc = (vw * pw[:, None]) % qd  # numpy's % is floored: signed words land in [0, qd)
        s = np.sum(acc, axis=0) % qd
        out[d] = s.astype(np.uint32)
    return out


def _word_carry(vw: np.ndarray) -> np.ndarray:
    mask = (1 << _WB) - 1
    for k in range(vw.shape[0] - 1):
        c = vw[k] >> _WB
        vw[k] &= mask
        vw[k + 1] += c
    return vw


def _cond_sub_words(vw: np.ndarray, Qw: np.ndarray) -> np.ndarray:
    y = vw - Qw[:, None]
    # exact borrow propagation
    borrow = np.zeros(vw.shape[1], dtype=np.int64)
    out = np.empty_like(y)
    for k in range(vw.shape[0]):
        t = y[k] + borrow
        borrow = t >> _WB
        out[k] = t - (borrow << _WB)
    ge = borrow == 0  # no final borrow -> v >= Q
    return np.where(ge[None, :], out, vw)


def _sub_words(vw: np.ndarray, Qw: np.ndarray) -> np.ndarray:
    y = vw - Qw[:, None]
    borrow = np.zeros(vw.shape[1], dtype=np.int64)
    out = np.empty_like(y)
    for k in range(vw.shape[0]):
        t = y[k] + borrow
        borrow = t >> _WB
        out[k] = t - (borrow << _WB)
    # leave the (negative) top borrow in the top word (signed representation)
    out[-1] += borrow << _WB
    return out


def _ge_words(vw: np.ndarray, bw: np.ndarray) -> np.ndarray:
    y = vw - bw[:, None]
    borrow = np.zeros(vw.shape[1], dtype=np.int64)
    for k in range(vw.shape[0]):
        t = y[k] + borrow
        borrow = t >> _WB
    return borrow == 0


def words_sample_centered(rng, bound_bits: int, n: int):
    """Sample n uniform ints in [-2^(b-1), 2^(b-1)) as word arrays
    [nwords, n] (signed, last word carries the sign after centering)."""
    nwords = (bound_bits + _WB - 1) // _WB
    top_bits = bound_bits - _WB * (nwords - 1)
    w = rng.integers(0, 1 << _WB, size=(nwords, n), dtype=np.int64)
    w[-1] &= (1 << top_bits) - 1
    # subtract 2^(b-1): flip the top bit region
    w[-1] -= 1 << (top_bits - 1)
    return w


def words_mod_prime(w: np.ndarray, q: int) -> np.ndarray:
    """Signed word array [nwords, n] -> residues mod q (uint32)."""
    nwords = w.shape[0]
    pw = np.array([pow(1 << (_WB * k), 1, q) for k in range(nwords)], dtype=np.int64)
    acc = (w * pw[:, None]) % q
    return (np.sum(acc, axis=0) % q).astype(np.uint32)


# ---------------------------------------------------------------------------
# Kernel K6: the device CRT lift of protocol-bounded values

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
CRT_LIFT = CudaKernel("crt_lift", "crt_lift", [_PTR] * 3 + [_INT] * 3 + [ctypes.c_longlong])
CRT_LIFT_MAX_ROWS = 24  # LMAX in csrc/crt_lift.cu
CRT_LIFT_MAX_GROUP = 8  # GMAX in csrc/crt_lift.cu
CRT_LIFT_GROUP = 6  # destination rows a block, at most (the fastest at the PN14 lifts)


def crt_lift_group(D: int) -> int:
    """K6's destination rows a block for D rows: the fewest groups of at
    most CRT_LIFT_GROUP rows, as even as they come."""
    groups = -(-D // CRT_LIFT_GROUP)
    return -(-D // groups)


def _crt_tables(basis: RnsBasis, src_rows, dst_rows, device) -> dict:
    """K6's tables for src -> dst, cached per (rows, device): w = (Q/q_i)^-1
    mod q_i [l], q [l], inv_q = 1/q_i in float32 [l], T = (Q/q_i) mod p_d
    [D, l], negQ = p_d - (Q mod p_d) [D], p [D]; `pack`, the kernel's one
    table (csrc/crt_lift.cu): per source row w, its Shoup quotient
    floor(w 2^32 / q), q and the bits of inv_q, then per destination row
    negQ and its quotient, p, floor(2^32 / p) and each T[d, i] with its
    quotient; and `sum_bound` = 2 (l + 1) max p, the bound of the kernel's
    lazy 32-bit sum."""
    device = torch.device(device)
    key = ("crt", tuple(src_rows), tuple(dst_rows), str(device))
    if key not in basis._cache:
        qs = [int(basis.primes[r]) for r in src_rows]
        ps = [int(basis.primes[r]) for r in dst_rows]
        Q = 1
        for q in qs:
            Q *= q
        w = [pow(Q // q, -1, q) for q in qs]
        inv_q = np.array([1.0 / q for q in qs], np.float32)
        T = [[(Q // q) % p for q in qs] for p in ps]
        negQ = [(p - Q % p) % p for p in ps]
        pack = [[wi, (wi << 32) // q, q, int(b)] for wi, q, b in zip(w, qs, inv_q.view(np.uint32))]
        for p, nq, row in zip(ps, negQ, T):
            pack.append([nq, (nq << 32) // p, p, (1 << 32) // p]
                        + [v for ti in row for v in (ti, (ti << 32) // p)])
        u32 = lambda v: as_i32(np.array(v, dtype=np.uint32)).to(device)  # noqa: E731
        basis._cache[key] = {
            "w": u32(w), "q": u32(qs), "inv_q": torch.from_numpy(inv_q).to(device),
            "T": u32(T), "negQ": u32(negQ), "p": u32(ps),
            "pack": u32([v for row in pack for v in row]),
            "sum_bound": 2 * (len(qs) + 1) * max(ps),
        }
    return basis._cache[key]


def crt_lift_plain(x, t: dict) -> torch.Tensor:
    """Plain version of K6 on x [l, M] with the tables of _crt_tables:
    y = x*w mod q, k = round(sum y * (1/q)) in float32, then
    sum_i y_i*T[d,i] + k*negQ[d] mod p_d, exact in int64."""
    q = t["q"].long()[:, None]
    y = torch.remainder(x.long() * t["w"].long()[:, None], q)  # [l, M]
    k = torch.round(torch.sum(y.float() * t["inv_q"][:, None], dim=0)).long()  # [M]
    acc = (t["T"].long()[:, :, None] * y[None]).sum(1) + t["negQ"].long()[:, None] * k[None]
    return torch.remainder(acc, t["p"].long()[:, None]).to(torch.int32)


def crt_lift(x, t: dict) -> torch.Tensor:
    """Kernel K6 for a CUDA x (the plain version for a CPU x): x [l, M]
    int32 residues -> [D, M] with the tables of _crt_tables, in blocks of
    crt_lift_group(D) destination rows."""
    if x.device.type == "cpu":
        return crt_lift_plain(x, t)
    l, M = x.shape
    D = t["p"].shape[0]
    if not 1 <= l <= CRT_LIFT_MAX_ROWS:
        raise ValueError(f"crt_lift: {l} source rows; the kernel takes 1..{CRT_LIFT_MAX_ROWS}")
    if t["sum_bound"] >= 1 << 32:
        raise ValueError(f"crt_lift: the lazy sum of {l + 1} terms below 2 p reaches "
                         f"{t['sum_bound']} >= 2^32")
    dev = x.device
    check(x, "x", dev)
    check(t["pack"], "pack", dev, (4 * l + D * (4 + 2 * l),))
    out = torch.empty((D, M), dtype=torch.int32, device=dev)
    if M:
        CRT_LIFT.launch(dev, ptr(out), ptr(x), ptr(t["pack"]), l, D, crt_lift_group(D), M)
    return out


def crt_lift_centered_dev(x, basis: RnsBasis, src_rows, dst_rows, plain: bool = False):
    """Centered CRT basis extension of protocol-bounded values on the device
    (counterpart of the reference's crt_lift_centered_dev): x [l, M] residues
    mod the src_rows primes of a centred v with |v| < Q_src/4 -> [len(dst),
    M] residues of the same v mod the dst_rows primes (fast basis extension
    with k rounded in float32, exact for such bounded v).  Kernel K6 unless
    plain=True."""
    t = _crt_tables(basis, src_rows, dst_rows, x.device)
    return crt_lift_plain(x, t) if plain else crt_lift(x.contiguous(), t)
