"""CipherVector / CipherMatrix operations and the Chebyshev evaluators of
the logistic path's sigmoid (counterpart of sfgwas_tpu/crypto/basics.py).

Vectors are row-major chunks of `slots` values, one ciphertext per chunk.
"RotateRight by r" rotates slot contents toward higher indices; a mask
consumes a level; inner_sum_all leaves every slot holding the total.

The batched mask helpers (cmult_pairs, expand_slots_many, mask_scatter_sum,
add_group_mod) carry the CholeskyQR's Gram and recombine passes: stacks of
one-hot mask plaintexts are encoded once and cached on the key bundle, and
each multiply-scatter or multiply-expand runs as one batched call.  The
plaintext products and the segment sum (_segsum_mod) are plain torch with
exact int64 arithmetic (ROADMAP B13, B14).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..mpc.mhe import CryptoParams
from ..ops.rns import add_mod
from ..utils import prof
from . import ckks as C

CipherVector = List[C.Ciphertext]
PlainVector = List[C.Plaintext]
CipherMatrix = List[CipherVector]
PlainMatrix = List[PlainVector]


def num_ct(cps: CryptoParams, n: int) -> int:
    return 1 + (n - 1) // cps.slots


def encode_float_vector(
    cps: CryptoParams, vals, nmod: Optional[int] = None,
    scale: Optional[float] = None,
) -> PlainVector:
    ctx = cps.ctx
    nmod = nmod or ctx.nq
    vals = np.asarray(vals, dtype=np.float64)
    return [
        ctx.encode(vals[s : s + cps.slots], nmod, scale)
        for s in range(0, max(len(vals), 1), cps.slots)
    ]


def encrypt_float_vector(
    cps: CryptoParams, vals, nmod: Optional[int] = None,
    scale: Optional[float] = None,
) -> CipherVector:
    return [
        cps.ctx.encrypt(pt, cps.pk, cps.enc_rng)
        for pt in encode_float_vector(cps, vals, nmod, scale)
    ]


def encode_float_matrix(cps: CryptoParams, mat) -> PlainMatrix:
    return [encode_float_vector(cps, row) for row in np.asarray(mat, np.float64)]


def encrypt_float_matrix(cps: CryptoParams, mat) -> CipherMatrix:
    return [encrypt_float_vector(cps, row) for row in np.asarray(mat, np.float64)]


def encrypt_plain_vector(cps: CryptoParams, pv: PlainVector) -> CipherVector:
    return [cps.ctx.encrypt(pt, cps.pk, cps.enc_rng) for pt in pv]


def encrypt_plain_matrix(cps: CryptoParams, pm: PlainMatrix) -> CipherMatrix:
    return [encrypt_plain_vector(cps, pv) for pv in pm]


def decode_float_vector(cps: CryptoParams, pv: PlainVector) -> np.ndarray:
    return np.concatenate([cps.ctx.decode(pt) for pt in pv])


def czeros(cps: CryptoParams, n_ct: int) -> CipherVector:
    return [cps.ctx.zero_ct() for _ in range(n_ct)]


def czero_mat(cps: CryptoParams, n_ct: int, ncols: int) -> CipherMatrix:
    return [czeros(cps, n_ct) for _ in range(ncols)]


def cadd(cps, X: CipherVector, Y: CipherVector) -> CipherVector:
    return [cps.ctx.add(x, y) for x, y in zip(X, Y)]


def csub(cps, X: CipherVector, Y: CipherVector) -> CipherVector:
    return [cps.ctx.sub(x, y) for x, y in zip(X, Y)]


def cneg(cps, X: CipherVector) -> CipherVector:
    return [cps.ctx.neg(x) for x in X]


def cmult(cps, X: CipherVector, Y: CipherVector) -> CipherVector:
    """Elementwise ct*ct with relinearisation and rescale."""
    return [cps.ctx.rescale(cps.ctx.mul_relin(x, y, cps.rlk)) for x, y in zip(X, Y)]


def cpmult(cps, X: CipherVector, Y: PlainVector) -> CipherVector:
    return [cps.ctx.rescale(cps.ctx.mul_plain(x, y)) for x, y in zip(X, Y)]


def cpadd(cps, X: CipherVector, Y: PlainVector) -> CipherVector:
    return [cps.ctx.add_plain(x, y) for x, y in zip(X, Y)]


def cmult_const(cps, X: CipherVector, c: float, rescale: bool = True) -> CipherVector:
    out = [cps.ctx.mul_const(x, c) for x in X]
    if rescale:
        out = [cps.ctx.rescale(x) for x in out]
    return out


def cmult_const_mat(cps, X: CipherMatrix, c: float, rescale: bool = True) -> CipherMatrix:
    return [cmult_const(cps, row, c, rescale) for row in X]


def cadd_const(cps, X: CipherVector, c: float) -> CipherVector:
    return [cps.ctx.add_const(x, c) for x in X]


def cmult_scalar(cps, X: CipherVector, ct: C.Ciphertext) -> CipherVector:
    """Each chunk times one ciphertext (whose slots typically all hold the
    same value)."""
    return [cps.ctx.rescale(cps.ctx.mul_relin(x, ct, cps.rlk)) for x in X]


def rotate_left(cps, ct: C.Ciphertext, k: int) -> C.Ciphertext:
    return cps.rotate(ct, k % cps.slots)


def rotate_right(cps, ct: C.Ciphertext, k: int) -> C.Ciphertext:
    k = k % cps.slots
    if k == 0:
        return ct.copy()
    return cps.rotate(ct, cps.slots - k)


def rotate_and_add(cps, ct: C.Ciphertext, size: int) -> C.Ciphertext:
    """Log-rotation accumulate, clamped into the rotation-key band first
    (level drops are value-lossless)."""
    with prof.span("rot_add"):
        out = cps.clamp_rot(ct)
        rot = 1
        while rot < size:
            out = cps.ctx.add(out, rotate_left(cps, out, rot))
            rot *= 2
    return out


def inner_sum_all(cps, X: CipherVector) -> C.Ciphertext:
    acc = X[0]
    for x in X[1:]:
        acc = cps.ctx.add(acc, x)
    return rotate_and_add(cps, acc, cps.slots)


def inner_prod(cps, X: CipherVector, Y: CipherVector) -> C.Ciphertext:
    return inner_sum_all(cps, cmult(cps, X, Y))


def _rescale_products(cps, prods) -> list:
    """One batched double rescale of same-level products."""
    ctx = cps.ctx
    nmod = prods[0].nmod
    stack = torch.cat([torch.stack([p.c0 for p in prods]), torch.stack([p.c1 for p in prods])])
    res = ctx.rescale2_many(stack, nmod - 1)
    Bn = len(prods)
    pair = ctx.basis.primes[nmod - 1], ctx.basis.primes[nmod - 2]
    return [
        C.Ciphertext(res[j], res[Bn + j], nmod - 2, p.scale / pair[0] / pair[1])
        for j, p in enumerate(prods)
    ]


def cmult_one_to_many(cps, x: C.Ciphertext, ys) -> list:
    """x * y_j with rescale for same-level ciphertexts: one batched
    relinearisation and one batched rescale."""
    return _rescale_products(cps, cps.ctx.mul_relin_many(x, ys, cps.rlk))


def rotate_and_add_many(cps, cts, size: int) -> list:
    """rotate_and_add over a list of ciphertexts with shared shifts: each
    log-step rotates the whole stack through one grouped keyswitch."""
    ctx = cps.ctx
    cts = [cps.clamp_rot(ct) for ct in cts]
    nmod = min(ct.nmod for ct in cts)
    cts = [ctx.drop_to(ct, nmod) for ct in cts]
    C0 = torch.stack([ct.c0 for ct in cts])[None]  # [1, B, nmod, N]
    C1 = torch.stack([ct.c1 for ct in cts])[None]
    q = ctx._t(range(nmod))["q"]
    rot = 1
    while rot < size:
        g = ctx.galois_for_rotation(rot % cps.slots)
        ik0, ik1 = cps.stacked_keys_inv([g], nmod)
        r0, r1 = ctx.rotate_grouped_b(C0, C1, ctx.perms_for([g]), ik0, ik1, nmod)
        C0 = add_mod(C0, r0, q)
        C1 = add_mod(C1, r1, q)
        rot *= 2
    return [C.Ciphertext(C0[0, b], C1[0, b], nmod, ct.scale) for b, ct in enumerate(cts)]


def sq_sum(cps, X: CipherVector) -> C.Ciphertext:
    return inner_prod(cps, X, X)


def cmult_pairs(cps, xs, ys) -> list:
    """x_e * y_e with rescale over two equal-length ciphertext lists at a
    common level: one batched relinearisation and one batched rescale for
    all pairs."""
    return _rescale_products(cps, cps.ctx.mul_relin_pairs(xs, ys, cps.rlk))


# ---------------------------------------------------------------------------
# batched mask helpers


def _encoded_mask_stack(cps, key, build_masks, nmod: int):
    """[B, nmod, N] NTT-domain stack of mask plaintexts at the preset scale,
    cached on the key bundle by (key, nmod)."""
    ck = (key, nmod)
    hit = cps._masks.get(ck)
    if hit is not None:
        return hit
    ctx = cps.ctx
    masks = build_masks()  # [B, slots] float rows
    polys = np.stack([ctx.encoder.encode(m, ctx.params.scale, nmod) for m in masks])
    stack = ctx._ntt_b(ctx.to_dev(polys).transpose(0, 1), range(nmod)).transpose(0, 1)
    cps._masks[ck] = stack
    return stack


def mask_scatter_sum(cps, cts, slot_lists, nct_out: int, value: float = 1.0, cache_key=None):
    """sum_e mask(cts[e], slot_lists[e], value) packed into nct_out output
    ciphertexts: each input (its value replicated across slots) lands at the
    given global slot indices (in [0, nct_out * slots)).  One batched
    multiply-sum per output ciphertext.

    Input scales may differ by a drift of a few permille (no bootstrap reset
    at the top of the chain); each input's ratio to the largest scale folds
    into its mask value, so the masked integers all sit at that scale."""
    assert len(cts) == len(slot_lists)
    ctx = cps.ctx
    slots = cps.slots
    nmod = min(ct.nmod for ct in cts)
    cts = [ctx.drop_to(ct, nmod) for ct in cts]
    scale0 = max(ct.scale for ct in cts)
    ratios = []
    for ct in cts:
        r = scale0 / ct.scale
        # drift-sized only: a bigger spread means an unreset chain upstream
        assert 1.0 <= r < 1.25, (ct.scale, scale0)
        ratios.append(r)
    drift_key = tuple(round(r, 12) for r in ratios)
    c0s = torch.stack([ct.c0 for ct in cts])
    c1s = torch.stack([ct.c1 for ct in cts])
    out_scale = (
        scale0 * ctx.params.scale / ctx.basis.primes[nmod - 1] / ctx.basis.primes[nmod - 2]
    )
    out = []
    for o in range(nct_out):
        if cache_key is not None:
            kk = ("scatter", cache_key, o, value, drift_key)
        else:
            kk = ("scatter_sl", tuple(tuple(sl) for sl in slot_lists), o, value, drift_key)

        def build(o=o):
            m = np.zeros((len(cts), slots))
            for e, sl in enumerate(slot_lists):
                for g in sl:
                    if g // slots == o:
                        m[e, g % slots] = value * ratios[e]
            return m

        pts = _encoded_mask_stack(cps, kk, build, nmod)
        s0, s1 = ctx.mul_plain_pairs_sum(c0s, c1s, pts, nmod)
        r0, r1 = ctx._rescale2_pair(s0, s1, nmod - 1)
        out.append(C.Ciphertext(r0, r1, nmod - 2, out_scale))
    return out


def add_group_mod(cps, cts, groups, ngroups: int, out_scale=None) -> list:
    """Segment-sum same-level ciphertexts into ngroups outputs (groups[e] =
    output index of cts[e]) in one call.  Scales must match exactly unless
    the caller folded the drift into the integers and passes the common
    scale as out_scale."""
    assert len(cts) == len(groups)
    ctx = cps.ctx
    nmod = min(ct.nmod for ct in cts)
    cts = [ctx.drop_to(ct, nmod) for ct in cts]
    if out_scale is None:
        scale0 = cts[0].scale
        for ct in cts[1:]:
            assert abs(ct.scale / scale0 - 1) < 1e-9, (ct.scale, scale0)
    else:
        scale0 = out_scale
        for ct in cts:
            assert abs(ct.scale / scale0 - 1) < 0.1, (ct.scale, scale0)
    counts = np.bincount(np.asarray(groups), minlength=ngroups)
    assert counts.max() < 64, counts.max()
    q = ctx._t(range(nmod))["q"]
    seg = torch.tensor(np.asarray(groups, np.int64), device=ctx.device)
    c0s, c1s = _segsum_mod(
        torch.stack([ct.c0 for ct in cts]), torch.stack([ct.c1 for ct in cts]), seg, q, ngroups
    )
    return [C.Ciphertext(c0s[g], c1s[g], nmod, scale0) for g in range(ngroups)]


def _segsum_mod(c0s, c1s, seg, q, ngroups: int):
    """Segment sums of [E, nmod, N] residues by seg [E] into [ngroups,
    nmod, N], exact in int64, then one remainder (ROADMAP B14)."""

    def segsum(c):
        acc = torch.zeros((ngroups,) + tuple(c.shape[1:]), dtype=torch.int64, device=c.device)
        acc.index_add_(0, seg, c.long())
        return torch.remainder(acc, q.long()).to(torch.int32)

    return segsum(c0s), segsum(c1s)


def expand_slots_many(cps, ct: C.Ciphertext, indices, cache_key=None, value_scales=None) -> list:
    """For each slot index e: extract ct[indices[e]] and replicate it across
    all slots.  One batched one-hot multiply and one shared rotation ladder
    (log2(slots) grouped keyswitches for the whole batch).

    value_scales[e] (optional) multiplies entry e's one-hot value: a later
    product with a ciphertext whose scale sits value_scales[e] below a
    reference then lands exactly on the reference scale."""
    ctx = cps.ctx
    slots = cps.slots
    nmod = ct.nmod
    indices = [int(i) for i in indices]
    vs = [1.0] * len(indices) if value_scales is None else [float(v) for v in value_scales]

    def build():
        m = np.zeros((len(indices), slots))
        for e, idx in enumerate(indices):
            m[e, idx] = vs[e]
        return m

    vs_key = tuple(round(v, 12) for v in vs)
    if cache_key is not None:
        kk = ("expand", cache_key, vs_key)
    else:
        kk = ("expand_idx", tuple(indices), vs_key)
    pts = _encoded_mask_stack(cps, kk, build, nmod)
    p0, p1 = ctx.mul_plain_many_b(ct.c0, ct.c1, pts, nmod)
    res = ctx.rescale2_many(torch.cat([p0, p1]), nmod - 1)
    E = len(indices)
    out_scale = (
        ct.scale * ctx.params.scale / ctx.basis.primes[nmod - 1] / ctx.basis.primes[nmod - 2]
    )
    masked = [C.Ciphertext(res[e], res[E + e], nmod - 2, out_scale) for e in range(E)]
    return rotate_and_add_many(cps, masked, slots)


def _mask_pt(cps, idx_mask: np.ndarray, nmod: int) -> C.Plaintext:
    return cps.ctx.encode(idx_mask, nmod)


def mask(cps, ct: C.Ciphertext, index: int, keep_rest: bool, value: float = 1.0):
    """Zero out all but slot `index` (keep_rest=False) or only slot `index`
    (True); consumes one level.  `value` folds a scalar constant into the
    mask plaintext."""
    if ct is None:
        return None
    m = np.zeros(cps.slots)
    if keep_rest:
        m[:] = value
        m[index] = 0.0
    else:
        m[index] = value
    return cps.ctx.rescale(cps.ctx.mul_plain(ct, _mask_pt(cps, m, ct.nmod)))


def ones_rescale(cps, ct: C.Ciphertext) -> C.Ciphertext:
    """Multiply by the all-ones plaintext and rescale: a no-op on the values
    that spends exactly one level, so parties that do not mask keep the
    levels and scales of those that do."""
    m = np.ones(cps.slots)
    return cps.ctx.rescale(cps.ctx.mul_plain(ct, _mask_pt(cps, m, ct.nmod)))


def mask_trunc(
    cps,
    ct: C.Ciphertext,
    n_keep: int,
    scale_const: float = 1.0,
    target_scale: Optional[float] = None,
) -> C.Ciphertext:
    """Keep the first n_keep slots, optionally folding a scalar constant
    into the mask plaintext.

    target_scale: an exact output-scale retarget at no extra level: the
    drift ratio folds into the mask values and the result is declared at
    target_scale."""
    if n_keep == cps.slots and scale_const == 1.0 and target_scale is None:
        return ct
    ctx = cps.ctx
    nmod = ct.nmod
    natural = ct.scale * ctx.params.scale / ctx.basis.primes[nmod - 1] / ctx.basis.primes[nmod - 2]
    gamma = 1.0 if target_scale is None else target_scale / natural
    assert 0.5 < gamma < 2.0, (gamma, ct.scale, target_scale)
    m = np.zeros(cps.slots)
    m[:n_keep] = scale_const * gamma
    out = ctx.rescale(ctx.mul_plain(ct, _mask_pt(cps, m, nmod)))
    if target_scale is not None:
        out = C.Ciphertext(out.c0, out.c1, out.nmod, target_scale)
    return out


def cmult_with_const(cps, X: CipherVector, Y: CipherVector, c: float) -> CipherVector:
    """(x * y) * c spending two levels in all (the constant multiplies
    before the two rescales)."""
    out = []
    for x, y in zip(X, Y):
        t = cps.ctx.mul_const(cps.ctx.mul_relin(x, y, cps.rlk), c)
        out.append(cps.ctx.rescale(cps.ctx.rescale(t)))
    return out


def rebalance(cps, ct: C.Ciphertext) -> Optional[C.Ciphertext]:
    """Every slot <- the mean of the slots."""
    if ct is None:
        return None
    out = rotate_and_add(cps, ct, cps.slots)
    return cps.ctx.rescale(cps.ctx.mul_const(out, 1.0 / cps.slots))


def flatten_levels(cps, X: CipherMatrix):
    """Drop every ciphertext to the lowest level of the matrix."""
    nmod = min(ct.nmod for row in X for ct in row)
    return [[cps.ctx.drop_to(ct, nmod) for ct in row] for row in X], nmod


def flatten_levels_vec(cps, X: CipherVector):
    nmod = min(ct.nmod for ct in X)
    return [cps.ctx.drop_to(ct, nmod) for ct in X], nmod


def drop_level(cps, X: CipherMatrix, nmod: int) -> CipherMatrix:
    return [[cps.ctx.drop_to(ct, min(nmod, ct.nmod)) for ct in row] for row in X]


def concat_cipher_matrix(mats: List[CipherMatrix]) -> CipherMatrix:
    """Concatenate along the ciphertext axis."""
    mats = [m for m in mats if m]
    if not mats:
        return []
    out = []
    for c in range(len(mats[0])):
        row: CipherVector = []
        for m in mats:
            row.extend(m[c])
        out.append(row)
    return out


def global_to_party_index(cps, nrows_all: List[int], col: int, nparty: int):
    """A global row index over party-partitioned rows -> (party, ciphertext
    index, slot index)."""
    acc = 0
    for p in range(1, nparty):
        if col < acc + nrows_all[p]:
            local = col - acc
            return p, local // cps.slots, local % cps.slots
        acc += nrows_all[p]
    raise IndexError(col)


def copy_vec(X: CipherVector) -> CipherVector:
    return [ct.copy() for ct in X]


def copy_mat(X: CipherMatrix) -> CipherMatrix:
    return [[ct.copy() for ct in row] for row in X]


# ---------------------------------------------------------------------------
# Chebyshev approximation (the Go sfgwas's crypto/basics.go:613-646, used by
# the logistic path's sigmoid, mpc/mhe.go:608-677)


def chebyshev_coeffs(fn, a: float, b: float, degree: int) -> np.ndarray:
    """Chebyshev interpolation coefficients of fn on [a, b]."""
    k = degree + 1
    nodes = np.cos(np.pi * (np.arange(k) + 0.5) / k)
    x = 0.5 * (b - a) * nodes + 0.5 * (a + b)
    y = np.array([fn(v) for v in x])
    coeffs = np.zeros(k)
    for j in range(k):
        coeffs[j] = (2.0 / k) * np.sum(y * np.cos(np.pi * j * (np.arange(k) + 0.5) / k))
    coeffs[0] /= 2.0
    return coeffs


def evaluate_chebyshev(cps, ct: C.Ciphertext, coeffs: np.ndarray, a: float, b: float):
    """sum_j c_j T_j(y) with y = (2x - a - b)/(b - a), through the linear T
    recurrence (depth ~degree: moderate degrees on a deep preset)."""
    ctx = cps.ctx
    y = ctx.rescale(ctx.mul_const(ct, 2.0 / (b - a)))
    y = ctx.add_const(y, (-a - b) / (b - a))
    # T0 = 1 is the constant term, T1 = y
    acc = ctx.rescale(ctx.mul_const(y, float(coeffs[1])))
    acc = ctx.add_const(acc, float(coeffs[0]))
    t_prev = None
    t_cur = y
    for j in range(2, len(coeffs)):
        if t_prev is None:
            # T2 = 2y^2 - 1
            t_next = ctx.rescale(ctx.mul_relin(y, y, cps.rlk))
            t_next = ctx.add_const(ctx.rescale(ctx.mul_const(t_next, 2.0)), -1.0)
        else:
            ty = ctx.rescale(ctx.mul_relin(t_cur, y, cps.rlk))
            t_next = ctx.sub(ctx.rescale(ctx.mul_const(ty, 2.0)), _align(ctx, t_prev, ty))
        if abs(coeffs[j]) > 1e-12:
            term = ctx.rescale(ctx.mul_const(t_next, float(coeffs[j])))
            acc = ctx.add(_align(ctx, acc, term), _align(ctx, term, acc))
        t_prev, t_cur = t_cur, t_next
    return acc


def _align(ctx, x: C.Ciphertext, ref: C.Ciphertext) -> C.Ciphertext:
    return ctx.drop_to(x, ref.nmod) if x.nmod > ref.nmod else x


def _ensure(net, cps, bootstrap_fn):
    """The refresh rule of both recurrences: one step spends up to 3 prime
    pairs off a T value (the product, the 2x, the coefficient), so a value
    with fewer than 3 mult levels left is refreshed first."""
    low = min(cps.ctx.nq, cps.ctx.params.base_nmod + 6)

    def ensure(x):
        return bootstrap_fn(net, cps, x, -1) if x.nmod < low else x

    return ensure


def evaluate_chebyshev_interactive(net, cps, cv, coeffs, a, b, bootstrap_fn):
    """The T recurrence over a CipherVector, refreshing (bootstrap_fn(net,
    cps, ct, -1)) during the recurrence whenever a value runs low."""
    return [_cheby_one(net, cps, ct, coeffs, a, b, bootstrap_fn) for ct in cv]


def _cheby_one(net, cps, ct, coeffs, a, b, bootstrap_fn):
    ctx = cps.ctx
    ensure = _ensure(net, cps, bootstrap_fn)
    # every T_k and every coefficient term lands exactly at the preset scale
    # (mul_const_to), so the accumulation and the recurrence's subtraction
    # stay scale-matched across refreshes
    tgt = ctx.params.scale
    ct = ensure(ct)
    y = ctx.rescale(ctx.mul_const_to(ct, 2.0 / (b - a), tgt))
    y = ctx.add_const(y, (-a - b) / (b - a))
    acc = ctx.rescale(ctx.mul_const_to(y, float(coeffs[1]), tgt))
    acc = ctx.add_const(acc, float(coeffs[0]))
    t_prev = None
    t_cur = y
    for j in range(2, len(coeffs)):
        y = ensure(y)
        t_cur = ensure(t_cur)
        if t_prev is None:
            t_next = ctx.rescale(ctx.mul_relin(y, y, cps.rlk))
            t_next = ctx.add_const(ctx.rescale(ctx.mul_const_to(t_next, 2.0, tgt)), -1.0)
        else:
            ty = ctx.rescale(ctx.mul_relin(t_cur, y, cps.rlk))
            ty2 = ctx.rescale(ctx.mul_const_to(ty, 2.0, tgt))
            t_next = ctx.sub(ty2, ctx.drop_to(ensure(t_prev), ty2.nmod))
        if abs(float(coeffs[j])) > 1e-12:
            term = ctx.rescale(ctx.mul_const_to(t_next, float(coeffs[j]), tgt))
            acc = ensure(acc)
            nm = min(acc.nmod, term.nmod)
            acc = ctx.add(ctx.drop_to(acc, nm), ctx.drop_to(term, nm))
        t_prev, t_cur = t_cur, t_next
    return acc


def evaluate_chebyshev_bsgs(net, cps, cv, coeffs, a, b, bootstrap_fn):
    """Baby-step giant-step Chebyshev evaluation of a CipherVector, depth
    ~log2(degree) (the Go sfgwas evaluates its degree-62 sigmoid this way,
    mpc/mhe.go:617-673, lattigo's EvaluateCheby); bootstrap_fn refreshes a
    basis value or a partial sum that runs low.

    Every basis element T_k lands exactly at the preset scale (mul_const_to
    on the recurrence's 2x), and the recursion threads a target scale
    down: a remainder is computed at the scale its quotient-times-giant
    product reached, so every homomorphic add is scale-exact."""
    return [
        _cheby_bsgs_one(net, cps, ct, np.asarray(coeffs, float), a, b, bootstrap_fn)
        for ct in cv
    ]


def _cheby_bsgs_one(net, cps, ct, coeffs, a, b, bootstrap_fn):
    ctx = cps.ctx
    tgt = ctx.params.scale
    ensure = _ensure(net, cps, bootstrap_fn)

    deg = len(coeffs) - 1
    while deg > 0 and abs(coeffs[deg]) < 1e-12:
        deg -= 1
    coeffs = coeffs[: deg + 1]

    # y = (2x - a - b)/(b - a), exactly at tgt
    ct = ensure(ct)
    y = ctx.rescale(ctx.mul_const_to(ct, 2.0 / (b - a), tgt))
    y = ctx.add_const(y, (-a - b) / (b - a))

    if deg == 0:
        z = ctx.zero_ct(y.nmod)
        return ctx.add_const(C.Ciphertext(z.c0, z.c1, y.nmod, y.scale), float(coeffs[0]))

    # the basis: T_k in depth log2(k) by T_{i+j} = 2 T_i T_j - T_{|i-j|}
    T = {1: y}

    def get_t(k: int):
        if k in T:
            return T[k]
        i, j = k // 2, k - k // 2
        ti = ensure(get_t(i))
        tj = ti if i == j else ensure(get_t(j))
        prod = ctx.rescale(ctx.mul_relin(ti, tj, cps.rlk))
        prod2 = ctx.rescale(ctx.mul_const_to(prod, 2.0, tgt))
        if i == j:
            res = ctx.add_const(prod2, -1.0)  # T_0 = 1
        else:
            td = ensure(get_t(j - i))
            nm = min(prod2.nmod, td.nmod)
            res = ctx.sub(ctx.drop_to(prod2, nm), ctx.drop_to(td, nm))
        T[k] = res
        return res

    m = max(1, math.ceil(math.log2(deg + 1)))
    # the baby set T_0..T_{nb-1}; nb >= 2 so that a split never picks p = 0
    nb = max(2, 1 << (m // 2))

    def rec(c: np.ndarray, tscale: float):
        """sum c_j T_j as a ciphertext at exactly tscale, or ("const", v)
        for a constant polynomial."""
        d = len(c) - 1
        while d > 0 and abs(c[d]) < 1e-12:
            d -= 1
        c = c[: d + 1]
        if d == 0:
            return ("const", float(c[0]))
        if d < nb:
            acc = None
            for j in range(d, 0, -1):
                if abs(c[j]) < 1e-12:
                    continue
                term = ctx.rescale(ctx.mul_const_to(ensure(get_t(j)), float(c[j]), tscale))
                if acc is None:
                    acc = term
                else:
                    nm = min(acc.nmod, term.nmod)
                    acc = ctx.add(ctx.drop_to(acc, nm), ctx.drop_to(term, nm))
            return ctx.add_const(acc, float(c[0]))
        # split at the largest power of two p <= d (p < d):
        # sum_{j>=p} c_j T_j = T_p (c_p + sum_{j>p} 2 c_j T_{j-p}) - sum_{j>p} c_j T_{2p-j}
        p = 1 << (d.bit_length() - 1)
        if p == d:
            p >>= 1
        q = np.zeros(d - p + 1)
        q[0] = c[p]
        q[1 : d - p + 1] = 2.0 * c[p + 1 : d + 1]
        r = np.zeros(p)
        r[:p] = c[:p]
        for j in range(p + 1, d + 1):
            r[2 * p - j] -= c[j]
        qc = rec(q, tgt)
        tp = ensure(get_t(p))
        if isinstance(qc, tuple):
            prod = ctx.rescale(ctx.mul_const_to(tp, qc[1], tscale))
        else:
            nm = min(qc.nmod, tp.nmod)
            prod = ctx.rescale(ctx.mul_relin(ctx.drop_to(qc, nm), ctx.drop_to(tp, nm), cps.rlk))
        prod = ensure(prod)
        # the remainder lands at the scale the product reached
        rc = rec(r, prod.scale)
        if isinstance(rc, tuple):
            return ctx.add_const(prod, rc[1])
        rc = ensure(rc)
        if abs(rc.scale / prod.scale - 1.0) > 1e-9:
            # a nested split returns at its own product's scale: steer it
            # to prod's exactly (x1.0 at the compensating scale)
            rc = ensure(ctx.rescale(ctx.mul_const_to(rc, 1.0, prod.scale)))
        nm = min(prod.nmod, rc.nmod)
        return ctx.add(ctx.drop_to(prod, nm), ctx.drop_to(rc, nm))

    out = rec(coeffs, tgt)
    if isinstance(out, tuple):  # a constant polynomial
        z = ctx.zero_ct(y.nmod)
        return ctx.add_const(C.Ciphertext(z.c0, z.c1, y.nmod, y.scale), out[1])
    return out
