"""Core MPC engine: additive secret sharing over a prime field with a
PRG-based online dealer (party 0) (counterpart of sfgwas_tpu/mpc/mpc.py).

Shares are int32 digit arrays ([n, nlimb], ops/ring.py), in host numpy or
as torch tensors on a device.  For a ring in device mode (ring.host False)
the data parties' Beaver masks are staged on the device of the shares they
mask, so every product, reveal sum and truncation of tensor shares runs
there, and only the exchanged messages cross to the host.  All elementwise
protocol math is vectorized over the data axis.  The structure follows
the Go sfgwas' mpc/mpc.go, beavermult.go and ss.go:
  * BeaverPartition / BeaverMult / BeaverReconstruct with an online dealer
    deriving masks from pairwise PRGs -- no precomputed triples;
  * probabilistic truncation after fixed-point multiplies (TruncMat);
  * secret powers + Lagrange-interpolated table lookups;
  * PrefixOr / FanInOr bit-decomposition ladder over a small prime field for
    the non-binary comparison path;
  * IsPositive / LessThan family;
  * Newton sqrt/inverse-sqrt and division with NormalizerEvenExp range
    reduction.

The binary-share (power-of-two ring + GF(2)) comparison path lives in
boolean.py and is selected by `boolean_shares=True` (the default, config
mpc_boolean_shares).  Every share, PRG draw and message matches the
reference's at equal PRG keys.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import ring as R
from ..parallel.transport import Network
from ..utils import prof
from ..utils.log import log
from .prg import Random


_np = R.to_host


def _staged(ring, mask, *shares):
    """A host draw masking one of `shares` (the operands of one product):
    on their device in device mode, else as it is."""
    dev = R._dev(*shares)
    return mask if ring.host or dev is None else R.to_device(mask, dev)


def _cat(xs):
    """Concatenation along the first axis that keeps tensors on their device."""
    dev = R._dev(*xs)
    if dev is not None:
        return torch.cat([R.to_device(x, dev) for x in xs])
    return np.concatenate(xs)


class MPC:
    def __init__(
        self,
        net: Network,
        ring: R.Ring,
        data_bits: int,
        frac_bits: int,
        boolean_shares: bool = True,
        div_sqrt_max_len: int = 1_000_000,
    ):
        self.net = net
        self.ring = ring
        self.data_bits = data_bits
        self.frac_bits = frac_bits
        self.boolean_shares = boolean_shares
        self.div_sqrt_max_len = div_sqrt_max_len
        self.pid = net.pid
        self.nparty = net.nparty
        self.hub_pid = net.hub_pid
        self.rand: Random = net.rand
        self.sync_counter = 0
        self._lagrange_cache = {}
        self._or_lagrange_cache = {}
        self.sbit = R.SElem  # small field for bit shares (SElemC/SElemDS)

    # ------------------------------------------------------------------ util

    def is_dealer(self) -> bool:
        return self.pid == 0

    def _shape(self, ring, x):
        return x.shape[:-1] if ring.has_limbs else x.shape

    def zeros_like_shape(self, ring, shape):
        return ring.zeros(shape)

    def assert_sync(self):
        """Counter + PRG-draw equality check (mpc/mpc.go:129-173)."""
        check = self.sync_counter
        if self.pid == self.hub_pid:
            for other in range(self.nparty):
                if other == self.pid:
                    continue
                got = self.net.recv_int(other)
                if got != check:
                    raise RuntimeError(f"AssertSync counter mismatch with {other}")
        else:
            self.net.send_int(check, self.hub_pid)
        for other in range(self.nparty):
            if other == self.pid:
                continue
            with self.rand.using(other) as g:
                r_check = int(g.integers(0, 1 << 62))
            got = self.net.exchange(r_check, other)
            if got != r_check:
                raise RuntimeError(f"AssertSync PRG mismatch with {other}")
        self.sync_counter += 1

    # -------------------------------------------------------------- reveal

    def reveal_sym(self, a, ring=None):
        """Symmetric reveal among data parties (mpc/mpc.go:374-424).
        Party 0 returns its input unchanged."""
        ring = ring or self.ring
        if self.pid == 0:
            return a
        out = a
        a_host = _np(a)
        for p in range(1, self.nparty):
            if p == self.pid:
                continue
            got = self.net.exchange(a_host, p)
            out = ring.add(out, got)
        return out

    # -------------------------------------------------------------- beaver

    def beaver_partition(self, a, ring=None):
        """Returns (ar, am): a = ar + am with ar public among data parties,
        am PRG-shared with the dealer knowing the sum (mpc/beavermult.go:18)."""
        ring = ring or self.ring
        shape = self._shape(ring, a)
        if self.pid == 0:
            am = ring.zeros(shape)
            for p in range(1, self.nparty):
                with self.rand.using(p) as _:
                    mask = ring.rand(self.rand.cur(), shape)
                am = ring.add(am, mask)
            return ring.zeros(shape), am
        with self.rand.using(0) as _:
            mask = _staged(ring, ring.rand(self.rand.cur(), shape), a)
        ar = ring.sub(a, mask)
        ar = self.reveal_sym(ar, ring)
        return ar, mask

    def beaver_partition_many(self, xs, ring=None):
        """Partition several tensors with ONE symmetric reveal round (the
        two-operand multiply previously paid one round per operand).  PRG
        draw order matches per-tensor partitioning, so dealer/party streams
        stay in lockstep with the single-tensor path's conventions."""
        ring = ring or self.ring
        shapes = [self._shape(ring, x) for x in xs]
        if self.pid == 0:
            ams = []
            for shape in shapes:
                am = ring.zeros(shape)
                for p in range(1, self.nparty):
                    with self.rand.using(p) as _:
                        mask = ring.rand(self.rand.cur(), shape)
                    am = ring.add(am, mask)
                ams.append(am)
            return [ring.zeros(s) for s in shapes], ams
        masks, ars = [], []
        for x, shape in zip(xs, shapes):
            with self.rand.using(0) as _:
                mask = _staged(ring, ring.rand(self.rand.cur(), shape), *xs)
            masks.append(mask)
            ars.append(ring.sub(x, mask))
        # reveal is elementwise: flatten (keeping the limb axis for digit
        # rings -- their add propagates carries within the last axis), one
        # exchange, split back
        L = getattr(ring, "nlimb", None)
        full_shapes = [tuple(a.shape) for a in ars]
        if L is not None:
            flat = _cat([a.reshape((-1, L)) for a in ars])
        else:
            flat = _cat([a.reshape((-1,)) for a in ars])
        flat = self.reveal_sym(flat, ring)
        out, ofs = [], 0
        for fs in full_shapes:
            cnt = int(math.prod(fs[:-1] if L is not None else fs))
            out.append(flat[ofs : ofs + cnt].reshape(fs))
            ofs += cnt
        return out, masks

    def beaver_reconstruct(self, a, ring=None):
        """Dealer re-shares its term to the data parties
        (mpc/beavermult.go:57-92)."""
        ring = ring or self.ring
        shape = self._shape(ring, a)
        last = self.nparty - 1
        if self.pid == 0:
            mask = a
            for to in range(1, self.nparty - 1):
                with self.rand.using(to) as _:
                    share = ring.rand(self.rand.cur(), shape)
                mask = ring.sub(mask, share)
            self.net.send(_np(mask), last)
            return mask
        if self.pid == last:
            mask = self.net.recv(0)
        else:
            with self.rand.using(0) as _:
                mask = ring.rand(self.rand.cur(), shape)
        return ring.add(a, mask)

    def beaver_mult_elem(self, ar, am, br, bm, ring=None):
        ring = ring or self.ring
        if self.pid == 0:
            return ring.mul(am, bm)
        out = ring.add(ring.mul(ar, bm), ring.mul(br, am))
        if self.pid == 1:
            out = ring.add(out, ring.mul(ar, br))
        return out

    def beaver_mult_mat(self, ar, am, br, bm, ring=None):
        """[r,k] x [k,c] matrix product of beaver-partitioned matrices."""
        ring = ring or self.ring
        if self.pid == 0:
            return ring.matmul(am, bm)
        out = ring.add(ring.matmul(ar, bm), ring.matmul(am, br))
        if self.pid == 1:
            out = ring.add(out, ring.matmul(ar, br))
        return out

    # fused wrappers (mpc/ss.go:21-56)

    def ss_mult_elem(self, a, b, ring=None):
        ring = ring or self.ring
        (ar, br), (am, bm) = self.beaver_partition_many([a, b], ring)
        return self.beaver_reconstruct(
            self.beaver_mult_elem(ar, am, br, bm, ring), ring
        )

    def ss_square_elem(self, a, ring=None):
        ring = ring or self.ring
        ar, am = self.beaver_partition(a, ring)
        return self.beaver_reconstruct(
            self.beaver_mult_elem(ar, am, ar, am, ring), ring
        )

    def ss_mult_mat(self, a, b, ring=None):
        ring = ring or self.ring
        (ar, br), (am, bm) = self.beaver_partition_many([a, b], ring)
        return self.beaver_reconstruct(self.beaver_mult_mat(ar, am, br, bm, ring), ring)

    # --------------------------------------------------------------- trunc

    def trunc(self, a, k: Optional[int] = None, m: Optional[int] = None):
        """Probabilistic fixed-point truncation by m bits
        (mpc/mpc.go:1921-1988)."""
        ring = self.ring
        k = self.data_bits if k is None else k
        m = self.frac_bits if m is None else m
        shape = self._shape(ring, a)
        last = self.nparty - 1
        if self.pid == 0:
            r = ring.rand_bits(self.rand.cur(), shape, 8 * ring.nlimb - 2)
            # note: dealer's own (local) stream; value never leaves party 0
            r_low = ring.trunc_low(r, m)
            r_sh, rl_sh = r, r_low
            for p in range(1, self.nparty - 1):
                with self.rand.using(p) as g:
                    mask = ring.rand(g, shape)
                    mask_low = ring.rand(g, shape)
                r_sh = ring.sub(r_sh, mask)
                rl_sh = ring.sub(rl_sh, mask_low)
            self.net.send(np.stack([_np(r_sh), _np(rl_sh)]), last)
            r_share, rl_share = None, None
        elif self.pid == last:
            both = self.net.recv(0)
            r_share, rl_share = np.asarray(both[0]), np.asarray(both[1])
        else:
            with self.rand.using(0) as g:
                r_share = ring.rand(g, shape)
                rl_share = ring.rand(g, shape)

        if self.pid == 0:
            return ring.zeros(shape)
        c = self.reveal_sym(ring.add(a, r_share))
        c_low = ring.trunc_low(c, m)
        out = ring.add(a, rl_share)
        if self.pid == 1:
            out = ring.sub(out, c_low)
        return ring.mul(out, np.broadcast_to(ring.inv_pow2_np(m), out.shape))

    # ------------------------------------------------- powers / polynomials

    def powers(self, a, pow_: int):
        """[pow+1, n] matrix of powers of a (mpc/mpc.go:427-524)."""
        ring = self.ring
        n = self._shape(ring, a)[0]
        pid = self.pid
        if pow_ == 1:
            b = ring.zeros((2, n))
            if pid > 0:
                if pid == 1:
                    b = _assign(ring, b, 0, ring.ones((n,)))
                b = _assign(ring, b, 1, a)
            return b

        ar, am = self.beaver_partition(a)
        last = self.nparty - 1
        if pid == 0:
            ampow = [ring.mul(am, am)]
            for p in range(1, pow_ - 1):
                ampow.append(ring.mul(ampow[-1], am))
            ampow = np.stack(ampow)
            for p in range(1, self.nparty - 1):
                with self.rand.using(p) as g:
                    share = ring.rand(g, (pow_ - 1, n))
                ampow = ring.sub(ampow, share)
            self.net.send(_np(ampow), last)
            return ring.zeros((pow_ + 1, n))
        if pid == last:
            ampow = np.asarray(self.net.recv(0))
        else:
            with self.rand.using(0) as g:
                ampow = ring.rand(g, (pow_ - 1, n))

        arpow = [ring.mul(ar, ar)]
        for p in range(1, pow_ - 1):
            arpow.append(ring.mul(arpow[-1], ar))

        # Pascal-matrix binomial expansion of (ar + am)^p.  All of the
        # triangle's cross terms binom(p,j) * ar^(p-j) * am^j are computed
        # as chunked BATCHED digit multiplies (one dispatch per chunk
        # instead of one per term -- the per-term version dominated the
        # protocol profile) and segment-summed into the rows.
        t = _pascal(pow_)
        ampow = _np(ampow)
        AR = np.concatenate([_np(ar)[None], np.stack([_np(x) for x in arpow])])  # powers 1..pow_
        AM = np.concatenate([_np(am)[None], ampow])  # powers 1..pow_
        I, J, Pp, Cs = [], [], [], []
        for p in range(2, pow_ + 1):
            for j in range(1, p):
                I.append(p - j - 1)  # index into AR (power p-j)
                J.append(j - 1)  # index into AM (power j)
                Pp.append(p)
                Cs.append(t[p][j])
        coeff_digits = np.stack([ring.const_np(int(c)) for c in Cs])  # [npairs, L]
        L = ring.nlimb
        acc_raw = np.zeros((pow_ + 1, n, L), np.int64)
        npairs = len(I)
        chunk = max(1, (1 << 24) // max(1, n * L))
        Iv, Jv, Pv = np.asarray(I), np.asarray(J), np.asarray(Pp)
        for s in range(0, npairs, chunk):
            sl = slice(s, min(s + chunk, npairs))
            cross = ring.mul(AR[Iv[sl]], AM[Jv[sl]])  # [c, n, L]
            wt = ring.mul(cross, coeff_digits[sl][:, None, :])
            np.add.at(acc_raw, Pv[sl], wt)
        acc = ring.reduce(acc_raw)  # canonical-digit sums < npairs*255: safe

        rows = np.zeros((pow_ + 1, n, L), np.int32)
        if pid == 1:
            rows[0] = ring.ones((n,))
            # public term ar^p (only party 1 adds public values)
            rows[2:] = AR[1:]
        rows[1] = _np(a)
        rows[2:] = ring.add(ring.add(rows[2:], acc[2:]), AM[1:])
        return rows

    def evaluate_poly(self, a, coeff):
        """coeff: [npoly, deg+1] digit matrix -> [npoly, n]
        (mpc/mpc.go:526-539)."""
        ring = self.ring
        n = self._shape(ring, a)[0]
        npoly, degp1 = coeff.shape[0], coeff.shape[1]
        apow = self.powers(a, degp1 - 1)
        if self.pid == 0:
            return ring.zeros((npoly, n))
        return ring.matmul(coeff, apow)

    # --------------------------------------------- small-field bit circuits

    def powers_small(self, a, pow_: int):
        """Powers over the small bit field (SElem); same protocol."""
        F = self.sbit
        n = a.shape[0]
        pid = self.pid
        if pow_ == 1:
            b = np.zeros((2, n), np.int32)
            if pid == 1:
                b[0] = 1
            if pid > 0:
                b[1] = _np(a)
            return b
        ar, am = self.beaver_partition(a, F)
        last = self.nparty - 1
        if pid == 0:
            ampow = [F.mul(am, am)]
            for p in range(1, pow_ - 1):
                ampow.append(F.mul(ampow[-1], am))
            ampow = np.stack(ampow)
            for p in range(1, self.nparty - 1):
                with self.rand.using(p) as g:
                    share = F.rand(g, (pow_ - 1, n))
                ampow = F.sub(ampow, share)
            self.net.send(_np(ampow), last)
            return F.zeros((pow_ + 1, n))
        if pid == last:
            ampow = np.asarray(self.net.recv(0))
        else:
            with self.rand.using(0) as g:
                ampow = F.rand(g, (pow_ - 1, n))
        arpow = [F.mul(ar, ar)]
        for p in range(1, pow_ - 1):
            arpow.append(F.mul(arpow[-1], ar))
        t = _pascal(pow_)
        p_mod = F.modulus
        # batched triangle (see powers()): all cross terms in one host pass
        AR = np.concatenate([np.asarray(ar)[None], np.stack(arpow)])  # powers 1..pow_
        AM = np.concatenate([np.asarray(am)[None], ampow])
        I, J, Pp, Cs = [], [], [], []
        for p in range(2, pow_ + 1):
            for j in range(1, p):
                I.append(p - j - 1)
                J.append(j - 1)
                Pp.append(p)
                Cs.append(t[p][j] % p_mod)
        Iv, Jv, Pv = np.asarray(I), np.asarray(J), np.asarray(Pp)
        Cv = np.asarray(Cs, np.int64)
        # n * p^2 terms fit int64: accumulate then one mod
        acc64 = np.zeros((pow_ + 1, n), np.int64)
        cross = (AR[Iv].astype(np.int64) * AM[Jv]) % p_mod
        np.add.at(acc64, Pv, cross * Cv[:, None] % p_mod)
        acc = (acc64 % p_mod).astype(np.int32)

        rows = np.zeros((pow_ + 1, n), np.int32)
        if pid == 1:
            rows[0] = 1
            rows[2:] = AR[1:]
        rows[1] = a
        rows[2:] = (rows[2:].astype(np.int64) + acc[2:] + AM[1:]) % p_mod
        return rows

    def evaluate_poly_small(self, a, coeff):
        F = self.sbit
        apow = self.powers_small(a, coeff.shape[1] - 1)
        if self.pid == 0:
            return F.zeros((coeff.shape[0], a.shape[0]))
        return F.matmul(np.asarray(coeff), apow)

    def fan_in_or(self, a):
        """OR of each row of shared bits over the small field
        (mpc/mpc.go:541-561).  a: [n, d] SElem shares of 0/1."""
        F = self.sbit
        n, d = a.shape
        row_sum = np.sum(np.asarray(a, np.int64), axis=1) % F.modulus
        if self.pid == 1:
            row_sum = F.add(row_sum, 1)
        key = d + 1
        if key not in self._or_lagrange_cache:
            ys = [0] + [1] * d
            self._or_lagrange_cache[key] = _lagrange_interp_simple(ys, F.modulus)
        coeff = self._or_lagrange_cache[key]
        return self.evaluate_poly_small(row_sum, coeff[None, :])[0]

    def prefix_or(self, a):
        """Row-wise prefix-OR of shared bits (sqrt-block decomposition,
        mpc/mpc.go:654-791).  a: [n, k] SElem shares."""
        F = self.sbit
        pid = self.pid
        n, k = a.shape
        L = int(math.ceil(math.sqrt(k)))
        L2 = L * L
        # zero-pad on the left to L2 bits, reshape [n*L, L]
        apad = np.zeros((n, L2), np.int32)
        if pid > 0:
            apad[:, L2 - k :] = a
        apad = apad.reshape(n * L, L)

        x = self.fan_in_or(apad)  # block ORs, [n*L]
        xb = np.asarray(x).reshape(n, L)
        # y[i, s1] = OR of block ORs up to s1; row (i, s1) holds x[i, :s1+1]
        xpre = np.where(
            np.arange(L)[None, None, :] <= np.arange(L)[None, :, None], xb[:, None, :], 0
        )
        y = np.asarray(self.fan_in_or(xpre.reshape(n * L, L))).reshape(n, L)
        # f: first-block indicator
        f = np.zeros((n, L), np.int32)
        if pid > 0:
            f[:, 0] = xb[:, 0]
            f[:, 1:] = F.sub(y[:, 1:], y[:, :-1])

        fr, fm = self.beaver_partition(f, F)
        apr, apm = self.beaver_partition(apad, F)
        ar3 = np.asarray(apr).reshape(n, L, L)
        am3 = np.asarray(apm).reshape(n, L, L)

        def _vecmat(v, M):  # [n, L] x [n, L, L] -> [n, L] mod p
            return (
                np.einsum("nj,njk->nk", np.asarray(v, np.int64), M) % F.modulus
            ).astype(np.int32)

        if self.pid == 0:
            c = _vecmat(fm, am3)
        else:
            c = (_vecmat(fr, am3) + _vecmat(fm, ar3)) % F.modulus
            if self.pid == 1:
                c = (c + _vecmat(fr, ar3)) % F.modulus
        c = np.asarray(self.beaver_reconstruct(c, F))

        cpre = np.where(
            np.arange(L)[None, None, :] <= np.arange(L)[None, :, None],
            c[:, None, :],
            0,
        )
        bdot = np.asarray(self.fan_in_or(cpre.reshape(n * L, L))).reshape(n, L)

        bdr, bdm = self.beaver_partition(bdot, F)
        # s[i] = outer(f[i], bdot[i])  [L, L] (int64 accumulate, one mod)
        def _outer(u, v):
            uv = np.einsum("ni,nj->nij", np.asarray(u, np.int64), np.asarray(v, np.int64))
            return uv % F.modulus

        if self.pid == 0:
            s = _outer(fm, bdm)
        else:
            s = (_outer(fr, bdm) + _outer(fm, bdr)) % F.modulus
            if self.pid == 1:
                s = (s + _outer(fr, bdr)) % F.modulus
        s = np.asarray(
            self.beaver_reconstruct(s.astype(np.int32).reshape(n, L * L), F)
        ).reshape(n, L, L)

        out = np.zeros((n, k), np.int32)
        if pid > 0:
            jpad = np.arange(L2 - k, L2)
            il = jpad // L
            jl = jpad % L
            vals = (s[:, il, jl] + y[:, il].astype(np.int64) - f[:, il]) % F.modulus
            out = vals.astype(np.int32)
        return out

    def table_lookup(self, a, table_id: int):
        """Lagrange table lookup over the big field
        (mpc/mpc.go:793-812 + InitLagrangeCache mpc/mpc.go:235-309).
        a: small-field shares converted to big-field by reinterpretation."""
        ring = self.ring
        coeff_ints = self._get_lagrange_table(table_id)
        a_big = ring.from_i32(np.asarray(a, np.int32))
        coeff = ring.from_ints(coeff_ints)
        return self.evaluate_poly(a_big, coeff)

    def _get_lagrange_table(self, table_id: int):
        key = table_id
        if key in self._lagrange_cache:
            return self._lagrange_cache[key]
        p = self.ring.modulus
        if table_id == 0:
            # IsPositive: input in {1, 2} (shares over sbit), output 1, 0
            table = [[1, 0]]
            in_mod = self.sbit.modulus
        elif table_id == 1:
            # NormalizerEvenExp: 2^i and 4^i for i in 0..dataBits/2
            half = self.data_bits // 2
            table = [
                [pow(2, i, p) for i in range(half + 1)],
                [pow(4, i, p) for i in range(half + 1)],
            ]
            in_mod = self.sbit.modulus
        else:
            raise KeyError(table_id)
        ncol = len(table[0])
        coeffs = []
        for row in table:
            xs, ys = [], []
            for j in range(ncol):
                for rep in range(self.nparty - 1):
                    xs.append((j + 1 + rep * in_mod) % p)
                    ys.append(row[j])
            coeffs.append(_lagrange_interp(xs, ys, p))
        self._lagrange_cache[key] = coeffs
        return coeffs

    def less_than_bits_aux(self, a, b, public_b: bool):
        """Bitwise comparison over the small field (mpc/mpc.go:824-891).
        a, b: [n, k] bit shares (b public if public_b), MSB first.
        Returns [n] shares of (a < b)."""
        F = self.sbit
        pid = self.pid
        n, k = a.shape
        if not public_b:
            x = self.ss_mult_elem(a, b, F)
            if pid > 0:
                x = (a + b - 2 * x) % F.modulus
        else:
            if pid > 0:
                x = (a - 2 * a * b) % F.modulus
                if pid == 1:
                    x = (x + b) % F.modulus
            else:
                x = F.zeros((n, k))
        f = self.prefix_or(x)
        if pid > 0:
            f = np.concatenate(
                [np.asarray(f)[:, :1], (np.asarray(f)[:, 1:] - np.asarray(f)[:, :-1]) % F.modulus],
                axis=1,
            )
        if public_b:
            if pid > 0:
                return (np.sum(np.asarray(f, np.int64) * b, axis=1) % F.modulus).astype(np.int32)
            return F.zeros((n,))
        fr, fm = self.beaver_partition(f, F)
        br, bm = self.beaver_partition(b, F)
        c = self.beaver_mult_elem(fr, fm, br, bm, F)
        c = (np.sum(np.asarray(c, np.int64), axis=1) % F.modulus).astype(np.int32)
        return self.beaver_reconstruct(c, F)

    # -------------------------------------------------- random bit sharing

    def share_random_bits(
        self, ring, bitring, n: int, nbits_out: int, nbits_sample: int, bit_sample: bool
    ):
        """Dealer-generated random value shares + bitwise shares of the same
        values (mpc/mpc.go:603-651).  Bits are LSB-first [n, nbits_out]."""
        last = self.nparty - 1
        if self.pid == 0:
            if bit_sample:
                r = ring.rand_bits(self.rand.cur(), (n,), nbits_sample)
            else:
                r = ring.rand(self.rand.cur(), (n,))
            r_bits = _bits_lsb(ring, r, nbits_out, bitring)
            r_sh, rb_sh = np.asarray(r), r_bits
            for p in range(1, self.nparty - 1):
                with self.rand.using(p) as g:
                    mask = ring.rand(g, (n,))
                    mask_bits = bitring.rand(g, (n, nbits_out))
                r_sh = ring.sub(r_sh, mask)
                rb_sh = bitring.sub(rb_sh, mask_bits)
            self.net.send((_np(r_sh), _np(rb_sh)), last)
            return np.asarray(r), r_bits
        if self.pid == last:
            both = self.net.recv(0)
            r_sh = np.asarray(both[0])
            rb_sh = np.asarray(both[1])
        else:
            with self.rand.using(0) as g:
                r_sh = ring.rand(g, (n,))
                rb_sh = bitring.rand(g, (n, nbits_out))
        return r_sh, rb_sh

    # ------------------------------------------------------ is_positive etc

    def is_positive(self, a, binary=None):
        """[n] shares of 1 if value > 0 else 0 (mpc/mpc.go:1867-1919).
        Dispatches to the binary-share version when enabled."""
        binary = self.boolean_shares if binary is None else binary
        if binary:
            from . import boolean

            return boolean.is_positive_2n(self, a)
        ring = self.ring
        F = self.sbit
        pid = self.pid
        n = self._shape(ring, a)[0]
        nbits = ring.modulus.bit_length()
        r, r_bits = self.share_random_bits(ring, F, n, nbits, 0, False)
        # reveal 2a + r
        c = self.reveal_sym(ring.add(ring.mul_int(a, 2), r))
        if pid == 0:
            c_bits = F.zeros((n, nbits))
        else:
            c_bits = _bits_msb(ring, c, nbits, F)
        r_bits_msb = r_bits[:, ::-1]  # share_random_bits returns LSB-first
        no_overflow = self.less_than_bits_aux(r_bits_msb, c_bits, public_b=True)

        if pid > 0:
            c_lsb = np.asarray(c_bits)[:, nbits - 1]  # LSB of revealed value (public)
            r_lsb = np.asarray(r_bits)[:, 0]
            cxr = (r_lsb - 2 * c_lsb * r_lsb) % F.modulus
            if pid == 1:
                cxr = (cxr + c_lsb) % F.modulus
        else:
            cxr = F.zeros((n,))
        lsb = self.ss_mult_elem(cxr, no_overflow, F)
        if pid > 0:
            lsb = (2 * lsb - no_overflow - cxr) % F.modulus
            if pid == 1:
                lsb = (lsb + 1) % F.modulus
        if pid == 1:
            lsb = (lsb + 1) % F.modulus  # 0,1 -> 1,2
        return self.table_lookup(lsb, 0)[0]

    def flip_bit(self, a):
        """1 - a (mpc/mpc.go:2217-2230)."""
        ring = self.ring
        if self.pid == 0:
            return ring.zeros(self._shape(ring, a))
        b = ring.neg(a)
        if self.pid == 1:
            b = ring.add(b, np.broadcast_to(ring.const_np(1), b.shape))
        return b

    def less_than(self, a, b, binary=None):
        d = self.ring.sub(a, b) if self.pid > 0 else a
        return self.flip_bit(self.is_positive(d, binary))

    def not_less_than(self, a, b, binary=None):
        return self.flip_bit(self.less_than(a, b, binary))

    def less_than_public(self, a, bpub_digits, binary=None):
        ring = self.ring
        acopy = a
        if self.pid == 1:
            acopy = ring.sub(a, np.broadcast_to(np.asarray(bpub_digits), a.shape))
        return self.flip_bit(self.is_positive(acopy, binary))

    def not_less_than_public(self, a, bpub_digits, binary=None):
        return self.flip_bit(self.less_than_public(a, bpub_digits, binary))

    # --------------------------------------------------- normalizer (field)

    def normalizer_even_exp(self, a, k: int, binary=None):
        """Power-of-two scaling pair (b, sqrt(b)) with a*b in [2^{k-2}, 2^k)
        (mpc/mpc.go:1052-1159 field version; boolean.py binary version)."""
        binary = self.boolean_shares if binary is None else binary
        if binary:
            from . import boolean

            return boolean.normalizer_even_exp_2n(self, a, k)
        ring = self.ring
        F = self.sbit
        pid = self.pid
        n = self._shape(ring, a)[0]
        r, r_bits = self.share_random_bits(ring, F, n, k, k + 30, True)
        e = self.reveal_sym(ring.add(a, r))
        if pid == 0:
            e_bits = F.zeros((n, k))
        else:
            e_bits = _bits_msb(ring, e, k, F)
        r_bits = r_bits[:, ::-1]  # MSB first

        c = self.less_than_bits_aux(r_bits, e_bits, public_b=True)
        if pid > 0:
            cnew = F.zeros((n,))
            if pid == 1:
                cnew = np.ones((n,), np.int32)
            c = (cnew - np.asarray(c)) % F.modulus

        ep = F.zeros((n, k + 1))
        if pid > 0:
            ep[:, 0] = c
            body = ((1 - 2 * np.asarray(e_bits, np.int64)) * r_bits) % F.modulus
            if pid == 1:
                body = (body + e_bits) % F.modulus
            ep[:, 1:] = body
        E = self.prefix_or(ep)

        tp_neg = F.zeros((n, k))
        if pid > 0:
            tp_neg = (
                np.asarray(E)[:, :k] - np.asarray(r_bits, np.int64) * (1 - np.asarray(e_bits))
            ) % F.modulus
        T_neg = self.prefix_or(tp_neg.astype(np.int32))

        half = k // 2
        if pid > 0:
            efir = (e_bits * T_neg) % F.modulus
        else:
            efir = F.zeros((n, k))
        rfir = self.ss_mult_elem(r_bits, T_neg, F)
        double_flag = self.less_than_bits_aux(efir, rfir, public_b=False)

        odd_bits = F.zeros((n, half))
        even_bits = F.zeros((n, half))
        if pid > 0:
            T_neg = np.asarray(T_neg)
            odd_idx = np.arange(half) * 2 + 1
            odd_bits = (-T_neg[:, odd_idx]) % F.modulus
            if pid == 1:
                odd_bits = (odd_bits + 1) % F.modulus
            even_idx = np.arange(half) * 2 + 2
            valid = even_idx < k
            ev = np.where(valid[None, :], -T_neg[:, np.minimum(even_idx, k - 1)], 0)
            even_bits = ev % F.modulus
            if pid == 1:
                even_bits = (even_bits + np.where(valid[None, :], 1, 0)) % F.modulus

        odd_sum = np.sum(np.asarray(odd_bits, np.int64), axis=1) % F.modulus
        even_sum = np.sum(np.asarray(even_bits, np.int64), axis=1) % F.modulus
        if pid == 1:
            odd_sum = (odd_sum + 1) % F.modulus
            even_sum = (even_sum + 1) % F.modulus

        diff = ((odd_sum - even_sum) % F.modulus).astype(np.int32)
        diff = self.ss_mult_elem(double_flag, diff, F)
        chosen = ((even_sum + diff) % F.modulus).astype(np.int32)

        bmat = self.table_lookup(chosen, 1)
        return bmat[1], bmat[0]

    # ------------------------------------------------------- sqrt / divide

    def _sqrt_and_sqrt_inverse_inner(self, a, binary=None) -> Tuple:
        """Newton sqrt + inverse sqrt (mpc/mpc.go:1991-2080)."""
        ring = self.ring
        n = self._shape(ring, a)[0]
        if n > self.div_sqrt_max_len:
            outs, outs_inv = [], []
            for s in range(0, n, self.div_sqrt_max_len):
                o, oi = self.sqrt_and_sqrt_inverse(
                    a[s : s + self.div_sqrt_max_len], binary
                )
                outs.append(o)
                outs_inv.append(oi)
            return _cat(outs), _cat(outs_inv)

        pid = self.pid
        kb, fb = self.data_bits, self.frac_bits
        num_iter = 2 * int(math.ceil(math.log2(kb / 3.5)))
        if n > 100:
            log(f"pid{pid} sqrt/sqrtinv n={n}")
        s, s_sqrt = self.normalizer_even_exp(a, kb, binary)

        a_scaled = self.ss_mult_elem(a, s)
        a_scaled = self.trunc(a_scaled, kb, kb - fb)
        a_scaled_sq = self.ss_mult_elem(a_scaled, a_scaled)
        a_scaled_sq = self.trunc(a_scaled_sq, kb, fb)

        scaled_est = ring.zeros((n,))
        if pid > 0:
            scaled_est = ring.add(
                ring.mul_int(a_scaled, -4), ring.mul_int(a_scaled_sq, 2)
            )
            if pid == self.hub_pid:
                const = ring.const_np(int(round(2.9581 * (1 << fb))))
                scaled_est = ring.add(scaled_est, np.broadcast_to(const, scaled_est.shape))

        h = self.ss_mult_elem(scaled_est, s_sqrt)
        h = self.trunc(h, kb // 2 + fb + 2, (kb - fb) // 2 + 1)

        g = ring.mul_int(h, 2)
        g = self.ss_mult_elem(g, a)
        g = self.trunc(g, kb, fb)

        # Newton iterations with g/h STACKED: one multiply round and one
        # trunc round update both (the reference partitions once per step,
        # mpc/mpc.go:1991-2080; stacking serves the same round count with
        # half the per-step protocol messages of the naive loop)
        onept5 = ring.const_np(int(round(1.5 * (1 << fb))))
        gh = _cat([g, h])
        for _ in range(num_iter):
            r = self.ss_mult_elem(gh[n:], gh[:n])
            r = self.trunc(r, kb, fb)
            r = ring.neg(r)
            if pid == 1:
                r = ring.add(r, np.broadcast_to(onept5, r.shape))
            gh = self.ss_mult_elem(gh, _cat([r, r]))
            gh = self.trunc(gh, kb, fb)
        return gh[:n], ring.mul_int(gh[n:], 2)

    def divide(self, a, b, binary=None):
        """Fixed-point division a/b (mpc/mpc.go:2082-2187)."""
        ring = self.ring
        n = self._shape(ring, a)[0]
        if n > self.div_sqrt_max_len:
            outs = []
            for s in range(0, n, self.div_sqrt_max_len):
                outs.append(
                    self.divide(
                        a[s : s + self.div_sqrt_max_len],
                        b[s : s + self.div_sqrt_max_len],
                        binary,
                    )
                )
            return np.concatenate(outs)
        pid = self.pid
        kb, fb = self.data_bits, self.frac_bits
        num_iter = 2 * int(math.ceil(math.log2(kb / 3.5))) + 1
        s, _ = self.normalizer_even_exp(b, kb, binary)

        b_scaled = self.ss_mult_elem(b, s)
        b_scaled = self.trunc(b_scaled, kb, kb - fb)
        b_scaled_sq = self.ss_mult_elem(b_scaled, b_scaled)
        b_scaled_sq = self.trunc(b_scaled_sq, kb, fb)

        scaled_est = ring.zeros((n,))
        if pid > 0:
            scaled_est = ring.add(
                ring.mul_int(b_scaled, -10), ring.mul_int(b_scaled_sq, 5)
            )
            if pid == 1:
                const = ring.const_np(int(round(5.9430 * (1 << fb))))
                scaled_est = ring.add(scaled_est, np.broadcast_to(const, scaled_est.shape))

        w = self.ss_mult_elem(scaled_est, s)
        w = self.trunc(w, kb + fb + 2, kb - fb)

        x = self.ss_mult_elem(w, b)
        x = self.trunc(x, kb, fb)
        x = ring.neg(x)
        one = ring.const_np(1 << fb)
        if pid == 1:
            x = ring.add(x, np.broadcast_to(one, x.shape))

        y = self.ss_mult_elem(w, a)
        y = self.trunc(y, kb, fb)

        for _ in range(num_iter):
            # one partition round, one reconstruct round, one trunc round
            # per Goldschmidt step (y/x stacked)
            (xr, yr), (xm, ym) = self.beaver_partition_many([x, y])
            xpr = xr
            if pid > 0:
                xpr = ring.add(xr, np.broadcast_to(one, xr.shape))
            y = self.beaver_mult_elem(yr, ym, xpr, xm)
            x = self.beaver_mult_elem(xr, xm, xr, xm)
            yx = self.beaver_reconstruct(np.concatenate([y, x]))
            yx = self.trunc(yx, kb, fb)
            y, x = yx[:n], yx[n:]

        if pid == 1:
            x = ring.add(x, np.broadcast_to(one, x.shape))
        c = self.ss_mult_elem(x, y)
        return self.trunc(c, kb, fb)


# ---------------------------------------------------------------------------
# helpers


def _assign(ring, mat, row, val):
    return R.aset(mat, row, val)


_pascal_cache = {}


def _pascal(pow_: int):
    if pow_ in _pascal_cache:
        return _pascal_cache[pow_]
    t = [[0] * (pow_ + 1) for _ in range(pow_ + 1)]
    for i in range(pow_ + 1):
        for j in range(i + 1):
            t[i][j] = 1 if j in (0, i) else t[i - 1][j - 1] + t[i - 1][j]
    _pascal_cache[pow_] = t
    return t


def _lagrange_interp(xs, ys, p):
    """Host: exact Lagrange coefficients over Z_p (mpc/mpc.go:313-360).
    Returns list of ints, order (1, x, x^2, ...)."""
    n = len(xs)
    coeff = [0] * n
    for i in range(n):
        # numerator poly: prod_{j != i} (X - x_j); denominator prod (x_i - x_j)
        num = [1]
        denom = 1
        for j in range(n):
            if j == i:
                continue
            # num *= (X - x_j)
            new = [0] * (len(num) + 1)
            for d, c in enumerate(num):
                new[d + 1] = (new[d + 1] + c) % p
                new[d] = (new[d] - c * xs[j]) % p
            num = new
            denom = denom * (xs[i] - xs[j]) % p
        dinv = pow(denom % p, -1, p)
        for d in range(n):
            coeff[d] = (coeff[d] + ys[i] * dinv * num[d]) % p
    return coeff


def _lagrange_interp_simple(ys, p):
    xs = list(range(1, len(ys) + 1))
    return np.array(_lagrange_interp(xs, ys, p), dtype=np.int64).astype(np.int32)


def _bits_lsb(ring, vals, nbits, bitring):
    """Bits (LSB first) of canonical digit values -> bitring array [n, nbits]."""
    v = _np(vals)
    n = v.shape[0]
    out = np.zeros((n, nbits), dtype=np.int8 if bitring is R.GF2 else np.int32)
    for b in range(nbits):
        d, r = b // R.DIGIT_BITS, b % R.DIGIT_BITS
        if d < v.shape[-1]:
            out[:, b] = (v[:, d] >> r) & 1
    return out


def _bits_msb(ring, vals, nbits, bitring):
    return _bits_lsb(ring, vals, nbits, bitring)[:, ::-1].copy()


def _prof_sqrt(self, *a, **k):
    with prof.span("ss_sqrt"):
        return self._sqrt_and_sqrt_inverse_inner(*a, **k)


MPC.sqrt_and_sqrt_inverse = _prof_sqrt
