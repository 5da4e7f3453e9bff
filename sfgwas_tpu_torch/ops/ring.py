"""Limb-based modular ring arithmetic for the MPC secret-sharing domain
(counterpart of sfgwas_tpu/ops/ring.py).

Ring elements are little-endian base-2^8 digit vectors stored in int32
arrays of shape ``[..., nlimb]``:

* moduli are "delta below a power of two": p256 = 2^256 - 189 and
  p128 = 2^127 - 1.  This is what makes the prime -> power-of-two share
  conversion of the binary comparison protocols work (mpc/boolean.py):
  shares mod p, re-read mod 2^b, differ from the true value only by a small
  multiple of delta;
* carries use arithmetic right shifts (floor division), which stay correct
  for the signed int64 intermediates that subtraction produces.

Element layouts:
  scalar  -> [nlimb]
  RVec    -> [n, nlimb]
  RMat    -> [r, c, nlimb]

Every op takes and returns *canonical* digit arrays (each digit in [0, 255]
and the value in [0, modulus)) unless noted; canonical arrays are int32 by
construction, and the native engine (ops/native_ring.py) takes int32 inputs
only, so every constant and every producer here returns int32.  A ring
built with native=False runs the numpy path alone (the engine's oracle).

Every op has a host path (numpy, the native engine) and a device path
(int32 torch tensors) with the same results.  Numpy inputs take the host
path; tensors among the inputs take the device path, on their device
(numpy operands are staged there as int32; tensors on two devices raise):
the CUDA kernels K8-K11 of ops/cuda_ring.py for CUDA tensors (add, sub,
neg, small mul_int, sum and from_i32 one launch each of K8's fused
entries), their plain torch versions for CPU tensors.  So a share given
as a tensor selects where the work runs.  The SS protocol layer stays on the host by default
(Ring.host = True, as the reference's): its tensors are small and stepped
in lockstep, one protocol round at a time, where a device dispatch per op
costs more than the digit arithmetic.  A ring whose `host` is set to False
runs in device mode: the MPC layer stages each Beaver mask on the device
of the shares it masks (mpc/mpc.py), once, where host mode would copy it
to that device at every op that reads it.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from . import cuda_ring, native_ring

DIGIT_BITS = 8
DIGIT_MASK = (1 << DIGIT_BITS) - 1


def to_host(x) -> np.ndarray:
    """x as a numpy array (a tensor is copied to the host)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _dev(*xs):
    """The device of the tensors among xs, or None when all are host
    arrays.  Tensors on two devices raise: an op never moves a share
    between devices on its own."""
    devs = {x.device for x in xs if isinstance(x, torch.Tensor)}
    if len(devs) > 1:
        raise ValueError(f"ring operands on different devices: {sorted(map(str, devs))}")
    return devs.pop() if devs else None


def to_device(x, device) -> torch.Tensor:
    """x as an int32 tensor on `device`; a host array is copied (a
    broadcast numpy view as the array it views, broadcast there)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    x = np.asarray(x, dtype=np.int32)
    if x.size and 0 in x.strides:
        base = x[tuple(slice(0, 1) if st == 0 else slice(None) for st in x.strides)]
        return torch.tensor(base, device=device).expand(x.shape)
    return torch.tensor(x, device=device)


def _dense_on(arr, dev) -> torch.Tensor:
    """A writable dense copy of arr on `dev` (a host array as int32)."""
    return to_device(arr, dev) if not isinstance(arr, torch.Tensor) else arr.clone()


def aset(arr, idx, val):
    """Indexed set on a copy (the functional .at[].set() semantics); with a
    tensor among arr and val the copy is a tensor on its device."""
    dev = _dev(arr, val)
    if dev is not None:
        out = _dense_on(arr, dev).contiguous()
        out[idx] = to_device(val, dev).to(out.dtype)
        return out
    out = np.array(arr)
    out[idx] = to_host(val)
    return out


def aadd(arr, idx, val):
    """Indexed add on a copy (scatter-add for repeated indices); with a
    tensor among arr and val the copy is a tensor on its device."""
    dev = _dev(arr, val)
    if dev is not None:
        out = _dense_on(arr, dev).contiguous()
        pos = torch.arange(out.numel(), device=dev).reshape(out.shape)[idx]
        v = to_device(val, dev).to(out.dtype).broadcast_to(pos.shape)
        flat = out.reshape(-1)
        flat.index_add_(0, pos.reshape(-1), v.reshape(-1))
        return flat.reshape(out.shape)
    out = np.array(arr)
    np.add.at(out, idx, to_host(val))
    return out


class Ring:
    """Z_p (kind='prime') or Z_{2^bits} (kind='pow2') digit arithmetic.
    native=True (the default) runs the hot ops on the native engine, built
    at first use; native=False keeps the numpy path."""

    has_limbs = True
    host = True  # False: the MPC layer stages the Beaver masks where the shares lie

    def __init__(self, modulus: int, kind: str, name: str = "", native: bool = True):
        assert kind in ("prime", "pow2")
        self.kind = kind
        self.modulus = modulus
        self.name = name or f"{kind}{modulus.bit_length()}"
        self.bits = modulus.bit_length() if kind == "prime" else modulus.bit_length() - 1
        # number of 8-bit digits needed to cover [0, modulus)
        self.nlimb = -(-self.bits // DIGIT_BITS)
        cap = 1 << (DIGIT_BITS * self.nlimb)  # capacity of the digit array
        if kind == "prime":
            assert modulus < cap
            self.fold_c = cap % modulus  # 2^(8*nlimb) mod p; must be small
            assert self.fold_c < (1 << 9), "prime must be just below a power of two"
            self.top_mask = DIGIT_MASK
        else:
            assert modulus <= cap
            self.fold_c = 0
            # bits of modulus inside the top digit (e.g. 2^127 with 16 digits)
            top_bits = self.bits - DIGIT_BITS * (self.nlimb - 1)
            self.top_mask = (1 << top_bits) - 1
        self._p_digits = None
        if kind == "prime":
            self._p_digits = tuple(
                (modulus >> (DIGIT_BITS * i)) & DIGIT_MASK for i in range(self.nlimb)
            )
        self._cache = {}
        self.native = native
        self._nid = native_ring.ring_id(modulus, kind) if native else None

    @property
    def _nlib(self):
        """The native engine for this ring (built and loaded at first use;
        a failure raises), or None on the numpy path."""
        return None if self._nid is None else native_ring.lib()

    def __hash__(self):
        return hash((self.kind, self.modulus))

    def __eq__(self, other):
        return isinstance(other, Ring) and (self.kind, self.modulus) == (
            other.kind,
            other.modulus,
        )

    def __repr__(self):
        return f"Ring({self.name})"

    # ---------------------------------------------------------- conversions

    def _int_to_digit_list(self, v: int) -> list:
        v %= self.modulus
        return [(v >> (DIGIT_BITS * i)) & DIGIT_MASK for i in range(self.nlimb)]

    def from_ints(self, vals) -> np.ndarray:
        """Array of python ints (any shape, any sign) -> digit array."""
        arr = np.asarray(vals, dtype=object)
        out = np.empty(arr.shape + (self.nlimb,), dtype=np.int32)
        flat = arr.reshape(-1)
        oflat = out.reshape(-1, self.nlimb)
        for i, v in enumerate(flat):
            oflat[i] = self._int_to_digit_list(int(v))
        return out

    def to_ints(self, digits) -> np.ndarray:
        """Canonical digit array -> array of python ints (object dtype)."""
        d = to_host(digits)
        shape = d.shape[:-1]
        flat = d.reshape(-1, self.nlimb)
        out = np.empty(len(flat), dtype=object)
        for i in range(len(flat)):
            v = 0
            for j in range(self.nlimb - 1, -1, -1):
                v = (v << DIGIT_BITS) | int(flat[i, j])
            out[i] = v
        return out.reshape(shape) if shape else out[0]

    def from_float(self, vals, frac_bits: int) -> np.ndarray:
        """Fixed-point encode floats (round(v * 2^frac)) mod modulus."""
        arr = np.asarray(vals, dtype=np.float64)
        ints = np.empty(arr.shape, dtype=object)
        it = np.nditer(arr, flags=["multi_index", "refs_ok"])
        for x in it:
            ints[it.multi_index] = int(round(float(x) * (1 << frac_bits)))
        return self.from_ints(ints)

    def to_float(self, digits, frac_bits: int) -> np.ndarray:
        """Centered decode: values > modulus/2 are negative.

        Sign by lexicographic compare against modulus/2, magnitude via the
        exact borrow-propagated M - v, then a uint64 fold of the low 8
        digits (fixed-point protocol values are below 2^64 in magnitude;
        anything larger takes the exact per-element bignum loop)."""
        d = to_host(digits).astype(np.int64)
        scalar = d.ndim == 1
        d2 = d.reshape(-1, self.nlimb)
        neg = self._is_negative_digits(d2)
        mag = np.where(neg[..., None], self._neg_digits(d2), d2)
        if self.nlimb > 8 and mag[..., 8:].any():
            return self._to_float_exact(digits, frac_bits)
        k = min(8, self.nlimb)
        w = (np.uint64(1) << (np.uint64(DIGIT_BITS) * np.arange(k, dtype=np.uint64)))
        lo = (mag[..., :k].astype(np.uint64) * w).sum(-1, dtype=np.uint64)
        out = lo.astype(np.float64) / float(1 << frac_bits)
        out = np.where(neg, -out, out)
        return out[0] if scalar else out.reshape(d.shape[:-1])

    def _is_negative_digits(self, d2: np.ndarray) -> np.ndarray:
        """Lexicographic v > modulus/2 on canonical digit rows [n, L]."""
        half = np.asarray(self._int_to_digit_list(self.modulus >> 1), dtype=np.int64)
        diff = d2 - half
        nz = diff != 0
        # index of the most significant differing digit (0 if none differ)
        idx = self.nlimb - 1 - np.argmax(nz[..., ::-1], axis=-1)
        top = np.take_along_axis(diff, idx[..., None], axis=-1)[..., 0]
        return top > 0

    def _neg_digits(self, d2: np.ndarray) -> np.ndarray:
        """Exact (modulus - v) in digit form, vectorized borrow scan."""
        if self.kind == "prime":
            r = np.asarray(self._p_digits, dtype=np.int64) - d2
        else:
            r = -d2.astype(np.int64)
        out = np.empty_like(r)
        borrow = np.zeros(r.shape[:-1], dtype=np.int64)
        for j in range(self.nlimb):
            t = r[..., j] + borrow
            borrow = t >> DIGIT_BITS
            out[..., j] = t - (borrow << DIGIT_BITS)
        if self.kind != "prime":
            # 2^{8L} - v folds onto 2^bits - v under the canonical top mask
            out[..., -1] &= self.top_mask
        return out

    def _to_float_exact(self, digits, frac_bits: int) -> np.ndarray:
        ints = self.to_ints(digits)
        half = self.modulus >> 1
        flat = np.atleast_1d(ints).reshape(-1)
        out = np.empty(len(flat), dtype=np.float64)
        for i, v in enumerate(flat):
            v = int(v)
            if v > half:
                v -= self.modulus
            out[i] = v / float(1 << frac_bits)
        shape = np.asarray(ints).shape
        return out.reshape(shape) if shape else out[0]

    def centered_ints(self, digits) -> np.ndarray:
        ints = np.atleast_1d(self.to_ints(digits))
        half = self.modulus >> 1
        out = np.empty(ints.shape, dtype=object)
        flat_in = ints.reshape(-1)
        flat_out = out.reshape(-1)
        for i, v in enumerate(flat_in):
            v = int(v)
            flat_out[i] = v - self.modulus if v > half else v
        return out

    def inv_int(self, v: int) -> int:
        """Modular inverse (modulus must be prime or v odd-coprime)."""
        return pow(int(v) % self.modulus, -1, self.modulus)

    def const_np(self, v: int) -> np.ndarray:
        """Cached int32 digits of a python int constant (read-only)."""
        v = int(v) % self.modulus
        key = ("const", v)
        if key not in self._cache:
            c = np.asarray(self._int_to_digit_list(v), dtype=np.int32)
            c.flags.writeable = False
            self._cache[key] = c
        return self._cache[key]

    def const(self, v: int, device=None):
        """Digits of a python int constant: host int32 (const_np), or a
        cached int32 tensor on `device`."""
        if device is None:
            return self.const_np(v)
        v = int(v) % self.modulus
        device = torch.device(device)
        key = ("const_dev", v, str(device))
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(self.const_np(v).copy(), device=device)
        return self._cache[key]

    def pow2_digits(self, e: int, device=None):
        return self.const(pow(2, e, self.modulus), device)

    def inv_pow2_np(self, m: int) -> np.ndarray:
        """Digits of 2^{-m} mod p (prime only)."""
        assert self.kind == "prime"
        return self.const_np(pow((self.modulus + 1) // 2, m, self.modulus))

    def inv_pow2_digits(self, m: int, device=None):
        """Digits of 2^{-m} mod p (prime only), on `device` when given."""
        assert self.kind == "prime"
        return self.const(pow((self.modulus + 1) // 2, m, self.modulus), device)

    # -------------------------------------------------------------- shapes

    def zeros(self, shape: Sequence[int]) -> np.ndarray:
        return np.zeros(tuple(shape) + (self.nlimb,), dtype=np.int32)

    def ones(self, shape: Sequence[int]) -> np.ndarray:
        return np.broadcast_to(self.const_np(1), tuple(shape) + (self.nlimb,))

    def from_i32(self, vals):
        """int32 array of small nonneg values -> canonical digits."""
        if isinstance(vals, torch.Tensor):
            return cuda_ring.from_i32(self, vals)
        v = np.asarray(vals, dtype=np.int64)
        x = np.stack([(v >> (DIGIT_BITS * i)) & DIGIT_MASK for i in range(4)], axis=-1)
        pad = [(0, 0)] * (x.ndim - 1) + [(0, self.nlimb - 4)]
        return self.np_reduce(np.pad(x, pad))

    # ------------------------------------------------------------ reduction

    def _np_exact_carry(self, x):
        """Exact carry over the digit axis (int64); returns (digits in
        [0,255], carry_out).  Carries shrink by 2^8 per pass, so a few
        whole-array shift passes replace the sequential per-digit loop."""
        x = np.asarray(x, dtype=np.int64)
        out = x.copy()
        carry_out = np.zeros(x.shape[:-1], dtype=np.int64)
        while True:
            q = out >> DIGIT_BITS
            if not q.any():
                return out, carry_out
            out -= q << DIGIT_BITS
            out[..., 1:] += q[..., :-1]
            carry_out += q[..., -1]

    def np_reduce(self, x) -> np.ndarray:
        """Any signed digit array (at most 2L-1 digits) -> canonical."""
        x = np.asarray(x, dtype=np.int64)
        L = self.nlimb
        lib = self._nlib
        if lib is not None and 1 <= x.shape[-1] <= 2 * L - 1:
            nd = x.shape[-1]
            flat = np.ascontiguousarray(x.reshape(-1, nd))
            out = np.empty((flat.shape[0], L), np.int32)
            lib.sfg_ring_reduce64(self._nid, flat, flat.shape[0], nd, out)
            return out.reshape(x.shape[:-1] + (L,))
        if x.shape[-1] < L:
            x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, L - x.shape[-1])])
        x, c_out = self._np_exact_carry(x)
        if x.shape[-1] > L:
            lo, hi = x[..., :L], x[..., L:]
            nh = hi.shape[-1]
            assert nh < L, "input too wide; reduce in chunks"
            if self.kind == "prime":
                contrib = np.pad(hi * self.fold_c, [(0, 0)] * (x.ndim - 1) + [(0, L - nh)])
                x = lo + contrib
                x[..., nh] += c_out * self.fold_c
            else:
                x = lo.copy()
        else:
            x = x.copy()
            if self.kind == "prime":
                x[..., 0] += c_out * self.fold_c
        for _ in range(2):
            x, c_out = self._np_exact_carry(x)
            if self.kind == "prime":
                x[..., 0] += c_out * self.fold_c
        x, _ = self._np_exact_carry(x)
        if self.kind == "prime":
            p = np.array(self._p_digits, dtype=np.int64)
            for _ in range((1 << (DIGIT_BITS * L)) // self.modulus):
                y = x - p
                y, borrow = self._np_exact_carry(y)
                x = np.where((borrow == 0)[..., None], y, x)
        else:
            x[..., -1] &= self.top_mask
        return x.astype(np.int32)

    def reduce(self, x):
        """Any signed digit array (at most 2L-1 digits) -> canonical."""
        d = _dev(x)
        return self.np_reduce(x) if d is None else cuda_ring.reduce(self, to_device(x, d))

    def _np_conv(self, a, b) -> np.ndarray:
        """Digit convolution of canonical arrays -> [..., 2L-1] int64."""
        L = self.nlimb
        shape = np.broadcast_shapes(a.shape[:-1], b.shape[:-1])
        a = np.broadcast_to(a, shape + (L,)).astype(np.int64)
        b = np.broadcast_to(b, shape + (L,)).astype(np.int64)
        conv = np.zeros(shape + (2 * L - 1,), dtype=np.int64)
        for i in range(L):
            conv[..., i : i + L] += a[..., i : i + 1] * b
        return conv

    # ----------------------------------------------------------- arithmetic

    def _native_canon2(self, op, a, b):
        """The native elementwise op on two canonical int32 digit arrays, or
        None when the engine does not apply (numpy path, non-int32 or
        non-digit inputs: non-canonical intermediates are int64 and take
        the reduce path)."""
        if (
            not isinstance(a, np.ndarray)
            or not isinstance(b, np.ndarray)
            or a.dtype != np.int32
            or b.dtype != np.int32
            or a.shape[-1] != self.nlimb
            or b.shape[-1] != self.nlimb
        ):
            return None
        if a.shape == b.shape and a.flags.c_contiguous and b.flags.c_contiguous:
            shape, af, bf = a.shape, a.reshape(-1, self.nlimb), b.reshape(-1, self.nlimb)
        else:
            shape = np.broadcast_shapes(a.shape, b.shape)
            af = np.ascontiguousarray(np.broadcast_to(a, shape)).reshape(-1, self.nlimb)
            bf = np.ascontiguousarray(np.broadcast_to(b, shape)).reshape(-1, self.nlimb)
        out = np.empty_like(af)
        op(self._nid, af.ctypes.data, bf.ctypes.data, af.shape[0], out.ctypes.data)
        return out.reshape(shape)

    def add(self, a, b):
        d = _dev(a, b)
        if d is not None:
            return cuda_ring.combine(self, to_device(a, d), to_device(b, d), 1, 1)
        lib = self._nlib
        if lib is not None:
            out = self._native_canon2(lib.sfg_ring_add, a, b)
            if out is not None:
                return out
        return self.np_reduce(np.asarray(a, np.int64) + b)

    def sub(self, a, b):
        d = _dev(a, b)
        if d is not None:
            return cuda_ring.combine(self, to_device(a, d), to_device(b, d), 1, -1)
        lib = self._nlib
        if lib is not None:
            out = self._native_canon2(lib.sfg_ring_sub, a, b)
            if out is not None:
                return out
        return self.np_reduce(np.asarray(a, np.int64) - b)

    def neg(self, a):
        d = _dev(a)
        if d is not None:
            return cuda_ring.combine(self, to_device(a, d), None, -1, 0)
        lib = self._nlib
        if (
            lib is not None
            and isinstance(a, np.ndarray)
            and a.dtype == np.int32
            and a.shape[-1] == self.nlimb
        ):
            af = np.ascontiguousarray(a).reshape(-1, self.nlimb)
            out = np.empty_like(af)
            lib.sfg_ring_neg(self._nid, af, af.shape[0], out)
            return out.reshape(a.shape)
        return self.np_reduce(-np.asarray(a, np.int64))

    def mul(self, a, b):
        d = _dev(a, b)
        if d is not None:
            return cuda_ring.mul(self, to_device(a, d), to_device(b, d))
        a = np.asarray(a)
        b = np.asarray(b)
        lib = self._nlib
        if lib is not None:
            out = self._native_canon2(lib.sfg_ring_mul, a, b)
            if out is not None:
                return out
        return self.np_reduce(self._np_conv(a, b))

    def mul_const(self, a, c_digits):
        if _dev(a, c_digits) is not None:
            return self.mul(a, c_digits)  # broadcast by the kernel's wrapper
        return self.mul(a, np.broadcast_to(np.asarray(c_digits), np.shape(a)))

    def mul_int(self, a, v: int):
        """Multiply by a python int constant (fast path for small |v|)."""
        v = int(v)
        d = _dev(a)
        if -(1 << 9) < v < (1 << 9):
            if d is not None:
                return cuda_ring.combine(self, to_device(a, d), None, v, 0)
            return self.np_reduce(np.asarray(a, np.int64) * v)
        return self.mul(a, self.const(v, d))

    def matmul(self, A, B):
        """[r, k, L] x [k, c, L] -> [r, c, L]; the numpy path chunks k so
        digit-pair sums stay within the reduce headroom."""
        d = _dev(A, B)
        if d is not None:
            return cuda_ring.matmul(self, to_device(A, d), to_device(B, d))
        A, B = np.asarray(A), np.asarray(B)
        L = self.nlimb
        r, k, _ = A.shape
        k2, c, _ = B.shape
        assert k == k2
        lib = self._nlib
        if lib is not None and A.dtype == np.int32 and B.dtype == np.int32:
            out = np.empty((r, c, L), np.int32)
            lib.sfg_ring_matmul(self._nid, np.ascontiguousarray(A), np.ascontiguousarray(B),
                                r, k, c, out)
            return out
        max_k = 896
        out = None
        for k0 in range(0, k, max_k):
            Ak = A[:, k0 : k0 + max_k, :].astype(np.int64)
            Bk = B[k0 : k0 + max_k, :, :].astype(np.int64)
            M = np.einsum("ika,kjb->ijab", Ak, Bk)  # [r, c, L, L]
            conv = np.zeros((r, c, 2 * L - 1), dtype=np.int64)
            for i in range(L):
                conv[:, :, i : i + L] += M[:, :, i, :]
            part = self.np_reduce(conv)
            out = part if out is None else self.add(out, part)
        return out

    def dot_coeffs(self, a, coeffs):
        """sum_k a[..., k, :] * coeffs[k, :] as one contraction: only the k
        small constants are band-embedded ([k, L, 2L-1]), never the big
        operand."""
        k, L = coeffs.shape
        assert L == self.nlimb and a.shape[-1] == L and a.shape[-2] == k
        d = _dev(a, coeffs)
        if d is not None:  # the kernel's sums are wide: no bound on k
            return cuda_ring.dot(self, to_device(a, d), to_device(coeffs, d))
        a = np.asarray(a)
        c32 = np.asarray(coeffs)
        lib = self._nlib
        if lib is not None and a.dtype == np.int32 and c32.dtype == np.int32:
            # the engine accumulates in 64-bit limbs: no bound on k
            af = np.ascontiguousarray(a).reshape(-1, k, L)
            out = np.empty((af.shape[0], L), np.int32)
            lib.sfg_ring_dot(self._nid, af, np.ascontiguousarray(c32), af.shape[0], k, out)
            return out.reshape(a.shape[:-2] + (L,))
        c = np.asarray(coeffs, np.int64)
        band = np.zeros((k, L, 2 * L - 1), np.int64)
        for i in range(L):
            band[:, i, i : i + L] = c
        return self.np_reduce(np.einsum("...ki,kid->...d", np.asarray(a, np.int64), band))

    def sum(self, a, axis: int = 0):
        """Sum of canonical elements along a batch axis."""
        assert a.shape[axis] < (1 << 22)  # the digit sums stay below 2^31
        d = _dev(a)
        if d is not None:
            return cuda_ring.sum_axis(self, to_device(a, d), axis)
        return self.np_reduce(np.sum(np.asarray(a, np.int64), axis=axis))

    # -------------------------------------------------------------- bit ops

    def get_bit(self, a, bit_index: int):
        """Bit of the canonical value (0/1)."""
        d = bit_index // DIGIT_BITS
        r = bit_index % DIGIT_BITS
        return (a[..., d] >> r) & 1

    def bits_msb_first(self, a, nbits: int):
        """[..., nbits] bits of the canonical value, MSB first."""
        bits = [self.get_bit(a, nbits - 1 - j) for j in range(nbits)]
        return torch.stack(bits, dim=-1) if _dev(a) is not None else np.stack(bits, axis=-1)

    def trunc_low(self, a, m: int):
        """Keep the low m bits of the canonical value (RVec.Trunc)."""
        d, r = m // DIGIT_BITS, m % DIGIT_BITS
        out = a.clone() if isinstance(a, torch.Tensor) else np.asarray(a).copy()
        out[..., d + (1 if r > 0 else 0):] = 0
        if r > 0 and d < self.nlimb:
            out[..., d] &= (1 << r) - 1
        return out

    # ------------------------------------------------------------- sampling

    def rand(self, rng: np.random.Generator, shape) -> np.ndarray:
        """Uniform elements (negligible bias for p close to 2^{8L}), drawn
        as the reference draws them: nlimb bytes of rng.bytes per element."""
        shape = tuple(shape)
        count = int(math.prod(shape)) * self.nlimb
        raw8 = np.frombuffer(rng.bytes(count), np.uint8).reshape(shape + (self.nlimb,))
        if self.kind != "prime":
            raw = raw8.astype(np.int32)
            raw[..., -1] &= self.top_mask
            return raw
        if (1 << (8 * self.nlimb)) - self.modulus < (1 << 32):
            # p = 2^{8L} - delta with tiny delta: a raw byte draw lands in
            # [p, 2^{8L}) with probability delta/2^{8L} (2^-248 for p256),
            # statistically unreachable, so the canonicalizing subtract is
            # skipped (the Beaver-mask hot path)
            return raw8.astype(np.int32)
        raw = raw8.astype(np.int64)
        if self._nlib is not None:
            # raw < 2^{8L} < 2p: reduce is the single conditional subtract
            return self.np_reduce(raw)
        p = np.array(self._p_digits, dtype=np.int64)
        y = raw - p
        borrow = np.zeros(raw.shape[:-1], dtype=np.int64)
        for j in range(self.nlimb):
            t = y[..., j] + borrow
            borrow = t >> DIGIT_BITS
            y[..., j] = t - (borrow << DIGIT_BITS)
        ge = borrow == 0
        return np.where(ge[..., None], y, raw).astype(np.int32)

    def rand_bits(self, rng: np.random.Generator, shape, nbits: int) -> np.ndarray:
        """Uniform in [0, 2^nbits)."""
        shape = tuple(shape)
        count = int(math.prod(shape)) * self.nlimb
        raw = (
            np.frombuffer(rng.bytes(count), np.uint8)
            .reshape(shape + (self.nlimb,))
            .astype(np.int64)
        )
        d, r = nbits // DIGIT_BITS, nbits % DIGIT_BITS
        mask = np.zeros(self.nlimb, dtype=np.int64)
        mask[:d] = DIGIT_MASK
        if r > 0 and d < self.nlimb:
            mask[d] = (1 << r) - 1
        return (raw & mask).astype(np.int32)


# ---------------------------------------------------------------------------
# Shared ring instances: module singletons, one per (modulus, kind, native)

P256 = (1 << 256) - 189  # largest prime below 2^256
P127 = (1 << 127) - 1  # Mersenne prime

_RINGS = {}


def ring(modulus: int, kind: str, name: str = "", native: bool = True) -> Ring:
    """The shared Ring for (modulus, kind, native)."""
    key = (modulus, kind, bool(native))
    if key not in _RINGS:
        _RINGS[key] = Ring(modulus, kind, name, native)
    return _RINGS[key]


LElem256 = ring(P256, "prime", "LElem256")
LElem128 = ring(P127, "prime", "LElem128")
LElem2N256 = ring(1 << 256, "pow2", "LElem2N256")
LElem2N127 = ring(1 << 127, "pow2", "LElem2N127")

_POW2_OF = {P256: (1 << 256, "LElem2N256"), P127: (1 << 127, "LElem2N127")}


def field_for_size(field_size: int, native: bool = True) -> Ring:
    """Map config mpc_field_size to a prime field."""
    if field_size == 256:
        return ring(P256, "prime", "LElem256", native)
    if field_size == 128:
        return ring(P127, "prime", "LElem128", native)
    raise ValueError(f"unsupported mpc_field_size {field_size}")


def pow2_ring_for(field: Ring) -> Ring:
    """The power-of-two companion ring of the binary-share comparison
    protocols, with the field's engine choice."""
    if field.kind == "prime" and _RINGS.get((field.modulus, "prime", field.native)) is field:
        if field.modulus in _POW2_OF:
            mod, name = _POW2_OF[field.modulus]
            return ring(mod, "pow2", name, field.native)
    raise ValueError("no pow2 companion for ring")


class SmallField:
    """Small prime field for bit-share protocols (SElemDS/SElemC analogue).

    p = 46337 is the largest prime with p^2 < 2^31, so products of canonical
    elements fit int32 and are reduced after every multiply."""

    has_limbs = False
    host = True

    def __init__(self, p: int = 46337):
        self.modulus = p

    def __hash__(self):
        return hash(("small", self.modulus))

    def __eq__(self, other):
        return isinstance(other, SmallField) and other.modulus == self.modulus

    def zeros(self, shape):
        return np.zeros(shape, dtype=np.int32)

    def add(self, a, b):
        return (np.asarray(a) + np.asarray(b)) % self.modulus

    def sub(self, a, b):
        return (np.asarray(a) - np.asarray(b)) % self.modulus

    def neg(self, a):
        return (-np.asarray(a)) % self.modulus

    def mul(self, a, b):
        return (np.asarray(a) * np.asarray(b)) % self.modulus

    def matmul(self, A, B):
        """int64 accumulate then one mod (n * p^2 fits int64)."""
        out = np.asarray(A, np.int64) @ np.asarray(B, np.int64)
        return (out % self.modulus).astype(np.int32)

    def inv_int(self, v: int) -> int:
        return pow(int(v) % self.modulus, -1, self.modulus)

    def rand(self, rng: np.random.Generator, shape) -> np.ndarray:
        return rng.integers(0, self.modulus, size=shape, dtype=np.int64).astype(np.int32)


SElem = SmallField()


class GF2Ring:
    """GF(2) bit shares, unpacked: int8 arrays of 0/1 (BElem analogue)."""

    has_limbs = False
    modulus = 2
    host = True  # the GF(2) layer stays on the host in device mode too

    def __hash__(self):
        return hash("gf2")

    def __eq__(self, other):
        return isinstance(other, GF2Ring)

    def zeros(self, shape):
        return np.zeros(shape, dtype=np.int8)

    def add(self, a, b):
        return np.bitwise_xor(np.asarray(a), np.asarray(b))

    sub = add

    def neg(self, a):
        return a

    def mul(self, a, b):
        return np.bitwise_and(np.asarray(a), np.asarray(b))

    def rand(self, rng: np.random.Generator, shape) -> np.ndarray:
        shape = tuple(shape)
        n = int(math.prod(shape))
        raw = np.frombuffer(rng.bytes((n + 7) // 8), np.uint8)
        return np.unpackbits(raw)[:n].reshape(shape).astype(np.int8)


GF2 = GF2Ring()
