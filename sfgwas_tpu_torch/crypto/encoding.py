"""CKKS encode/decode on the host (counterpart of
sfgwas_tpu/crypto/encoding.py): the float64 canonical-embedding path for
plain data, and the exact path for the big masked values of the SS<->HE
conversions (encode_big/decode_big: the double-double FFT of
utils/ddfloat.py).

Slot layout: slots = N/2, slot j lives at the primitive 2N-th root of unity
with exponent 5^j mod 2N; conjugate pairs are filled for real vectors.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..ops import rns
from ..utils.ddfloat import dd_embed, dd_embed_inv
from .params import CkksParams


class Encoder:
    def __init__(self, params: CkksParams):
        self.params = params
        n = params.n
        self.n = n
        self.slots = params.slots
        two_n = 2 * n
        rot = np.zeros(self.slots, dtype=np.int64)
        g = 1
        for j in range(self.slots):
            rot[j] = g
            g = (g * 5) % two_n
        self.rot = rot
        self.pos = ((rot - 1) // 2).astype(np.int64)  # position of slot j
        conj = (two_n - rot) % two_n
        self.pos_conj = ((conj - 1) // 2).astype(np.int64)
        self.psi = np.exp(1j * np.pi * np.arange(n) / n)
        self.psi_inv = np.conj(self.psi)
        # folded real/imag twiddles for the batched diagonal encode
        self.psi_inv_re_over_n = np.real(self.psi_inv) / n
        self.psi_inv_im_over_n = -np.imag(self.psi_inv) / n

    def embed_inv(self, z: np.ndarray) -> np.ndarray:
        """slots (complex) -> real coefficient vector (float64, unrounded)."""
        A = np.zeros(self.n, dtype=np.complex128)
        A[self.pos] = z
        A[self.pos_conj] = np.conj(z)
        a = np.fft.fft(A) / self.n * self.psi_inv
        return np.real(a)

    def embed(self, coeffs: np.ndarray) -> np.ndarray:
        """real coefficients -> slot values (complex)."""
        A = np.conj(np.fft.fft(np.conj(np.asarray(coeffs, np.complex128) * self.psi)))
        return A[self.pos]

    def encode(self, values, scale: float, nmod: int) -> np.ndarray:
        """Real vector (len <= slots) -> RNS poly [nmod, N] uint32 (coeff
        domain)."""
        z = np.zeros(self.slots, dtype=np.complex128)
        v = np.asarray(values, dtype=np.float64)
        z[: len(v)] = v
        a = self.embed_inv(z) * scale
        coeffs = np.round(a)
        amax = float(np.abs(coeffs).max()) if coeffs.size else 0.0
        if amax < float(1 << 62):
            # hi*2^31 + lo split, both halves reduced per prime in uint64
            hi_f = np.floor(coeffs * (1.0 / (1 << 31)))
            lo = (coeffs - hi_f * float(1 << 31)).astype(np.uint64)
            hi = hi_f.astype(np.int64)
            qs = np.asarray(self.params.q_primes[:nmod], dtype=np.int64)
            him = (hi[None, :] % qs[:, None]).astype(np.uint64)
            qu = qs.astype(np.uint64)[:, None]
            r31 = (np.uint64(1 << 31) % qu).astype(np.uint64)
            res = (him * r31 % qu + lo[None, :] % qu) % qu
            return res.astype(np.uint32)
        ints = [int(x) for x in coeffs.astype(object)]
        return rns.ints_to_rns(ints, self.params.q_primes[:nmod])

    def decode(self, poly_coeff, nmod: int, scale: float) -> np.ndarray:
        """RNS poly [nmod, N] (coeff domain, uint32) -> real slot values."""
        ints = rns.rns_to_ints(np.asarray(poly_coeff), self.params.q_primes[:nmod])
        a = np.array([float(x) for x in ints]) / scale
        return np.real(self.embed(a))

    def encode_big(self, int_values: List[int], scale: float, nmod: int) -> np.ndarray:
        """Exact-ish encode of large integers (up to ~2^100) into slots at the
        given scale -> RNS poly [nmod, N] uint32 (coeff domain); used by the
        SS->HE conversion."""
        z = [0] * self.slots
        for i, v in enumerate(int_values):
            z[i] = int(v)
        coeff_ints = dd_embed_inv(self, z, scale)
        return rns.ints_to_rns(coeff_ints, self.params.q_primes[:nmod])

    def decode_big(self, poly_coeff, nmod: int, scale: float) -> List[int]:
        """Decode to (rounded) big integers; the absolute error stays O(1)
        even for ~2^100-magnitude slot values."""
        ints = rns.rns_to_ints(np.asarray(poly_coeff), self.params.q_primes[:nmod])
        return dd_embed(self, [int(x) for x in ints], scale)
