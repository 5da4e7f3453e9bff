"""RNS-CKKS in PyTorch (counterpart of sfgwas_tpu/crypto/ckks.py): keygen
(local and switching keys), encode/encrypt/decrypt, add/sub and constants,
plaintext and relinearising products, rescale, the hybrid keyswitch, single,
batched, hoisted and grouped rotations and the conjugation.

Polys are int32 residue tensors [nmod, N] in the bit-reversed NTT domain;
the special prime is the last row of the full basis.  Key switching uses
the alpha = 1 gadget: per-prime digits, switching keys
    ksk[j] = (-a_j s + e_j + (P mod q_j) * s_src * 1_{row j},  a_j).

On the card every NTT runs on kernel K1 (ops/cuda_ntt.py), every digit
contraction of a keyswitch on kernel K3 (ks_digit_product below, source
csrc/ks_digit.cu) and the threefry draw of uniform residues on kernel K4
(device_uniform_b below, source csrc/crp.cu).  ModUp's basis extension,
ModDown, the Galois gathers, the tensor product and the plaintext products
are plain torch with exact int64 products (ROADMAP B12, B13).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops import rns, threefry
from ..ops.cuda_build import CudaKernel, check, ptr
from ..ops.rns import _csub, _sel, add_mod, mul_mod, mul_mod_barrett, mul_mod_shoup, neg_mod, sub_mod
from ..utils.log import log
from .encoding import Encoder
from .params import CkksParams


def resolve_device(device=None) -> torch.device:
    """The CUDA card unless `device` names another; raises when no card is
    present and none was asked for (no quiet CPU fallback)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass
class Plaintext:
    poly: torch.Tensor  # [nmod, N], NTT domain
    nmod: int
    scale: float


@dataclass
class Ciphertext:
    c0: torch.Tensor  # [nmod, N], NTT domain
    c1: torch.Tensor
    nmod: int
    scale: float

    def copy(self) -> "Ciphertext":
        return Ciphertext(self.c0, self.c1, self.nmod, self.scale)


@dataclass
class SecretKey:
    s: torch.Tensor  # [nq+1, N] NTT domain (full basis)


@dataclass
class PublicKey:
    p0: torch.Tensor  # [nq+1, N]
    p1: torch.Tensor


@dataclass
class KSwitchKey:
    """d0/d1: [digits, rows, N]; digit j covers prime j."""

    d0: torch.Tensor
    d1: torch.Tensor


# ---------------------------------------------------------------------------
# Kernel K3: the keyswitch digit contraction

_P, _I = ctypes.c_void_p, ctypes.c_int
KS_DIGIT = CudaKernel("ks_digit", "ks_digit_product", [_P] * 7 + [_I] * 6)
KS_MAX_DIGITS = 24  # KMAX in csrc/ks_digit.cu: one template instance per digit count


def ks_digit_product_plain(ext, key0, key1, q):
    """Plain version of K3: ext [G, S, J, X, N], key* [G, Bk, J, X, N],
    q [X, 1] -> (out0, out1) [G, S, Bk, X, N] with
    out[g,s,b,x] = sum_j ext[g,s,j,x] * key[g,b,j,x] mod q_x.  Builds the
    [G, S, Bk, X, N] int64 product of every digit."""
    G, S, J, X, N = ext.shape
    Bk = key0.shape[1]
    acc0 = torch.zeros((G, S, Bk, X, N), dtype=torch.int64, device=ext.device)
    acc1 = torch.zeros_like(acc0)
    for j in range(J):
        e = ext[:, :, None, j].long()  # [G, S, 1, X, N]
        acc0 += e * key0[:, None, :, j].long()
        acc1 += e * key1[:, None, :, j].long()
    q64 = q.long().view(1, 1, 1, X, 1)
    return (
        torch.remainder(acc0, q64).to(torch.int32),
        torch.remainder(acc1, q64).to(torch.int32),
    )


def _ks_digit_shape(ext, key0, key1, q, mu, logn: int):
    """Validate K3's inputs from their metadata alone (no device read);
    returns (G, S, Bk, J, X, N).  Raises ValueError on what the kernel does
    not take; the launch refuses a ring smaller than the kernel's tile."""
    G, S, J, X, N = ext.shape
    Bk = key0.shape[1]
    if not 1 <= J <= KS_MAX_DIGITS:
        raise ValueError(f"ks_digit_product: {J} digits; the kernel has 1..{KS_MAX_DIGITS}")
    if N != 1 << logn:
        raise ValueError(f"ks_digit_product: N={N} is not 2^{logn}")
    dev = ext.device
    check(ext, "ext", dev)
    check(key0, "key0", dev, (G, Bk, J, X, N))
    check(key1, "key1", dev, (G, Bk, J, X, N))
    check(q, "q", dev, (X, 1))
    check(mu, "mu", dev, (X,), torch.int64)
    for name, t in (("ext", ext), ("key0", key0), ("key1", key1)):
        if t.data_ptr() % 16:
            raise ValueError(f"ks_digit_product: {name} is not 16-byte aligned")
    return G, S, Bk, J, X, N


def ks_digit_product(ext, key0, key1, q, mu, logn: int):
    """Kernel K3 for CUDA tensors (the plain version for CPU tensors);
    shapes as in ks_digit_product_plain, all int32 and contiguous; mu [X]
    int64 is rns.barrett_mu64 of the same rows (the kernel's Barrett
    constant; the plain version does not need it)."""
    if ext.device.type == "cpu":
        return ks_digit_product_plain(ext, key0, key1, q)
    G, S, Bk, J, X, N = _ks_digit_shape(ext, key0, key1, q, mu, logn)
    out0 = torch.empty((G, S, Bk, X, N), dtype=torch.int32, device=ext.device)
    out1 = torch.empty_like(out0)
    if out0.numel():
        KS_DIGIT.launch(
            ext.device, ptr(ext), ptr(key0), ptr(key1), ptr(out0), ptr(out1), ptr(q), ptr(mu),
            G, S, Bk, J, X, logn,
        )
    return out0, out1


# ---------------------------------------------------------------------------
# Kernel K4: threefry uniform residues (the common reference polynomials)

UNIFORM_MOD = CudaKernel(
    "crp", "uniform_mod", [_P, _P, _P] + [ctypes.c_uint] * 3 + [_I] * 3
)


def uniform_mod_plain(q, seed, idx: int, batch: int, n: int):
    """Plain version of K4: [batch, L, n] residues of the rows whose primes
    are q [L, 1], drawn as sfgwas_tpu/crypto/ckks.py::device_uniform_b draws
    them: words hi, lo of jax.random.bits(key, (2, batch, L, n)), folded as
    (hi mod q) * (2^32 mod q) + (lo mod q) mod q."""
    L = q.shape[0]
    total = batch * L * n
    key = threefry.derive_key(seed[0], seed[1], idx)
    hi = threefry.bits(key, 0, total, q.device).view(batch, L, n)
    lo = threefry.bits(key, total, total, q.device).view(batch, L, n)
    qv = q.long().view(1, L, 1)
    v = torch.remainder(hi, qv) * torch.remainder(torch.full_like(qv, 1 << 32), qv)
    return torch.remainder(v + torch.remainder(lo, qv), qv).to(torch.int32)


def uniform_mod(q, mu, seed, idx: int, batch: int, logn: int):
    """Kernel K4 for a CUDA q (the plain version for a CPU q): q [L, 1]
    int32 and mu [L] int64 (rns.barrett_mu64) of the rows; seed = (lo, hi)
    32-bit words, idx the draw's index; the kernel takes logn 2..20."""
    n = 1 << logn
    if q.device.type == "cpu":
        return uniform_mod_plain(q, seed, idx, batch, n)
    L = q.shape[0]
    check(q, "q", q.device, (L, 1))
    check(mu, "mu", q.device, (L,), torch.int64)
    out = torch.empty((batch, L, n), dtype=torch.int32, device=q.device)
    if out.numel():
        UNIFORM_MOD.launch(
            q.device, ptr(out), ptr(q), ptr(mu), int(seed[0]) & threefry.MASK,
            int(seed[1]) & threefry.MASK, int(idx) & threefry.MASK, batch, L, logn,
        )
    return out


def device_uniform_b(ctx: "CkksContext", rows, batch: int, seed, idx):
    """Counter-based uniform residues [batch, len(rows), N] on ctx's device,
    bit-equal to the reference's draw for the same (seed, idx, rows, batch)
    on every device: the CRP property that lets parties derive identical
    polynomials from a shared seed.  Kernel K4 unless ctx runs plain."""
    rows = tuple(rows)
    q = ctx._t(rows)["q"]
    if not ctx.kernels:
        return uniform_mod_plain(q, seed, int(idx), batch, ctx.n)
    mu = rns.barrett_mu64(ctx.basis, rows, ctx.device)
    return uniform_mod(q, mu, seed, int(idx), batch, ctx.params.logn)


class CkksContext:
    """CKKS operations on one device.  device=None means the CUDA card
    (raises without one); kernels=False runs the plain torch version of
    every kernel instead (used to hold the kernels against it on the card)."""

    def __init__(self, params: CkksParams, device=None, kernels: bool = True):
        self.params = params
        self.basis = params.basis
        self.device = resolve_device(device)
        self.kernels = kernels
        self.encoder = Encoder(params)
        self.n = params.n
        self.nq = params.nq
        self.sp_row = params.sp_row
        self.full_rows = tuple(range(self.nq + 1))
        dev = self.device
        q = np.array(self.basis.primes, dtype=np.uint64)
        # m32 = floor(2^32 / q): the reference's u32 Barrett constant
        self.m32 = rns.as_i32(((1 << 32) // q).astype(np.uint32))[:, None].to(dev)
        psp = params.special
        pinv = np.array([pow(psp, -1, qi) for qi in params.q_primes], dtype=np.uint32)
        self.pinv = rns.as_i32(pinv)[:, None].to(dev)
        self.pinv_s = rns.as_i32(
            rns.shoup(pinv[:, None], q[: self.nq].astype(np.uint32)[:, None])
        ).to(dev)
        self._qinv = self.basis.qinv
        self._qmod = self.basis.qmod
        self._exps = None
        self._exp_pos = None
        self._perm_cache: Dict[int, torch.Tensor] = {}
        self._const_cache: Dict = {}
        # tolerance-accepted scale drift on adds with no level left
        # (counted and surfaced, never silent)
        self.scale_drift_accepts = 0
        self.scale_drift_max = 0.0

    # ------------------------------------------------------------ helpers

    def _t(self, rows) -> Dict[str, torch.Tensor]:
        return _sel(self.basis, tuple(rows), self.device)

    def _ntt(self, x, rows, inverse: bool = False):
        return rns.ntt(x, self.basis, tuple(rows), inverse, plain=not self.kernels)

    def _ntt_b(self, x, rows, inverse: bool = False):
        return rns.ntt_b(x, self.basis, tuple(rows), inverse, plain=not self.kernels)

    def _ks_digit(self, ext, key0, key1, rows):
        q = self._t(rows)["q"]
        if not self.kernels:
            return ks_digit_product_plain(ext, key0, key1, q)
        mu = rns.barrett_mu64(self.basis, rows, self.device)
        return ks_digit_product(ext, key0, key1, q, mu, self.params.logn)

    def to_dev(self, a: np.ndarray) -> torch.Tensor:
        """uint32 residues (host) -> int32 tensor on this context's device."""
        return rns.as_i32(a).to(self.device)

    # ------------------------------------------------------------- sampling

    def sample_ternary(self, rng: np.random.Generator) -> np.ndarray:
        """Ternary secret/encryption randomness in {-1,0,1}, p=1/3 each."""
        return rng.integers(-1, 2, size=self.n, dtype=np.int64)

    def sample_gauss(self, rng: np.random.Generator, sigma: float = 3.19) -> np.ndarray:
        e = np.round(rng.normal(0, sigma, size=self.n)).astype(np.int64)
        return np.clip(e, -19, 19)

    def small_to_rns(self, small: np.ndarray, rows: Tuple[int, ...]) -> torch.Tensor:
        """Coeff-domain small signed ints -> NTT-domain residues on rows."""
        out = np.zeros((len(rows), self.n), dtype=np.uint32)
        for k, r in enumerate(rows):
            out[k] = np.mod(small, self.basis.primes[r]).astype(np.uint32)
        return self._ntt(self.to_dev(out), rows)

    def sample_uniform(self, rng: np.random.Generator, rows) -> torch.Tensor:
        return self.sample_uniform_b(rng, rows, 1)[0]

    def sample_uniform_b(self, rng: np.random.Generator, rows, batch: int) -> torch.Tensor:
        """Uniform residues [batch, len(rows), N]: one 64-bit draw folded
        per prime, as the reference draws them."""
        q = np.array([self.basis.primes[r] for r in rows], np.uint64)[None, :, None]
        raw = np.asarray(
            rng.bit_generator.random_raw(batch * len(rows) * self.n), dtype=np.uint64
        ).reshape(batch, len(rows), self.n)
        return self.to_dev((raw % q).astype(np.uint32))

    def small_to_rns_b(self, smalls: np.ndarray, rows) -> torch.Tensor:
        """[B, N] coeff-domain signed smalls (|v| < q) -> [B, len(rows), N]
        NTT-domain residues, reduced on the device."""
        v = torch.from_numpy(np.ascontiguousarray(smalls, np.int32)).to(self.device)
        q = self._t(rows)["q"][:, :, None]  # [L, 1, 1]
        res = torch.where(v[None] < 0, v[None] + q, v[None])  # [L, B, N]
        return self._ntt_b(res, rows).transpose(0, 1)

    # -------------------------------------------------------------- keygen

    def gen_secret_key(self, rng: np.random.Generator) -> SecretKey:
        return SecretKey(self.small_to_rns(self.sample_ternary(rng), self.full_rows))

    def gen_public_key(self, sk: SecretKey, rng: np.random.Generator) -> PublicKey:
        rows = self.full_rows
        a = self.sample_uniform(rng, rows)
        e = self.small_to_rns(self.sample_gauss(rng), rows)
        t = self._t(rows)
        p0 = add_mod(neg_mod(mul_mod_barrett(a, sk.s, t["q"], t["mu"]), t["q"]), e, t["q"])
        return PublicKey(p0, a)

    def _gadget_terms(self, s_src: torch.Tensor) -> torch.Tensor:
        """(P mod q_j) * s_src[j] per digit row j: [nq, N]."""
        return self._gadget_terms_b(s_src[None])[0]

    def kswitch_share(self, s_tgt, s_diag: Optional[torch.Tensor], a, e):
        """Switching-key share for all digits at once:
        share[j] = -a[j]*s_tgt + e[j] (+ (P mod q_j)*s_diag[j] at row j).
        a, e: [nq, nq+1, N]; returns [nq, nq+1, N]."""
        t = self._t(self.full_rows)
        q = t["q"][None]
        k0 = add_mod(neg_mod(mul_mod(a, s_tgt[None], q), q), e, q)
        if s_diag is not None:
            diag = torch.arange(self.nq, device=self.device)
            k0[diag, diag] = add_mod(
                k0[diag, diag], self._gadget_terms(s_diag), t["q"][: self.nq]
            )
        return k0

    def _gadget_terms_b(self, s_src_b: torch.Tensor) -> torch.Tensor:
        """(P mod q_j) * s_src_b[:, j] per digit row j: [B, nq, N]."""
        pj = np.array([self.params.special % qj for qj in self.params.q_primes], np.uint32)
        q = self._t(self.full_rows)["q"][None, : self.nq]
        return rns.mul_mod(s_src_b[:, : self.nq], self.to_dev(pj)[None, :, None], q)

    def kswitch_share_many(self, s_tgt, s_diag_b, a, e):
        """kswitch_share for B keys at once: s_diag_b [B, nq+1, N]; a, e
        [B, nq, nq+1, N] -> [B, nq, nq+1, N]."""
        q = self._t(self.full_rows)["q"]
        k0 = add_mod(neg_mod(mul_mod(a, s_tgt[None, None], q[None, None]), q[None, None]), e,
                     q[None, None])
        diag = torch.arange(self.nq, device=self.device)
        k0[:, diag, diag] = add_mod(
            k0[:, diag, diag], self._gadget_terms_b(s_diag_b), q[None, : self.nq]
        )
        return k0

    def gen_kswitch_key(self, s_src, sk: SecretKey, rng: np.random.Generator) -> KSwitchKey:
        """Key switching s_src -> sk (both [nq+1, N] NTT), all digits in one
        batched pass; the draws are the reference's."""
        a = self.sample_uniform_b(rng, self.full_rows, self.nq)
        e = self.small_to_rns_b(
            np.stack([self.sample_gauss(rng) for _ in range(self.nq)]), self.full_rows
        )
        return KSwitchKey(self.kswitch_share(sk.s, s_src, a, e), a)

    def gen_relin_key(self, sk: SecretKey, rng: np.random.Generator) -> KSwitchKey:
        return self.gen_kswitch_key(mul_mod(sk.s, sk.s, self._t(self.full_rows)["q"]), sk, rng)

    def gen_rot_key(self, sk: SecretKey, g: int, rng: np.random.Generator) -> KSwitchKey:
        return self.gen_kswitch_key(self.automorphism(sk.s, g), sk, rng)

    def kswitch_share_many_sliced(self, s_tgt, s_diag_b, a, e, key_nmod: int):
        """Switching-key shares for B keys restricted to the first key_nmod
        digits and rows (0..key_nmod-1, special): a, e [B, key_nmod,
        key_nmod+1, N] -> -a*s_tgt + e (+ (P mod q_j) * s_diag at row j)."""
        rows = tuple(range(key_nmod)) + (self.sp_row,)
        t = self._t(rows)
        q, mu = t["q"][None, None], t["mu"][None, None]
        st = s_tgt[torch.tensor(rows, device=self.device)]
        k0 = add_mod(neg_mod(mul_mod_barrett(a, st[None, None], q, mu), q), e, q)
        terms = self._gadget_terms_b(s_diag_b)[:, :key_nmod]  # [B, kn, N]
        diag = torch.arange(key_nmod, device=self.device)
        k0[:, diag, diag] = add_mod(k0[:, diag, diag], terms, t["q"][None, :key_nmod])
        return k0

    def gen_rot_keys_batched(
        self,
        sk: SecretKey,
        gels,
        rng: np.random.Generator,
        key_nmod: Optional[int] = None,
        chunk: int = 16,
    ) -> Dict[int, KSwitchKey]:
        """Local rotation keygen for many Galois elements, keys sliced to
        key_nmod digits/rows and resident on the device.  The uniform halves
        are threefry draws (device_uniform_b, kernel K4) seeded with two
        words from `rng`, one draw per chunk with the chunk's offset as its
        index, and the error terms consume `rng` after them: the reference's
        draws, so the same rng gives the reference's keys bit for bit."""
        key_nmod = min(key_nmod or self.nq, self.nq)
        rows = tuple(range(key_nmod)) + (self.sp_row,)
        nr = len(rows)
        seed = (
            int(rng.integers(0, 1 << 32, dtype=np.uint64)),
            int(rng.integers(0, 1 << 32, dtype=np.uint64)),
        )
        out: Dict[int, KSwitchKey] = {}
        for c0 in range(0, len(gels), chunk):
            gs = list(gels[c0 : c0 + chunk])
            B = len(gs)
            a = device_uniform_b(self, rows, B * key_nmod, seed, c0).reshape(
                B, key_nmod, nr, self.n
            )
            e = self.small_to_rns_b(
                np.stack([self.sample_gauss(rng) for _ in range(B * key_nmod)]), rows
            ).reshape(B, key_nmod, nr, self.n)
            s_g = self.automorphism_many(sk.s, gs)
            sh = self.kswitch_share_many_sliced(sk.s, s_g, a, e, key_nmod)
            for i, g in enumerate(gs):
                out[g] = KSwitchKey(sh[i], a[i])
        return out

    # ---------------------------------------------------------- encode path

    def encode(self, values, nmod: int, scale: Optional[float] = None) -> Plaintext:
        scale = scale or self.params.scale
        poly = self.encoder.encode(values, scale, nmod)
        return Plaintext(self._ntt(self.to_dev(poly), range(nmod)), nmod, scale)

    def decode(self, pt: Plaintext) -> np.ndarray:
        coeff = self._ntt(pt.poly, range(pt.nmod), inverse=True)
        return self.encoder.decode(rns.to_u32(coeff), pt.nmod, pt.scale)

    # --------------------------------------------------------- encrypt path

    def encrypt(self, pt: Plaintext, pk: PublicKey, rng: np.random.Generator) -> Ciphertext:
        nmod = pt.nmod
        rows = tuple(range(nmod))
        t = self._t(rows)
        v = self.small_to_rns(self.sample_ternary(rng), rows)
        e0 = self.small_to_rns(self.sample_gauss(rng), rows)
        e1 = self.small_to_rns(self.sample_gauss(rng), rows)
        q, mu = t["q"], t["mu"]
        c0 = add_mod(add_mod(mul_mod_barrett(v, pk.p0[:nmod], q, mu), e0, q), pt.poly, q)
        c1 = add_mod(mul_mod_barrett(v, pk.p1[:nmod], q, mu), e1, q)
        return Ciphertext(c0, c1, nmod, pt.scale)

    def decrypt(self, ct: Ciphertext, sk: SecretKey) -> Plaintext:
        t = self._t(range(ct.nmod))
        m = add_mod(ct.c0, mul_mod_barrett(ct.c1, sk.s[: ct.nmod], t["q"], t["mu"]), t["q"])
        return Plaintext(m, ct.nmod, ct.scale)

    # ------------------------------------------------------------- levels

    def drop_to(self, ct: Ciphertext, nmod: int) -> Ciphertext:
        """Drop moduli without rescaling (level alignment)."""
        assert nmod <= ct.nmod
        return Ciphertext(ct.c0[:nmod], ct.c1[:nmod], nmod, ct.scale)

    def _match(self, a: Ciphertext, b: Ciphertext):
        nmod = min(a.nmod, b.nmod)
        return self.drop_to(a, nmod), self.drop_to(b, nmod), tuple(range(nmod))

    def zero_ct(self, nmod: Optional[int] = None) -> Ciphertext:
        nmod = nmod or self.nq
        z = torch.zeros((nmod, self.n), dtype=torch.int32, device=self.device)
        return Ciphertext(z, z, nmod, self.params.scale)

    # ---------------------------------------------------------- arithmetic

    # Paired-prime rescaling leaves scales drifting off the preset scale by
    # the pair-product/Delta ratio.  Scales within _SCALE_EQ are absorbed by
    # keeping the first operand's scale; past it, add/sub and add_plain align
    # the operands exactly with a scale-targeted constant multiply and a
    # rescale; with no level left, only drift-sized mismatch (_SCALE_TOL) is
    # accepted, counted in scale_drift_accepts.
    _SCALE_EQ = 5e-4
    _SCALE_TOL = 2.5e-2

    def _accept_drift(self, s_a: float, s_b: float) -> None:
        drift = abs(s_a / s_b - 1)
        assert drift < self._SCALE_TOL, (s_a, s_b)
        self.scale_drift_accepts += 1
        self.scale_drift_max = max(self.scale_drift_max, drift)
        if self.scale_drift_accepts in (1, 10, 100, 1000, 10000):
            log(
                f"ckks: tolerance-aligned add #{self.scale_drift_accepts} "
                f"(rel drift {drift:.2e}, max {self.scale_drift_max:.2e})"
            )

    def _align_scales(self, a: Ciphertext, b: Ciphertext):
        """Bring two ciphertexts to exactly equal scales: the lower-scale
        operand is multiplied by a constant one encoded at the scale that
        retargets it onto the other's, then rescaled (one level)."""
        if abs(a.scale / b.scale - 1) < self._SCALE_EQ:
            return a, b
        if min(a.nmod, b.nmod) < self.params.base_nmod + 2:
            self._accept_drift(a.scale, b.scale)
            return a, b
        if a.scale < b.scale:
            a = self.rescale(self.mul_const_to(a, 1.0, b.scale))
        else:
            b = self.rescale(self.mul_const_to(b, 1.0, a.scale))
        return a, b

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        a, b = self._align_scales(a, b)
        a, b, rows = self._match(a, b)
        q = self._t(rows)["q"]
        return Ciphertext(add_mod(a.c0, b.c0, q), add_mod(a.c1, b.c1, q), a.nmod, a.scale)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        a, b = self._align_scales(a, b)
        a, b, rows = self._match(a, b)
        q = self._t(rows)["q"]
        return Ciphertext(sub_mod(a.c0, b.c0, q), sub_mod(a.c1, b.c1, q), a.nmod, a.scale)

    def neg(self, a: Ciphertext) -> Ciphertext:
        q = self._t(range(a.nmod))["q"]
        return Ciphertext(neg_mod(a.c0, q), neg_mod(a.c1, q), a.nmod, a.scale)

    def add_plain(self, a: Ciphertext, pt: Plaintext) -> Ciphertext:
        """A plaintext added to a ciphertext whose scale drifted off the
        plaintext's would misdecode the plaintext by the ratio, so the
        ciphertext is first retargeted onto the plaintext's scale where a
        level is left (else the counted drift tolerance applies)."""
        if abs(a.scale / pt.scale - 1) >= self._SCALE_EQ:
            if min(a.nmod, pt.nmod) >= self.params.base_nmod + 2:
                a = self.rescale(self.mul_const_to(a, 1.0, pt.scale))
            else:
                self._accept_drift(a.scale, pt.scale)
        nmod = min(a.nmod, pt.nmod)
        q = self._t(range(nmod))["q"]
        return Ciphertext(add_mod(a.c0[:nmod], pt.poly[:nmod], q), a.c1[:nmod], nmod, a.scale)

    def _mul_pair(self, c0, c1, p, nmod: int):
        q = self._t(range(nmod))["q"]
        return mul_mod(c0, p, q), mul_mod(c1, p, q)

    # ------------------------------------------------- plaintext products
    #
    # Plain torch with exact int64 products (ROADMAP B13): the reference's
    # XLA programs, ported as they are.

    def mul_plain(self, a: Ciphertext, pt: Plaintext) -> Ciphertext:
        nmod = min(a.nmod, pt.nmod)
        c0, c1 = self._mul_pair(a.c0[:nmod], a.c1[:nmod], pt.poly[:nmod], nmod)
        return Ciphertext(c0, c1, nmod, a.scale * pt.scale)

    def mul_plain_many_b(self, c0, c1, pts, nmod: int):
        """One ciphertext x B stacked plaintexts [B, nmod, N] -> B unrescaled
        product pairs ([B, nmod, N] x2)."""
        q = self._t(range(nmod))["q"]
        return mul_mod(c0[None], pts, q), mul_mod(c1[None], pts, q)

    def mul_plain_pairs_sum(self, c0s, c1s, pts, nmod: int):
        """sum_b ct_b * pt_b over B (ciphertext, plaintext) pairs ([B, nmod,
        N] each): the unrescaled (c0, c1) sum mod q."""
        q = self._t(range(nmod))["q"].long()
        p = pts.long()

        def dot(c):
            return torch.remainder(torch.remainder(c.long() * p, q).sum(0), q).to(torch.int32)

        return dot(c0s), dot(c1s)

    # ------------------------------------------ relinearising products

    def _tensor_product(self, ac0, ac1, bc0, bc1, nmod: int):
        """(d0, d1, d2) of two ciphertexts' components (any matching
        leading shape), plain torch with exact products (ROADMAP B12)."""
        q = self._t(range(nmod))["q"]
        d0 = mul_mod(ac0, bc0, q)
        d1 = add_mod(mul_mod(ac0, bc1, q), mul_mod(ac1, bc0, q), q)
        return d0, d1, mul_mod(ac1, bc1, q)

    @staticmethod
    def _key_rows(d0, d1, nmod: int):
        """A switching key's first nmod digits on the rows (0..nmod-1,
        special), as contiguous [nmod, nmod+1, N] copies (K3 reads them).
        The special row is the key's last row, whether the key holds the
        full basis or was sliced to a band."""
        ridx = torch.tensor(tuple(range(nmod)) + (int(d0.shape[1]) - 1,), device=d0.device)
        return d0[:nmod][:, ridx].contiguous(), d1[:nmod][:, ridx].contiguous()

    def _relin_b(self, d0, d1, d2, kd0, kd1, nmod: int):
        """Relinearise B tensor products d* [B, nmod, N] under one key: the
        digits of every d2 against the shared key on K3 (G 1, S B, Bk 1),
        then ModDown; returns (d0 + k0, d1 + k1)."""
        B = d2.shape[0]
        ext_rows = tuple(range(nmod)) + (self.sp_row,)
        ext = self.decompose_ntt_b(d2, nmod).contiguous()  # [B, nmod, next, N]
        k0, k1 = self._key_rows(kd0, kd1, nmod)
        acc0, acc1 = self._ks_digit(ext[None], k0[None, None], k1[None, None], ext_rows)
        q = self._t(range(nmod))["q"]
        k0s = self._moddown_b(acc0.view(B, nmod + 1, self.n), nmod)
        k1s = self._moddown_b(acc1.view(B, nmod + 1, self.n), nmod)
        return add_mod(d0, k0s, q), add_mod(d1, k1s, q)

    def mul_relin(self, a: Ciphertext, b: Ciphertext, rlk: KSwitchKey) -> Ciphertext:
        """The tensor product, then the unbatched keyswitch of d2 (K3 with
        S 1)."""
        a, b, rows = self._match(a, b)
        q = self._t(rows)["q"]
        d0, d1, d2 = self._tensor_product(a.c0, a.c1, b.c0, b.c1, a.nmod)
        k0, k1 = self._keyswitch_core_arr(d2, rlk.d0, rlk.d1, a.nmod)
        return Ciphertext(add_mod(d0, k0, q), add_mod(d1, k1, q), a.nmod, a.scale * b.scale)

    def mul_relin_many(self, a: Ciphertext, bs, rlk: KSwitchKey):
        """a * b_j for ciphertexts b_j at a's level: one batched
        relinearisation under the shared key."""
        nmod = min([a.nmod] + [b.nmod for b in bs])
        aa = self.drop_to(a, nmod)
        bsd = [self.drop_to(b, nmod) for b in bs]
        bc0 = torch.stack([b.c0 for b in bsd])
        bc1 = torch.stack([b.c1 for b in bsd])
        d = self._tensor_product(aa.c0[None], aa.c1[None], bc0, bc1, nmod)
        c0, c1 = self._relin_b(*d, rlk.d0, rlk.d1, nmod)
        return [Ciphertext(c0[j], c1[j], nmod, aa.scale * b.scale) for j, b in enumerate(bsd)]

    def mul_relin_pairs(self, xs, ys, rlk: KSwitchKey):
        """x_e * y_e over two equal-length ciphertext lists at a common
        level: one batched relinearisation for all pairs."""
        assert len(xs) == len(ys)
        nmod = min(min(x.nmod for x in xs), min(y.nmod for y in ys))
        xsd = [self.drop_to(x, nmod) for x in xs]
        ysd = [self.drop_to(y, nmod) for y in ys]
        d = self._tensor_product(
            torch.stack([x.c0 for x in xsd]), torch.stack([x.c1 for x in xsd]),
            torch.stack([y.c0 for y in ysd]), torch.stack([y.c1 for y in ysd]), nmod,
        )
        c0, c1 = self._relin_b(*d, rlk.d0, rlk.d1, nmod)
        return [
            Ciphertext(c0[j], c1[j], nmod, xsd[j].scale * ysd[j].scale) for j in range(len(xsd))
        ]

    # ------------------------------------------------------------- consts

    def const_poly(self, value: float, nmod: int, scale: float) -> torch.Tensor:
        """Residues of round(value*scale) as [nmod, 1] (a constant is the
        same in every NTT slot)."""
        c = int(round(value * scale))
        res = np.array([c % self.basis.primes[i] for i in range(nmod)], dtype=np.uint32)
        return self.to_dev(res)[:, None]

    def mul_const(self, ct: Ciphertext, value: float, scale: Optional[float] = None):
        """Multiply by a scalar encoded at `scale` (default: the preset
        scale); the caller rescales."""
        sc = scale or self.params.scale
        c0, c1 = self._mul_pair(ct.c0, ct.c1, self.const_poly(value, ct.nmod, sc), ct.nmod)
        return Ciphertext(c0, c1, ct.nmod, ct.scale * sc)

    def mul_const_to(self, ct: Ciphertext, value: float, target: float):
        """Multiply by a scalar encoded at the scale that makes the result
        land exactly at `target` after rescale() (SetScale)."""
        pair = float(self.basis.primes[ct.nmod - 1]) * float(self.basis.primes[ct.nmod - 2])
        return self.mul_const(ct, value, target * pair / ct.scale)

    def mul_const_int(self, ct: Ciphertext, value: int) -> Ciphertext:
        """Multiply by a small integer without a scale change."""
        res = np.array([value % self.basis.primes[i] for i in range(ct.nmod)], dtype=np.uint32)
        c0, c1 = self._mul_pair(ct.c0, ct.c1, self.to_dev(res)[:, None], ct.nmod)
        return Ciphertext(c0, c1, ct.nmod, ct.scale)

    def add_const(self, ct: Ciphertext, value: float) -> Ciphertext:
        q = self._t(range(ct.nmod))["q"]
        res = self.const_poly(value, ct.nmod, ct.scale)
        return Ciphertext(add_mod(ct.c0, res, q), ct.c1, ct.nmod, ct.scale)

    # ------------------------------------------------------------ rescale

    def rescale_one(self, ct: Ciphertext) -> Ciphertext:
        """Drop the top active prime, dividing the message by it."""
        nmod = ct.nmod
        assert nmod > self.params.base_nmod, (
            f"level underflow: rescale at nmod={nmod} "
            f"(base={self.params.base_nmod}); bootstrap first"
        )
        src = nmod - 1
        c0, c1 = self._rescale_pair(ct.c0, ct.c1, src)
        return Ciphertext(c0, c1, src, ct.scale / self.basis.primes[src])

    def _rescale_pair(self, c0, c1, src: int):
        out = self._rescale_poly_b(torch.stack([c0, c1]), src)
        return out[0], out[1]

    def _rescale2_pair(self, c0, c1, src: int):
        out = self.rescale2_many(torch.stack([c0, c1]), src)
        return out[0], out[1]

    def _rescale_poly(self, c, src: int, dst: Tuple[int, ...]):
        assert dst == tuple(range(src))
        return self._rescale_poly_b(c[None], src)[0]

    def rescale(self, ct: Ciphertext) -> Ciphertext:
        """One logical level = two primes (scale ~2^50), both components in
        one batched call."""
        nmod = ct.nmod
        assert nmod - 1 > self.params.base_nmod, (
            f"level underflow: rescale at nmod={nmod} "
            f"(base={self.params.base_nmod}); bootstrap first"
        )
        c = self.rescale2_many(torch.stack([ct.c0, ct.c1]), nmod - 1)
        return Ciphertext(
            c[0], c[1], nmod - 2,
            ct.scale / self.basis.primes[nmod - 1] / self.basis.primes[nmod - 2],
        )

    def rescale2_many(self, c, src: int):
        """Batched double-prime rescale: c [B, src+1, N] -> [B, src-1, N]."""
        c = self._rescale_poly_b(c, src)
        return self._rescale_poly_b(c, src - 1)

    def _rescale_poly_b(self, c, src: int):
        """c: [B, src+1, N] NTT -> [B, src, N] divided by q_src."""
        dst = tuple(range(src))
        top = self._ntt_b(c[:, src][None], (src,), True)[0]  # [B, N]
        ext = self._extend(top, src, dst)  # [len(dst), B, N] coeff
        ext = self._ntt_b(ext, dst).transpose(0, 1)  # [B, dst, N]
        t = self._t(dst)
        diff = sub_mod(c[:, :src], ext, t["q"])
        qinv, qinv_s = self._rescale_tables(src, dst)
        return mul_mod_shoup(diff, qinv, qinv_s, t["q"])

    def _rescale_tables(self, src: int, dst: Tuple[int, ...]):
        key = ("rsc", src, tuple(dst))
        if key not in self._const_cache:
            qinv = np.array([self._qinv[src, d] for d in dst], dtype=np.uint32)
            qinv_s = np.array(
                [(int(self._qinv[src, d]) << 32) // self.basis.primes[d] for d in dst],
                dtype=np.uint32,
            )
            self._const_cache[key] = (
                self.to_dev(qinv[:, None]), self.to_dev(qinv_s[:, None])
            )
        return self._const_cache[key]

    def _ext_tables(self, srcs: Tuple[int, ...], dst: Tuple[int, ...]):
        """Tables for centered base extension srcs -> dst: half [S],
        qd [D], corr [S, D] (q_s mod q_d)."""
        key = ("ext", tuple(srcs), tuple(dst))
        if key not in self._const_cache:
            qs = np.array([self.basis.primes[s] for s in srcs], np.uint64)
            qd = np.array([self.basis.primes[d] for d in dst], np.uint64)
            self._const_cache[key] = (
                self.to_dev((qs // 2).astype(np.uint32)),
                self.to_dev(qd.astype(np.uint32)),
                self.to_dev((qs[:, None] % qd[None, :]).astype(np.uint32)),
            )
        return self._const_cache[key]

    def _extend(self, v, src: int, dst: Tuple[int, ...]):
        """Centered base extension of coeff-domain residues v (prime src)
        to the dst primes.  [..., N] -> [len(dst), ..., N]."""
        half, qd, corr = self._ext_tables((src,), dst)
        D = len(dst)
        ex = (1,) * (v.dim() - 1)
        qdv = qd.view((D,) + ex + (1,))
        corrv = corr[0].view((D,) + ex + (1,))
        sign = v > half[0]
        r = _csub(_csub(v[None].expand((D,) + tuple(v.shape)), qdv), qdv)
        r_neg = torch.where(r >= corrv, r - corrv, r + qdv - corrv)
        return torch.where(sign[None], r_neg, r)

    def _extend_multi(self, v, srcs: Tuple[int, ...], dst: Tuple[int, ...]):
        """Per-row centered base extension: v [S, ..., N] with source prime
        srcs[i] for row i -> [S, len(dst), ..., N]."""
        half, qd, corr = self._ext_tables(srcs, dst)
        S, D = len(srcs), len(dst)
        ex = (1,) * (v.dim() - 2)
        qdv = qd.view((1, D) + ex + (1,))
        corrv = corr.view((S, D) + ex + (1,))
        sign = v > half.view((S,) + ex + (1,))
        r = v[:, None].expand((S, D) + tuple(v.shape[1:]))
        r = _csub(_csub(r, qdv), qdv)
        r_neg = torch.where(r >= corrv, r - corrv, r + qdv - corrv)
        return torch.where(sign[:, None], r_neg, r)

    # ---------------------------------------------------------- keyswitch

    def decompose_ntt(self, d, nmod: int):
        """ModUp of one poly: d [nmod, N] -> [nmod, nmod+1, N] (B = 1)."""
        return self.decompose_ntt_b(d[None], nmod)[0]

    def keyswitch_decomposed(self, ext_ntt, ksk: KSwitchKey, nmod: int):
        return self._keyswitch_decomposed_arr(ext_ntt, ksk.d0, ksk.d1, nmod)

    def _keyswitch_decomposed_arr(self, ext_ntt, d0, d1, nmod: int):
        """ext_ntt [nmod, nmod+1, N] against one key: keyswitch_decomposed_b
        with B = 1 (K3 with G 1, S 1) -> (k0, k1) [nmod, N]."""
        k0, k1 = self._key_rows(d0, d1, nmod)
        p0, p1 = self.keyswitch_decomposed_b(ext_ntt[None], k0[None], k1[None], nmod)
        return p0[0], p1[0]

    def keyswitch_core(self, d, ksk: KSwitchKey, nmod: int):
        """Switch NTT-domain poly d [nmod, N] (a c1-part under s_src) to the
        target key; returns (k0, k1) each [nmod, N]."""
        return self._keyswitch_core_arr(d, ksk.d0, ksk.d1, nmod)

    def _keyswitch_core_arr(self, d, d0, d1, nmod: int):
        return self._keyswitch_decomposed_arr(self.decompose_ntt(d, nmod), d0, d1, nmod)

    def keyswitch_decomposed_b(self, ext, k0, k1, nmod: int):
        """ext, k0, k1 [B, nmod, next, N], each ciphertext against its own
        key: the digit contraction on K3 (G B, S 1, Bk 1), then ModDown ->
        (p0, p1) [B, nmod, N]."""
        B = ext.shape[0]
        ext_rows = tuple(range(nmod)) + (self.sp_row,)
        acc0, acc1 = self._ks_digit(
            ext.contiguous()[:, None], k0.contiguous()[:, None], k1.contiguous()[:, None],
            ext_rows,
        )
        return (
            self._moddown_b(acc0.view(B, nmod + 1, self.n), nmod),
            self._moddown_b(acc1.view(B, nmod + 1, self.n), nmod),
        )

    def _moddown(self, x, nmod: int):
        """x: [nmod+1, N] over active+special (NTT) -> [nmod, N] = x/P."""
        return self._moddown_b(x[None], nmod)[0]

    def decompose_ntt_b(self, d, nmod: int):
        """Batched ModUp: d [B, nmod, N] NTT-domain -> [B, nmod, next, N]
        (a permuted view; next = nmod + 1 rows: active primes + special)."""
        rows = tuple(range(nmod))
        ext_rows = rows + (self.sp_row,)
        next_ = len(ext_rows)
        bsz = d.shape[0]
        d_coeff = self._ntt_b(d.transpose(0, 1), rows, True)  # [nmod, B, N]
        ext = self._extend_multi(d_coeff, rows, ext_rows)  # [nmod, next, B, N]
        ext = self._ntt_b(
            ext.permute(1, 0, 2, 3).reshape(next_, nmod * bsz, self.n), ext_rows
        ).view(next_, nmod, bsz, self.n)
        return ext.permute(2, 1, 0, 3)

    def _reduce_u32(self, x, rows: Tuple[int, ...]):
        """Reduce lazy digit sums x [..., len(rows), N] mod the rows'
        primes.  The reference reduces uint32 sums with a u32 Barrett step;
        here the sums are int64 and the remainder is exact."""
        return torch.remainder(x.long(), self._t(rows)["q"].long()).to(torch.int32)

    def _moddown_b(self, x, nmod: int):
        """x: [B, nmod+1, N] over active+special (NTT) -> [B, nmod, N] = x/P."""
        dst = tuple(range(nmod))
        sp = self._ntt_b(x[:, nmod][None], (self.sp_row,), True)[0]
        ext = self._extend(sp, self.sp_row, dst)  # [nmod, B, N]
        ext = self._ntt_b(ext, dst).transpose(0, 1)
        t = self._t(dst)
        diff = sub_mod(x[:, :nmod], ext, t["q"])
        return mul_mod_shoup(diff, self.pinv[:nmod], self.pinv_s[:nmod], t["q"])

    def hoisted_rotations_all(self, c0s, c1s, perms, ik0s, ik1s, nmod: int):
        """Hoisted rotations batched over ciphertext rows and shifts:
        c0s/c1s [s, nmod, N]; perms [B, N] Galois permutations; ik0s/ik1s
        [B, nmod, next, N] keys pre-permuted by sigma_b^{-1}
        (CryptoParams.stacked_keys_inv).  Returns (R0, R1) [B, s, nmod, N].

        sigma_b(ext_j) * k_bj = sigma_b(ext_j * sigma_b^{-1} k_bj): one
        decomposition of all s rows multiplies un-permuted against the
        inverse-permuted keys (kernel K3), and only the ModDown'ed result is
        permuted."""
        s = c0s.shape[0]
        Bn = perms.shape[0]
        ext_rows = tuple(range(nmod)) + (self.sp_row,)
        ext = self.decompose_ntt_b(c1s, nmod).contiguous()  # [s, nmod, next, N]
        acc0, acc1 = self._ks_digit(ext[None], ik0s[None], ik1s[None], ext_rows)
        k0 = self._moddown_b(acc0.view(s * Bn, nmod + 1, self.n), nmod)
        k1 = self._moddown_b(acc1.view(s * Bn, nmod + 1, self.n), nmod)
        shape = (s, Bn, nmod, self.n)
        pg = perms[None, :, None, :].expand(shape)
        k0 = torch.gather(k0.view(shape), -1, pg)
        k1 = torch.gather(k1.view(shape), -1, pg)
        c0g = torch.gather(c0s[:, None].expand(shape), -1, pg)
        R0 = add_mod(c0g, k0, self._t(range(nmod))["q"])
        return R0.transpose(0, 1), k1.transpose(0, 1)

    def rotate_grouped_b(self, c0s, c1s, perms, ik0s, ik1s, nmod: int):
        """Giant-step rotations batched over rows: c0s/c1s [R, s, nmod, N]
        (R rotation groups x s rows), perms [R, N], ik0s/ik1s
        [R, nmod, next, N] inverse-permuted keys shared by the s rows of
        each group.  Returns (r0, r1) [R, s, nmod, N]."""
        R, s = c0s.shape[0], c0s.shape[1]
        ext_rows = tuple(range(nmod)) + (self.sp_row,)
        ext = self.decompose_ntt_b(c1s.reshape(R * s, nmod, self.n), nmod)
        ext = ext.contiguous().view(R, s, nmod, nmod + 1, self.n)
        acc0, acc1 = self._ks_digit(ext, ik0s[:, None], ik1s[:, None], ext_rows)
        k0 = self._moddown_b(acc0.view(R * s, nmod + 1, self.n), nmod)
        k1 = self._moddown_b(acc1.view(R * s, nmod + 1, self.n), nmod)
        shape = (R, s, nmod, self.n)
        pg = perms[:, None, None, :].expand(shape)
        k0 = torch.gather(k0.view(shape), -1, pg)
        k1 = torch.gather(k1.view(shape), -1, pg)
        c0g = torch.gather(c0s, -1, pg)
        return add_mod(c0g, k0, self._t(range(nmod))["q"]), k1

    def rotate_batch(self, c0s, c1s, gs, k0s, k1s, nmod: int):
        """Rotate B stacked ciphertexts ([B, nmod, N] components), each by
        its own Galois element gs[b] under its own key k0s/k1s [B, nmod,
        next, N].  Returns (r0, r1) [B, nmod, N]."""
        perms = self.perms_for(gs)
        ext = self.decompose_ntt_b(c1s, nmod)  # [B, nmod, next, N]
        ext_g = torch.gather(ext, -1, perms[:, None, None, :].expand(ext.shape))
        c0g = torch.gather(c0s, -1, perms[:, None, :].expand(c0s.shape))
        k0, k1 = self.keyswitch_decomposed_b(ext_g, k0s, k1s, nmod)
        return add_mod(c0g, k0, self._t(range(nmod))["q"]), k1

    def hoisted_rotations_b(self, ct: Ciphertext, shifts, k0s, k1s):
        """One decomposition of c1 applied under every shift's Galois
        permutation with stacked keys k0s/k1s [B, nmod, next, N] (B = the
        nonzero shifts, in the order of `shifts`).  Returns (R0, R1)
        [len(shifts), nmod, N]; a zero shift holds the input ciphertext."""
        nmod = ct.nmod
        nz = [k % self.params.slots for k in shifts]
        gs = [self.galois_for_rotation(k) for k in nz if k != 0]
        if not gs:
            return ct.c0[None], ct.c1[None]
        perms = self.perms_for(gs)
        ext = self.decompose_ntt(ct.c1, nmod)  # [nmod, next, N]
        shape = (len(gs),) + tuple(ext.shape)
        ext_g = torch.gather(ext[None].expand(shape), -1, perms[:, None, None, :].expand(shape))
        c0g = torch.gather(ct.c0[None].expand(shape[:1] + ct.c0.shape), -1,
                           perms[:, None, :].expand(shape[:1] + ct.c0.shape))
        k0, k1 = self.keyswitch_decomposed_b(ext_g, k0s, k1s, nmod)
        r0 = add_mod(c0g, k0, self._t(range(nmod))["q"])
        if all(k != 0 for k in nz):
            return r0, k1
        out0, out1, j = [], [], 0
        for k in nz:
            if k == 0:
                out0.append(ct.c0)
                out1.append(ct.c1)
            else:
                out0.append(r0[j])
                out1.append(k1[j])
                j += 1
        return torch.stack(out0), torch.stack(out1)

    def hoisted_rotations(self, ct: Ciphertext, shifts, rot_keys):
        """Rotate one ciphertext by many shifts, decomposing c1 once (the
        automorphism commutes with the per-digit lift).  Returns {shift:
        Ciphertext}."""
        nmod = ct.nmod
        q = self._t(range(nmod))["q"]
        ext = self.decompose_ntt(ct.c1, nmod)
        out = {}
        for k in shifts:
            k = k % self.params.slots
            if k == 0:
                out[0] = ct.copy()
                continue
            g = self.galois_for_rotation(k)
            ext_g = self.automorphism(ext, g)
            k0, k1 = self.keyswitch_decomposed(ext_g, rot_keys[g], nmod)
            out[k] = Ciphertext(add_mod(self.automorphism(ct.c0, g), k0, q), k1, nmod, ct.scale)
        return out

    def rotate(self, ct: Ciphertext, k: int, rot_keys: Dict[int, KSwitchKey]) -> Ciphertext:
        if k % self.params.slots == 0:
            return ct.copy()
        g = self.galois_for_rotation(k)
        return self.apply_galois(ct, g, rot_keys[g])

    def conjugate(self, ct: Ciphertext, rot_keys: Dict[int, KSwitchKey]) -> Ciphertext:
        g = self.galois_conjugate()
        return self.apply_galois(ct, g, rot_keys[g])

    def apply_galois(self, ct: Ciphertext, g: int, key: KSwitchKey) -> Ciphertext:
        """sigma_g of both components, then the keyswitch of c1 back to the
        secret key (K3 with S 1)."""
        perm = self._perm_for(g)
        k0, k1 = self._keyswitch_core_arr(ct.c1[..., perm], key.d0, key.d1, ct.nmod)
        c0 = add_mod(ct.c0[..., perm], k0, self._t(range(ct.nmod))["q"])
        return Ciphertext(c0, k1, ct.nmod, ct.scale)

    # -------------------------------------------------------- automorphism

    def _exps_table(self) -> np.ndarray:
        """Exponent e(k) with NTT output slot k holding a(psi^{e(k)})."""
        if self._exps is not None:
            return self._exps
        q = self.basis.primes[0]
        n = self.n
        psi = rns._find_psi(q, 2 * n)
        # host NTT of X^1 on prime 0 (the same butterfly as the device NTT)
        x = np.zeros(n, dtype=object)
        x[1] = 1
        psi_rev = self.basis._np["psi"][0].astype(object)
        m = 1
        while m < n:
            half = n // (2 * m)
            xv = x.reshape(m, 2, half)
            S = psi_rev[m : 2 * m]
            U = xv[:, 0, :].copy()
            V = (xv[:, 1, :] * S[:, None]) % q
            x = np.stack([(U + V) % q, (U - V) % q], axis=1).reshape(n)
            m *= 2
        dlog = {}
        cur = 1
        for e in range(2 * n):
            dlog[cur] = e
            cur = (cur * psi) % q
        self._exps = np.array([dlog[int(v)] for v in x], dtype=np.int64)
        return self._exps

    def perm_np(self, g: int) -> np.ndarray:
        """Slot permutation of sigma_g in the NTT order (host int64)."""
        exps = self._exps_table()
        two_n = 2 * self.n
        if self._exp_pos is None:
            inv = np.zeros(two_n, np.int64)
            inv[exps] = np.arange(self.n, dtype=np.int64)
            self._exp_pos = inv
        return self._exp_pos[(exps * g) % two_n]

    def _perm_for(self, g: int) -> torch.Tensor:
        if g not in self._perm_cache:
            self._perm_cache[g] = torch.from_numpy(self.perm_np(g)).to(self.device)
        return self._perm_cache[g]

    def galois_inverse(self, g: int) -> int:
        """g^{-1} mod 2N: sigma_g^{-1} = sigma_{g^{-1}} (g is odd)."""
        return pow(int(g), -1, 2 * self.n)

    def _iperm_for(self, g: int) -> torch.Tensor:
        """Permutation of sigma_g^{-1} in the NTT slot order."""
        return self._perm_for(self.galois_inverse(g))

    def perms_for(self, gs) -> torch.Tensor:
        return torch.stack([self._perm_for(g) for g in gs])

    def iperms_for(self, gs) -> torch.Tensor:
        return torch.stack([self._iperm_for(g) for g in gs])

    def automorphism_many(self, poly, gs) -> torch.Tensor:
        """sigma_g(poly) for many Galois elements: [B, ...poly shape]."""
        perms = self.perms_for(gs)  # [B, N]
        shape = (len(gs),) + tuple(poly.shape)
        idx = perms.view((len(gs),) + (1,) * (poly.dim() - 1) + (-1,)).expand(shape)
        return torch.gather(poly[None].expand(shape), -1, idx)

    def automorphism(self, poly, g: int):
        """sigma_g in the NTT domain: a gather along the slot axis."""
        return poly[..., self._perm_for(g)]

    def galois_for_rotation(self, k: int) -> int:
        """Galois element for a left rotation by k slots."""
        return pow(5, k % self.params.slots, 2 * self.n)

    def galois_conjugate(self) -> int:
        return 2 * self.n - 1
