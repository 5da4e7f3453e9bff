"""CKKS parameter presets (counterpart of sfgwas_tpu/crypto/params.py).

The prime chains are the reference's, bit for bit: ~25-bit NTT primes, two
primes per rescale level, base primes for decode headroom and one special
prime for hybrid key switching (alpha = 1, per-prime digits).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from ..ops import rns


@dataclass(frozen=True)
class PresetSpec:
    logn: int
    levels: int  # rescale levels (2 primes each)
    prime_bits: int = 25
    base_primes: int = 3


# working levels of the BSGS matmult band (see CkksParams.mm_nmod)
MM_LEVELS = 2


def _pair_primes(q: list, base: int, prime_bits: int) -> list:
    """Order the modulus chain so every rescale pair (indices (base,base+1),
    (base+2,base+3), ...) is a magnitude-matched (+a, -b) couple around
    2^prime_bits; the same-sign leftovers become the base primes."""
    center = 1 << prime_bits
    npairs = (len(q) - base) // 2
    pos = sorted([p for p in q if p >= center], key=lambda p: p - center)
    neg = sorted([p for p in q if p < center], key=lambda p: center - p)
    pairs = []
    while len(pairs) < npairs and pos and neg:
        pairs.append((neg.pop(0), pos.pop(0)))
    left = pos + neg  # same-sign leftovers: pair adjacent magnitudes
    left.sort(key=lambda p: abs(p - center))
    while len(pairs) < npairs:
        pairs.append((left.pop(0), left.pop(0)))
    # best-matched pair on top (it defines the nominal scale)
    pairs.sort(key=lambda ab: abs(ab[0] * ab[1] / center**2 - 1), reverse=True)
    out = left + [p for ab in pairs for p in ab]
    assert len(out) == len(q) and sorted(out) == sorted(q)
    return out


PRESETS: Dict[str, PresetSpec] = {
    "PN12QP109": PresetSpec(logn=12, levels=1, prime_bits=18, base_primes=2),
    "PN13QP218": PresetSpec(logn=13, levels=3, prime_bits=22, base_primes=2),
    "PN14QP438": PresetSpec(logn=14, levels=7, prime_bits=25, base_primes=3),
    "PN15QP880": PresetSpec(logn=15, levels=15, prime_bits=25, base_primes=3),
    "PN16QP1761": PresetSpec(logn=16, levels=25, prime_bits=25, base_primes=6),
    # small insecure presets for fast tests
    "TEST8": PresetSpec(logn=8, levels=3, prime_bits=25, base_primes=3),
    "TEST10": PresetSpec(logn=10, levels=5, prime_bits=25, base_primes=3),
}


def prime_chain(spec: PresetSpec) -> Tuple[List[int], int]:
    """(ordered Q primes, special prime) of a preset, without the NTT tables."""
    nq = spec.base_primes + 2 * spec.levels
    primes = rns.gen_primes(nq + 1, spec.logn, spec.prime_bits)
    return _pair_primes(primes[:nq], spec.base_primes, spec.prime_bits), primes[nq]


class CkksParams:
    """Modulus chain + NTT basis + level bookkeeping.

    Rows [0, nq) of every poly array are the Q primes (base first); the
    special prime is the last row of the full basis."""

    def __init__(self, spec: PresetSpec):
        self.spec = spec
        self.logn = spec.logn
        self.n = 1 << spec.logn
        self.logslots = spec.logn - 1
        self.slots = 1 << self.logslots
        self.q_primes, self.special = prime_chain(spec)
        self.nq = len(self.q_primes)
        self.basis = rns.RnsBasis(self.q_primes + [self.special], spec.logn)
        self.sp_row = self.nq  # row index of the special prime
        # nominal scale: product of one level pair
        self.scale = float(self.q_primes[-1]) * float(self.q_primes[-2])
        self.base_nmod = spec.base_primes

    @property
    def mm_nmod(self) -> int:
        """The matmult working band: base primes + MM_LEVELS levels.
        Rotation keys are generated sliced to this band."""
        return min(self.nq, self.base_nmod + 2 * MM_LEVELS)

    def q_prod(self, nmod: int) -> int:
        """Q of the first nmod primes."""
        out = 1
        for q in self.q_primes[:nmod]:
            out *= q
        return out

    def __hash__(self):
        return hash((self.spec,))

    def __eq__(self, other):
        return isinstance(other, CkksParams) and other.spec == self.spec


_cache: Dict[str, CkksParams] = {}


def get_params(name: str) -> CkksParams:
    if name not in _cache:
        _cache[name] = CkksParams(PRESETS[name])
    return _cache[name]
