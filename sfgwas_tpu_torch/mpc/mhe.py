"""Collective (multiparty) CKKS protocols (counterpart of
sfgwas_tpu/mpc/mhe.py):

* the key bundle CryptoParams passed around the GWAS layers;
* collective key generation: per-party ternary key shards, the collective
  public key, the 2-round relinearisation key and the rotation keys, their
  uniform halves drawn as common reference polynomials (CRPs) from a stream
  seeded by the global PRG (CrpStream: threefry on kernel K4, the reference's
  stream bit for bit);
* collective decrypt: switch-to-zero-key shares aggregated at the hub;
* collective bootstrap: masked decryption, an exact CRT recode to the target
  primes (kernel K6) and a masked re-encryption; a party's share is kernel
  K5 (bs_share below, source csrc/bs_share.cu) with kernel K1 between its two
  launches;
* ciphertext transport and hub-rooted aggregation helpers.

Party 0 (the dealer) holds a zero key shard and takes part only where the
reference's protocol has it.  Tensors are shared between parties over the
zero-copy local transport and through the CRP memo (party 1's and party 2's
rotation keys hold the same CRP tensor): nothing here writes in place into a
tensor it received, memoised or broadcast.
"""

from __future__ import annotations

import ctypes
import math
import os
import threading
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..crypto import ckks as C
from ..crypto.params import CkksParams, get_params
from ..ops import rns, threefry
from ..ops.cuda_build import CudaKernel, check, ptr
from ..ops.rns import add_mod, mul_mod, neg_mod, sub_mod
from ..parallel.transport import Network
from ..utils import prof
from ..utils.log import log


@dataclass
class CryptoParams:
    """The key bundle: this party's key shard (zeros at the dealer), the
    collective public, relinearisation and rotation keys, and the party's
    local randomness."""

    ctx: C.CkksContext
    sk: C.SecretKey
    pk: C.PublicKey
    rlk: Optional[C.KSwitchKey]
    rot_keys: Dict[int, C.KSwitchKey] = field(default_factory=dict)
    enc_rng: np.random.Generator = None
    # True iff this bundle was restored from a key cache: only then are
    # ciphertexts cached by an earlier run decryptable (a fresh collective
    # keygen invalidates every stored ciphertext)
    keys_from_cache: bool = False
    _kstack: Dict = field(default_factory=dict, repr=False)
    # encoded mask-plaintext stacks of crypto/basics.py, per bundle (a
    # bundle's preset and levels are its own)
    _masks: Dict = field(default_factory=dict, repr=False)

    # device budget for cached stacks of level-sliced rotation keys
    _KSTACK_BUDGET = 4 * 1024**3

    @property
    def params(self) -> CkksParams:
        return self.ctx.params

    @property
    def slots(self) -> int:
        return self.ctx.params.slots

    @property
    def rot_nmod(self) -> int:
        """Highest level the rotation keys exist for (keys are stored sliced
        to the matmult working band)."""
        if not self.rot_keys:
            return self.ctx.nq
        return int(next(iter(self.rot_keys.values())).d0.shape[0])

    def clamp_rot(self, ct: C.Ciphertext) -> C.Ciphertext:
        """Drop a ciphertext into the rotation-key band."""
        band = self.rot_nmod
        return self.ctx.drop_to(ct, band) if ct.nmod > band else ct

    def _stack(self, key, build):
        if key not in self._kstack:
            d0, d1 = build()
            used = sum(a.nbytes + b.nbytes for a, b in self._kstack.values())
            if used + d0.nbytes + d1.nbytes > self._KSTACK_BUDGET:
                return d0, d1  # over budget: serve uncached
            self._kstack[key] = (d0, d1)
        return self._kstack[key]

    def _sliced(self, gelems, nmod: int):
        """Keys of gelems stacked and sliced to the active level:
        ([B, nmod, nmod+1, N], [B, ...]); the stored special row is the
        last row of each key."""
        assert nmod <= self.rot_nmod, (
            f"rotation at nmod={nmod} above the key band {self.rot_nmod}; "
            "clamp the ciphertext first (clamp_rot)"
        )
        some = self.rot_keys[gelems[0]]
        ridx = torch.tensor(
            tuple(range(nmod)) + (int(some.d0.shape[1]) - 1,), device=some.d0.device
        )
        d0 = torch.stack([self.rot_keys[g].d0[:nmod][:, ridx] for g in gelems])
        d1 = torch.stack([self.rot_keys[g].d1[:nmod][:, ridx] for g in gelems])
        return d0, d1

    def stacked_keys(self, gelems, nmod: int):
        """Rotation keys for the given Galois elements, stacked and sliced to
        the active level, cached per (gelems, nmod)."""
        return self._stack(
            (tuple(gelems), nmod), lambda: self._sliced(gelems, nmod)
        )

    def stacked_keys_inv(self, gelems, nmod: int):
        """stacked_keys pre-permuted by sigma_g^{-1} along the slot axis
        (for ckks.hoisted_rotations_all / rotate_grouped_b), gathered on the
        device."""

        def build():
            d0, d1 = self._sliced(gelems, nmod)
            ip = self.ctx.iperms_for(gelems)  # [B, N]
            idx = ip[:, None, None, :].expand(d0.shape)
            return torch.gather(d0, -1, idx), torch.gather(d1, -1, idx)

        return self._stack(("inv", tuple(gelems), nmod), build)

    def rotate(self, ct: C.Ciphertext, k: int) -> C.Ciphertext:
        """One left rotation through the cached level-sliced key path."""
        k = k % self.slots
        if k == 0:
            return ct.copy()
        return self._rotate_g(self.ctx.galois_for_rotation(k), ct)

    def conjugate(self, ct: C.Ciphertext) -> C.Ciphertext:
        return self._rotate_g(self.ctx.galois_conjugate(), ct)

    def _rotate_g(self, g: int, ct: C.Ciphertext) -> C.Ciphertext:
        ct = self.clamp_rot(ct)
        d0, d1 = self.stacked_keys([g], ct.nmod)
        r0, r1 = self.ctx.rotate_batch(ct.c0[None], ct.c1[None], [g], d0, d1, ct.nmod)
        return C.Ciphertext(r0[0], r1[0], ct.nmod, ct.scale)


# ---------------------------------------------------------------------------
# common reference polynomials


class CrpStream:
    """Common-reference polynomial stream.

    Draw i is derived statelessly from (seed, i) by threefry
    (ckks.device_uniform_b), so every party computes identical values with
    no shared generator state, and parties of one process (local-sim
    threads on one device) share one tensor per draw through a process-wide
    memo.  The CRP is public, so sharing does not change the trust model;
    the shared tensor is never written to."""

    _memo: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()
    _lock = threading.Lock()

    def __init__(self, seed: int):
        self.seed = int(seed) & ((1 << 64) - 1)
        self.i = 0

    def uniform_b(self, ctx: C.CkksContext, rows, batch: int) -> torch.Tensor:
        """[batch, len(rows), N] residues on ctx's device."""
        idx = self.i
        self.i += 1
        key = (self.seed, idx, tuple(rows), batch, ctx.n, str(ctx.device))
        with self._lock:
            hit = self._memo.get(key)
            if hit is not None:
                return hit
            val = C.device_uniform_b(
                ctx, tuple(rows), batch, (self.seed & 0xFFFFFFFF, self.seed >> 32), idx
            )
            self._memo[key] = val
            return val

    def uniform(self, ctx: C.CkksContext, rows) -> torch.Tensor:
        return self.uniform_b(ctx, rows, 1)[0]


def generate_rot_shifts(slots: int, small_dim: int = 20) -> List[int]:
    """Rotation shifts to generate keys for: powers of two (both
    directions), BSGS baby steps 1..d-1 and giant steps g*d (both
    directions), plus small shifts up to small_dim both ways."""
    shifts = set()
    p = 1
    while p < slots:
        shifts.add(p % slots)
        shifts.add((slots - p) % slots)
        p *= 2
    for k in range(1, small_dim + 1):
        shifts.add(k % slots)
        shifts.add((slots - k) % slots)
    d = int(math.ceil(math.sqrt(slots)))
    for b in range(1, d):
        shifts.add(b)
    for g in range(1, d + 1):
        shifts.add((g * d) % slots)
        shifts.add((slots - g * d) % slots)
    shifts.discard(0)
    return sorted(shifts)


# ---------------------------------------------------------------------------
# collective key generation


def collective_init(
    net: Network,
    params_name: str,
    extra_shifts: Optional[List[int]] = None,
    shifts_override: Optional[List[int]] = None,
    key_cache: Optional[str] = None,
    rot_key_nmod: Optional[int] = None,
    device=None,
) -> CryptoParams:
    """Interactive collective key generation.  shifts_override replaces the
    default rotation-key set; the rotation keys are sliced to rot_key_nmod
    (default: the matmult band).  device=None means the CUDA card.

    key_cache names a per-party file: when its directory cache
    (key_cache + ".d") or a legacy single .npz at key_cache exists, the
    whole bundle (this party's shard and the collective keys) is restored
    without the interactive protocol, and a fresh keygen writes the
    directory.  An iteration aid for repeated runs on one machine, not for
    production deployments.  The files are the JAX package's: uint32
    residues, so either package restores the other's."""
    params = get_params(params_name)
    ctx = C.CkksContext(params, device)
    pid = net.pid
    log(f"pid{pid} collective init start ({params_name})")

    kdir = key_cache + ".d" if key_cache else None
    if kdir and os.path.exists(os.path.join(kdir, "meta.npz")):
        cps = _load_key_dir(ctx, kdir)
        log(f"pid{pid} keys restored from {kdir}")
        return cps
    if key_cache and os.path.exists(key_cache):
        with np.load(key_cache) as z:
            gelems = [int(g) for g in z["gelems"]]
            cps = _restored(
                ctx, z["sk"], z["pk0"], z["pk1"], z["rlk0"], z["rlk1"],
                {g: C.KSwitchKey(ctx.to_dev(z[f"rk0_{g}"]), ctx.to_dev(z[f"rk1_{g}"]))
                 for g in gelems},
            )
        log(f"pid{pid} keys restored from {key_cache}")
        # migrate the legacy single-zip cache to the directory format and
        # drop the zip
        _save_key_dir(kdir, cps.sk, cps.pk, cps.rlk, cps.rot_keys)
        os.remove(key_cache)
        log(f"pid{pid} legacy key cache migrated to {kdir}")
        return cps

    # the CRP stream is seeded from the globally shared PRG
    with net.rand.using(-1) as g:
        crp_seed = int.from_bytes(g.bytes(8), "little")
    crp_rng = CrpStream(crp_seed)
    enc_rng = np.random.default_rng()  # local randomness

    if pid == 0:  # the dealer's shard is the zero key
        sk = C.SecretKey(torch.zeros((ctx.nq + 1, ctx.n), dtype=torch.int32, device=ctx.device))
    else:
        sk = ctx.gen_secret_key(enc_rng)

    with prof.span("ckg"):
        pk = collective_pubkey_gen(net, ctx, sk, crp_rng)
    with prof.span("rkg"):
        rlk = collective_relin_keygen(net, ctx, sk, crp_rng)

    if shifts_override is not None:
        shifts = sorted({s % params.slots for s in shifts_override} - {0})
    else:
        shifts = generate_rot_shifts(params.slots)
    if extra_shifts:
        shifts = sorted(set(shifts) | set(s % params.slots for s in extra_shifts))
    gelems = sorted({ctx.galois_for_rotation(s) for s in shifts} | {ctx.galois_conjugate()})
    key_nmod = rot_key_nmod or params.mm_nmod
    chunk = 8
    rot_keys: Dict[int, C.KSwitchKey] = {}
    with prof.span("rtg"):
        for c0 in range(0, len(gelems), chunk):
            rot_keys.update(
                collective_rotkey_gen_many(
                    net, ctx, sk, gelems[c0 : c0 + chunk], crp_rng, chunk, key_nmod=key_nmod
                )
            )
    log(f"pid{pid} collective init done ({len(rot_keys)} rotation keys)")
    if key_cache:
        _save_key_dir(kdir, sk, pk, rlk, rot_keys)
        log(f"pid{pid} keys cached to {kdir}")
    return CryptoParams(ctx, sk, pk, rlk, rot_keys, enc_rng)


def _restored(ctx: C.CkksContext, sk, pk0, pk1, rlk0, rlk1, rot_keys) -> CryptoParams:
    """A bundle restored from a key cache, with fresh local randomness."""
    return CryptoParams(
        ctx,
        C.SecretKey(ctx.to_dev(sk)),
        C.PublicKey(ctx.to_dev(pk0), ctx.to_dev(pk1)),
        C.KSwitchKey(ctx.to_dev(rlk0), ctx.to_dev(rlk1)),
        rot_keys,
        np.random.default_rng(),
        keys_from_cache=True,
    )


# bytes of a rotation-key stack copied to the device at a time
_KEY_COPY_BYTES = 64 << 20


def _stack_to_dev(ctx: C.CkksContext, path: str) -> torch.Tensor:
    """A stacked .npy of uint32 residues -> one int32 tensor on ctx's
    device, read through a memory map a few keys at a time (no second host
    copy of the whole stack)."""
    mm = np.load(path, mmap_mode="r")
    if mm.dtype != np.uint32:
        raise ValueError(f"{path}: residues must be uint32, found {mm.dtype}")
    out = torch.empty(mm.shape, dtype=torch.int32, device=ctx.device)
    step = max(1, _KEY_COPY_BYTES // mm[0].nbytes)
    for i in range(0, len(mm), step):
        out[i : i + step].copy_(rns.as_i32(mm[i : i + step]))
    return out


def _load_key_dir(ctx: C.CkksContext, kdir: str) -> CryptoParams:
    """Restore a bundle from the directory key cache: meta.npz holds the
    small keys and the Galois elements, rk0.npy / rk1.npy the rotation
    keys stacked in sorted Galois order."""
    with np.load(os.path.join(kdir, "meta.npz")) as z:
        meta = {k: z[k] for k in ("sk", "pk0", "pk1", "rlk0", "rlk1", "gelems")}
    rk0 = _stack_to_dev(ctx, os.path.join(kdir, "rk0.npy"))
    rk1 = _stack_to_dev(ctx, os.path.join(kdir, "rk1.npy"))
    gelems = [int(g) for g in meta.pop("gelems")]
    if len(gelems) != len(rk0) or rk0.shape != rk1.shape:
        raise ValueError(f"{kdir}: {len(gelems)} Galois elements for key stacks "
                         f"{tuple(rk0.shape)}, {tuple(rk1.shape)}")
    rot_keys = {g: C.KSwitchKey(rk0[i], rk1[i]) for i, g in enumerate(gelems)}
    return _restored(ctx, rot_keys=rot_keys, **meta)


def _save_key_dir(kdir: str, sk, pk, rlk, rot_keys):
    """The directory key cache: the small keys in meta.npz, the rotation
    keys as two stacked .npy files in sorted Galois order, each written key
    by key into its file; meta.npz last, so a directory without it is
    incomplete and ignored."""
    os.makedirs(kdir, exist_ok=True)
    order = sorted(rot_keys)
    for name, part in (("rk0.npy", "d0"), ("rk1.npy", "d1")):
        shape = (len(order),) + tuple(getattr(rot_keys[order[0]], part).shape)
        mm = np.lib.format.open_memmap(
            os.path.join(kdir, name), mode="w+", dtype=np.uint32, shape=shape
        )
        for i, g in enumerate(order):
            mm[i] = rns.to_u32(getattr(rot_keys[g], part))
        mm.flush()
        del mm
    np.savez(
        os.path.join(kdir, "meta.npz"),
        sk=rns.to_u32(sk.s),
        pk0=rns.to_u32(pk.p0),
        pk1=rns.to_u32(pk.p1),
        rlk0=rns.to_u32(rlk.d0),
        rlk1=rns.to_u32(rlk.d1),
        gelems=np.asarray(order, np.int64),
    )


def _as_dev(ctx: C.CkksContext, x) -> torch.Tensor:
    """A residue array as received (a tensor over the zero-copy transport,
    a numpy array over a codec) -> a tensor on ctx's device."""
    if isinstance(x, torch.Tensor):
        return x.to(ctx.device)
    return rns.as_i32(np.asarray(x)).to(ctx.device)


def _aggregate_mod(net: Network, ctx: C.CkksContext, x, rows):
    """Aggregate NTT-domain residue arrays modularly across the data
    parties (the dealer is left out), hub-rooted; over the zero-copy local
    transport the tensors stay on the device."""
    if net.pid == 0:
        return x
    q = ctx._t(rows)["q"]
    return _as_dev(ctx, net.aggregate(x, lambda a, b: add_mod(_as_dev(ctx, a), _as_dev(ctx, b), q)))


def collective_pubkey_gen(net: Network, ctx: C.CkksContext, sk, crp_rng) -> C.PublicKey:
    """CKG: share_i = -crp*s_i + e_i, summed; the dealer receives the sum
    from the hub."""
    rows = ctx.full_rows
    q = ctx._t(rows)["q"]
    crp = crp_rng.uniform(ctx, rows)  # the same at every party
    if net.pid == 0:
        share = torch.zeros((ctx.nq + 1, ctx.n), dtype=torch.int32, device=ctx.device)
    else:
        e = ctx.small_to_rns(ctx.sample_gauss(np.random.default_rng()), rows)
        share = add_mod(neg_mod(mul_mod(crp, sk.s, q), q), e, q)
    p0 = _aggregate_mod(net, ctx, share, rows)
    if net.pid == 0:
        p0 = _as_dev(ctx, net.recv(net.hub_pid))
    elif net.pid == net.hub_pid:
        net.send(p0, 0)
    return C.PublicKey(p0, crp)


def _gauss_b(ctx: C.CkksContext, rng, batch: int) -> np.ndarray:
    return np.stack([ctx.sample_gauss(rng) for _ in range(batch)])


def collective_relin_keygen(net: Network, ctx: C.CkksContext, sk, crp_rng) -> C.KSwitchKey:
    """2-round RKG, all digits batched.

    R1: h_j = sum_i (-u_i a_j + g_j s_i + e);  g_j = (P mod q_j) 1_{row j}
    R2: V_j = sum_i (s_i h_j + e)  and  W_j = sum_i (u_i a_j + e)
    Key: k0_j = V_j (= -u a_j s + g_j s^2 + e), k1_j = W_j (= u a_j + e)."""
    rows = ctx.full_rows
    q = ctx._t(rows)["q"][None]
    rng = np.random.default_rng()
    if net.pid == 0:  # the dealer's key is zero and never meets a ciphertext
        z = torch.zeros((ctx.nq, ctx.nq + 1, ctx.n), dtype=torch.int32, device=ctx.device)
        return C.KSwitchKey(z, z)
    a_all = crp_rng.uniform_b(ctx, rows, ctx.nq)  # [nq, nq+1, N]
    u_ntt = ctx.small_to_rns(ctx.sample_ternary(rng), rows)
    e = ctx.small_to_rns_b(_gauss_b(ctx, rng, ctx.nq), rows)
    h_agg = _aggregate_mod(net, ctx, ctx.kswitch_share(u_ntt, sk.s, a_all, e), rows)
    e1 = ctx.small_to_rns_b(_gauss_b(ctx, rng, ctx.nq), rows)
    e2 = ctx.small_to_rns_b(_gauss_b(ctx, rng, ctx.nq), rows)
    v_sh = add_mod(mul_mod(sk.s[None], h_agg, q), e1, q)
    w_sh = add_mod(mul_mod(u_ntt[None], a_all, q), e2, q)
    return C.KSwitchKey(_aggregate_mod(net, ctx, v_sh, rows), _aggregate_mod(net, ctx, w_sh, rows))


def collective_rotkey_gen_many(
    net: Network, ctx: C.CkksContext, sk, gelems, crp_rng, chunk: int = 8,
    key_nmod: Optional[int] = None,
) -> Dict[int, C.KSwitchKey]:
    """RTG for many Galois elements: each party's share is a switching key
    from sigma_g(s_i) to s_i, summed across parties; `chunk` keys share one
    CRP draw and one aggregation round.  Keys are restricted to their first
    key_nmod digits and rows (0..key_nmod-1, special): rotations only run in
    the matmult band."""
    key_nmod = min(key_nmod or ctx.nq, ctx.nq)
    rows = tuple(range(key_nmod)) + (ctx.sp_row,)
    nr, n = len(rows), ctx.n
    rng = np.random.default_rng()
    out: Dict[int, C.KSwitchKey] = {}
    for c0 in range(0, len(gelems), chunk):
        gs = gelems[c0 : c0 + chunk]
        B = len(gs)
        if net.pid == 0:
            # the dealer's keys are zero shares that never meet a real
            # ciphertext: it skips the CRP draws (its stream desyncs, which
            # is safe: later shared randomness uses fresh per-call seeds)
            z = torch.zeros((key_nmod, nr, n), dtype=torch.int32, device=ctx.device)
            for g_el in gs:
                out[g_el] = C.KSwitchKey(z, z)
            continue
        a_all = crp_rng.uniform_b(ctx, rows, B * key_nmod).reshape(B, key_nmod, nr, n)
        e_all = ctx.small_to_rns_b(_gauss_b(ctx, rng, B * key_nmod), rows).reshape(
            B, key_nmod, nr, n
        )
        s_g = ctx.automorphism_many(sk.s, gs)  # [B, nq+1, n]
        shares = ctx.kswitch_share_many_sliced(sk.s, s_g, a_all, e_all, key_nmod)
        d0 = _aggregate_mod(net, ctx, shares, rows)
        for i, g_el in enumerate(gs):
            out[g_el] = C.KSwitchKey(d0[i], a_all[i])
    return out


def collective_rotkey_gen(
    net: Network, ctx: C.CkksContext, sk, g_el: int, crp_rng, key_nmod: Optional[int] = None
) -> C.KSwitchKey:
    return collective_rotkey_gen_many(net, ctx, sk, [g_el], crp_rng, key_nmod=key_nmod)[g_el]


# ---------------------------------------------------------------------------
# collective decrypt


def collective_decrypt(net: Network, cps: CryptoParams, ct: C.Ciphertext, source_pid: int):
    """The plaintext at every data party (None at the dealer).
    source_pid > 0 broadcasts the ciphertext first; <= 0 means every data
    party holds it already."""
    out = collective_decrypt_many(net, cps, [ct], source_pid)
    return out[0] if out else None


def _nmod_groups(cts):
    """Ciphertext indices grouped by level, in a deterministic order (the
    same at every data party: the lists are shared in lockstep)."""
    groups: Dict[int, List[int]] = {}
    for i, ct in enumerate(cts):
        groups.setdefault(ct.nmod, []).append(i)
    return sorted(groups.items())


def collective_decrypt_many(net: Network, cps: CryptoParams, cts, source_pid: int):
    """Collective decrypt of many ciphertexts: one aggregation round per
    level group."""
    if net.pid == 0:
        return None
    ctx = cps.ctx
    if source_pid > 0:
        cts = broadcast_cvec(net, cps, cts, source_pid)
    out = [None] * len(cts)
    for nmod, idxs in _nmod_groups(cts):
        with prof.span("col_decrypt"):
            rows = tuple(range(nmod))
            q = ctx._t(rows)["q"]
            B = len(idxs)
            c0s = torch.stack([cts[i].c0 for i in idxs])
            c1s = torch.stack([cts[i].c1 for i in idxs])
            e = ctx.small_to_rns_b(
                np.stack([ctx.sample_gauss(cps.enc_rng, sigma=6.36) for _ in range(B)]), rows
            )
            share = add_mod(mul_mod(c1s, cps.sk.s[None, :nmod], q[None]), e, q)
            m = add_mod(c0s, _aggregate_mod(net, ctx, share, rows), q)
            for b, i in enumerate(idxs):
                out[i] = C.Plaintext(m[b], nmod, cts[i].scale)
    return out


# ---------------------------------------------------------------------------
# Kernel K5: a party's bootstrap share

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
# K5's mask in two variants, each with its own launch count: the register
# kernel (bs_mask_kernel<nwords>) and the generic one (bs_mask_generic_kernel)
BS_MASK = CudaKernel("bs_share", "bs_mask", [_P] * 10 + [_U] * 3 + [_I] * 7)
BS_MASK_GENERIC = CudaKernel("bs_share", "bs_mask_generic", [_P] * 8 + [_U] * 3 + [_I] * 6)
BS_COMBINE = CudaKernel("bs_share", "bs_combine", [_P] * 15 + [_I] * 4)
BS_MAX_WORDS = 96  # MAX_WORDS in csrc/bs_share.cu
BS_REG_WORDS = 18  # REG_WORDS there: the register kernel's most words
# the register kernel's blocks (N / 512 a b) below which warps share a run
# of coefficients (bs_mask_split): four blocks for each of the H100's 132 SMs
BS_SPLIT_BLOCKS = 4 * 132
_W24 = (1 << 24) - 1


def _mask_words(seed, idx: int, B: int, nwords: int, top_bits: int, n: int, device):
    """The mask's threefry words [nwords, B, n] (int64): jax.random.bits of
    shape (nwords, B, n), 24 bits each, the top word masked to top_bits and
    centred."""
    key = threefry.derive_key(seed[0], seed[1], idx)
    w = (threefry.bits(key, 0, nwords * B * n, device) & _W24).view(nwords, B, n)
    top = (w[-1] & ((1 << top_bits) - 1)) - (1 << (top_bits - 1))
    return torch.cat([w[:-1], top[None]])


def _fold_words(w, pw, q):
    """sum_k w_k * pw[:, k] mod q per row: w [K, B, n] signed int64, pw
    [L, K] int32 (2^(24k) mod q), q [L, 1] -> [L, B, n] int32."""
    L = pw.shape[0]
    acc = torch.zeros((L,) + tuple(w.shape[1:]), dtype=torch.int64, device=w.device)
    for k in range(w.shape[0]):
        acc += w[k][None] * pw[:, k].long().view(L, 1, 1)  # |acc| < K * 2^52
    return torch.remainder(acc, q.long().view(L, 1, 1)).to(torch.int32)


def bs_mask_plain(pw_l, pw_f, q_l, q_f, seed, idx: int, B: int, nwords: int, top_bits: int,
                  n: int):
    """Plain version of K5's bs_mask: the decryption mask of
    sfgwas_tpu/mpc/mhe.py::_bs_share_kernel (:601-627 before its NTT), in
    the coefficient domain, mod the rows of q_l ([L, B, n]) and of q_f
    ([Lf, B, n]); pw_* [rows, nwords] hold 2^(24k) mod q."""
    w = _mask_words(seed, idx, B, nwords, top_bits, n, q_l.device)
    return _fold_words(w, pw_l, q_l), _fold_words(w, pw_f, q_f)


def bs_lazy(q_max: int, nwords: int) -> bool:
    """Whether the register kernel's lazy fold is exact for a prime up to
    q_max: its sum of nwords Shoup terms and the centring constant, each
    below 2q, stays below 2^32."""
    return 2 * (nwords + 1) * q_max < 1 << 32


def bs_mask_variant(tl, tf, nwords: int, logn: int) -> str:
    """The kernel bs_mask launches for these tables: "register" for 1 to
    BS_REG_WORDS words when both row sets pass the lazy bound and N >= 4
    (a thread's 4 coefficients), else "generic"."""
    if nwords <= BS_REG_WORDS and tl["lazy"] and tf["lazy"] and logn >= 2:
        return "register"
    return "generic"


def bs_mask_split(B: int, logn: int) -> int:
    """The warps that share a run of 4 coefficients in the register kernel:
    1, or 2 or 4 where fewer than BS_SPLIT_BLOCKS blocks of 128 threads
    would leave the card's SMs idle; each split multiplies the blocks by
    itself."""
    blocks = B * -(-(1 << logn) // 512)
    split = 1
    while split < 4 and blocks * split < BS_SPLIT_BLOCKS:
        split *= 2
    return split


def bs_mask(tl, tf, seed, idx: int, B: int, nwords: int, top_bits: int, logn: int):
    """K5's bs_mask for CUDA tables (the plain version for CPU ones): tl, tf
    are the _bs_tables of the two row sets; bs_mask_variant picks the
    kernel."""
    n = 1 << logn
    if tl["q"].device.type == "cpu":
        return bs_mask_plain(tl["pw"], tf["pw"], tl["q"], tf["q"], seed, idx, B, nwords,
                             top_bits, n)
    if not 1 <= nwords <= BS_MAX_WORDS or not 1 <= top_bits <= 24:
        raise ValueError(f"bs_mask: {nwords} words of top {top_bits} bits; the kernel "
                         f"takes 1..{BS_MAX_WORDS} words and 1..24 bits")
    dev = tl["q"].device
    L, Lf = tl["q"].shape[0], tf["q"].shape[0]
    for side, t, rows in (("l", tl, L), ("f", tf, Lf)):
        check(t["pw"], f"pw_{side}", dev, (rows, nwords))
        check(t["ps"], f"ps_{side}", dev, (rows, nwords))
        check(t["q"], f"q_{side}", dev, (rows, 1))
        check(t["mu"], f"mu_{side}", dev, (rows,), torch.int64)
    out_l = torch.empty((L, B, n), dtype=torch.int32, device=dev)
    out_f = torch.empty((Lf, B, n), dtype=torch.int32, device=dev)
    key = (int(seed[0]) & threefry.MASK, int(seed[1]) & threefry.MASK, int(idx) & threefry.MASK)
    shape = (B, nwords, top_bits, L, Lf, logn)
    tables = (ptr(tl["pw"]), ptr(tf["pw"]), ptr(tl["ps"]), ptr(tf["ps"]), ptr(tl["q"]),
              ptr(tf["q"]))
    if bs_mask_variant(tl, tf, nwords, logn) == "register":
        BS_MASK.launch(dev, ptr(out_l), ptr(out_f), *tables, ptr(tl["mu"]), ptr(tf["mu"]), *key,
                       *shape, bs_mask_split(B, logn))
    else:
        BS_MASK_GENERIC.launch(dev, ptr(out_l), ptr(out_f), *tables, *key, *shape)
    return out_l, out_f


def bs_combine_plain(c1s, crp, sk, rows_l, rows_f, e1, mask_l, e2, mask_f, q_l, q_f):
    """Plain version of K5's bs_combine (_bs_share_kernel :636-647):
    h1 = c1*s + e1 + mask_l and h2 = -crp*s + e2 - mask_f.  c1s [B, L, N],
    crp [B, Lf, N]; e*, mask_* [rows, B, N]; rows_* int32 row indices of
    sk; q_* [rows, 1]."""
    ql, qf = q_l[None], q_f[None]
    sk_l, sk_f = sk[rows_l.long()][None], sk[rows_f.long()][None]
    h1 = add_mod(add_mod(mul_mod(c1s, sk_l, ql), e1.transpose(0, 1), ql),
                 mask_l.transpose(0, 1), ql)
    h2 = sub_mod(add_mod(neg_mod(mul_mod(crp, sk_f, qf), qf), e2.transpose(0, 1), qf),
                 mask_f.transpose(0, 1), qf)
    return h1, h2


def bs_combine(c1s, crp, sk, rows_l, rows_f, e1, mask_l, e2, mask_f, q_l, q_f, mu_l, mu_f,
               logn: int):
    """K5's bs_combine for CUDA tensors (the plain version for CPU ones);
    shapes as in bs_combine_plain, all contiguous; mu_* [rows] int64."""
    if c1s.device.type == "cpu":
        return bs_combine_plain(c1s, crp, sk, rows_l, rows_f, e1, mask_l, e2, mask_f, q_l, q_f)
    dev = c1s.device
    B, L, n = c1s.shape
    Lf = crp.shape[1]
    if n != 1 << logn:
        raise ValueError(f"bs_combine: N={n} is not 2^{logn}")
    check(c1s, "c1s", dev)
    check(crp, "crp", dev, (B, Lf, n))
    check(sk, "sk", dev)
    if sk.shape[1] != n:
        raise ValueError(f"bs_combine: sk {tuple(sk.shape)} for N={n}")
    check(rows_l, "rows_l", dev, (L,))
    check(rows_f, "rows_f", dev, (Lf,))
    check(e1, "e1", dev, (L, B, n))
    check(mask_l, "mask_l", dev, (L, B, n))
    check(e2, "e2", dev, (Lf, B, n))
    check(mask_f, "mask_f", dev, (Lf, B, n))
    check(q_l, "q_l", dev, (L, 1))
    check(q_f, "q_f", dev, (Lf, 1))
    check(mu_l, "mu_l", dev, (L,), torch.int64)
    check(mu_f, "mu_f", dev, (Lf,), torch.int64)
    h1 = torch.empty((B, L, n), dtype=torch.int32, device=dev)
    h2 = torch.empty((B, Lf, n), dtype=torch.int32, device=dev)
    BS_COMBINE.launch(
        dev, ptr(h1), ptr(h2), ptr(c1s), ptr(crp), ptr(sk), ptr(rows_l), ptr(rows_f), ptr(e1),
        ptr(mask_l), ptr(e2), ptr(mask_f), ptr(q_l), ptr(q_f), ptr(mu_l), ptr(mu_f),
        B, L, Lf, logn,
    )
    return h1, h2


def _bs_tables(ctx: C.CkksContext, rows, nwords: int):
    """Per row set: q [L, 1], mu [L], the row indices [L] int32, the word
    weights pw = 2^(24k) mod q [L, nwords] and their Shoup quotients ps =
    floor(pw 2^32 / q), and `lazy`: bs_lazy holds for the set's largest
    prime, as bs_mask's register kernel needs (csrc/bs_share.cu); cached
    on ctx."""
    key = ("bs", tuple(rows), nwords)
    if key not in ctx._const_cache:
        primes = [ctx.basis.primes[r] for r in rows]
        pw = [[pow(1 << (24 * k), 1, q) for k in range(nwords)] for q in primes]
        ps = [[(w << 32) // q for w in ws] for ws, q in zip(pw, primes)]
        ctx._const_cache[key] = {
            "q": ctx._t(rows)["q"],
            "mu": rns.barrett_mu64(ctx.basis, tuple(rows), ctx.device),
            "rows": torch.tensor(rows, dtype=torch.int32, device=ctx.device),
            "pw": ctx.to_dev(np.array(pw, np.uint32).reshape(len(rows), nwords)),
            "ps": ctx.to_dev(np.array(ps, np.uint32).reshape(len(rows), nwords)),
            "lazy": bs_lazy(max(primes), nwords),
        }
    return ctx._const_cache[key]


def bs_share(ctx: C.CkksContext, rows, tgt_rows, B: int, nwords: int, top_bits: int, seed,
             idx: int, crp, c1s, sk, e1, e2):
    """A party's refresh share (the reference's _bs_share_kernel): the
    threefry decryption mask (K5 bs_mask), its NTT on both row sets (K1),
    then h1 = c1*s + e1 + mask_l and h2 = -crp*s + e2 - mask_f (K5
    bs_combine).  c1s [B, L, N], crp [B, Lf, N], e1 [B, L, N], e2 [B, Lf,
    N], sk [nq+1, N]; returns (h1, h2).  Plain versions throughout when ctx
    runs plain."""
    rows, tgt_rows = tuple(rows), tuple(tgt_rows)
    tl, tf = _bs_tables(ctx, rows, nwords), _bs_tables(ctx, tgt_rows, nwords)
    logn = ctx.params.logn
    if ctx.kernels:
        mask_l, mask_f = bs_mask(tl, tf, seed, idx, B, nwords, top_bits, logn)
    else:
        mask_l, mask_f = bs_mask_plain(tl["pw"], tf["pw"], tl["q"], tf["q"], seed, idx, B,
                                       nwords, top_bits, ctx.n)
    mask_l = ctx._ntt_b(mask_l, rows)
    mask_f = ctx._ntt_b(mask_f, tgt_rows)
    # the noise of small_to_rns_b is a [B, rows, N] view of a [rows, B, N]
    # tensor: the transposes below are then copy-free
    e1 = e1.transpose(0, 1).contiguous()
    e2 = e2.transpose(0, 1).contiguous()
    args = (c1s.contiguous(), crp.contiguous(), sk, tl["rows"], tf["rows"], e1, mask_l, e2,
            mask_f, tl["q"], tf["q"])
    if not ctx.kernels:
        return bs_combine_plain(*args)
    return bs_combine(*args, tl["mu"], tf["mu"], logn)


# ---------------------------------------------------------------------------
# collective bootstrap


def collective_bootstrap(net: Network, cps: CryptoParams, ct: C.Ciphertext, source_pid: int):
    """Refresh to the top level: masked decryption, exact recode, masked
    re-encryption.  Returns the refreshed ciphertext (the dealer: its
    input)."""
    if net.pid == 0:
        return ct
    return collective_bootstrap_many(net, cps, [ct], source_pid)[0]


def _mask_bits(params: CkksParams, nmod: int, nparty: int):
    """(nwords, top_bits) of the decryption mask at nmod: a uniform mask of
    bits(Q_l) - 3 - ceil(log2(data parties)) bits, in 24-bit words."""
    ql_bits = params.q_prod(nmod).bit_length()
    bound_bits = ql_bits - 3 - int(math.ceil(math.log2(max(2, nparty - 1))))
    nwords = (bound_bits + 23) // 24
    return nwords, bound_bits - 24 * (nwords - 1)


def collective_bootstrap_many(
    net: Network, cps: CryptoParams, cts, source_pid: int, target_nmod: Optional[int] = None,
):
    """Batched collective bootstrap: per level group, one combined {h1, h2}
    aggregation round covers every ciphertext.

    target_nmod selects the refresh level (default: the top).  Below the
    top the refresh lifts two primes above the target, then multiplies each
    ciphertext by the constant that folds its drifted scale into the pair a
    double rescale divides out, so every output sits at exactly the preset
    scale (a hard scale-reset point).

    Over the zero-copy local transport the hub alone finalizes (masked
    decryption, NTT^-1, CRT lift on K6, NTT) and broadcasts the finished c0
    (the same at every party: the masked value is protocol-public); over
    another transport the hub broadcasts the aggregated shares and every
    party finalizes."""
    if net.pid == 0:
        return cts
    ctx = cps.ctx
    params = ctx.params
    if source_pid > 0:
        cts = broadcast_cvec(net, cps, cts, source_pid)
    rng = cps.enc_rng
    tgt = min(target_nmod or ctx.nq, ctx.nq)
    tgt = max(tgt, max(ct.nmod for ct in cts))
    reset = tgt + 2 <= ctx.nq
    lift_tgt = tgt + 2 if reset else tgt
    tgt_rows = tuple(range(lift_tgt))
    qf = ctx._t(tgt_rows)["q"]
    out = [None] * len(cts)
    zero_copy = getattr(net.t, "zero_copy", False)
    for nmod, idxs in _nmod_groups(cts):
        with prof.span("bootstrap"):
            rows = tuple(range(nmod))
            ql = ctx._t(rows)["q"]
            B = len(idxs)
            c0s = torch.stack([cts[i].c0 for i in idxs])
            c1s = torch.stack([cts[i].c1 for i in idxs])
            nwords, top_bits = _mask_bits(params, nmod, net.nparty)

            # CRPs of the re-encryption, from the shared seed (the same at
            # every party)
            with net.rand.using(-1) as g:
                seed = int.from_bytes(g.bytes(8), "little")
            crp = C.device_uniform_b(ctx, tgt_rows, B, (seed & 0xFFFFFFFF, seed >> 32), 0)
            with prof.span("bs_noise"):
                e1 = ctx.small_to_rns_b(np.stack([ctx.sample_gauss(rng) for _ in range(B)]), rows)
                e2 = ctx.small_to_rns_b(
                    np.stack([ctx.sample_gauss(rng) for _ in range(B)]), tgt_rows
                )
            with prof.span("bs_share"):
                mseed = (
                    int(rng.integers(0, 1 << 32, dtype=np.uint64)),
                    int(rng.integers(0, 1 << 32, dtype=np.uint64)),
                )
                h1, h2 = bs_share(ctx, rows, tgt_rows, B, nwords, top_bits, mseed, 0, crp,
                                  c1s, cps.sk.s, e1, e2)

            def add_fn(a, b):
                return {
                    "h1": add_mod(_as_dev(ctx, a["h1"]), _as_dev(ctx, b["h1"]), ql),
                    "h2": add_mod(_as_dev(ctx, a["h2"]), _as_dev(ctx, b["h2"]), qf),
                }

            with prof.span("bs_agg"):
                agg = net.hub_gather_sum({"h1": h1, "h2": h2}, add_fn)

            def finalize(a):
                # masked decryption, then the exact recode to the target
                # primes: the masked value is bounded by the mask (<< Q_l/4),
                # so the float-assisted basis extension (K6) is exact
                mu = add_mod(c0s, _as_dev(ctx, a["h1"]), ql)  # [B, l, N]
                mu_coeff = ctx._ntt_b(mu.transpose(0, 1), rows, True)  # [l, B, N]
                with prof.span("bs_crt_lift"):
                    lifted = rns.crt_lift_centered_dev(
                        mu_coeff.reshape(nmod, B * ctx.n), ctx.basis, rows, tgt_rows,
                        plain=not ctx.kernels,
                    ).reshape(lift_tgt, B, ctx.n)
                mu_full = ctx._ntt_b(lifted, tgt_rows).transpose(0, 1)
                return add_mod(mu_full, _as_dev(ctx, a["h2"]), qf)

            if zero_copy:
                c0 = _as_dev(ctx, net.hub_broadcast(
                    finalize(agg) if net.pid == net.hub_pid else None
                ))
            else:
                c0 = finalize(net.hub_broadcast(agg if net.pid == net.hub_pid else None))

            if reset:
                # per-ciphertext constant c_b = round(Delta * pair / s_b):
                # the output scale is the preset Delta exactly
                pair = float(params.q_primes[lift_tgt - 1]) * float(params.q_primes[lift_tgt - 2])
                consts = np.empty((B, lift_tgt, 1), np.uint32)
                for b, i in enumerate(idxs):
                    # only drift-sized inputs: a scale far off the preset is a
                    # level-accounting fault upstream
                    assert 0.25 < params.scale / cts[i].scale < 4.0, (params.scale, cts[i].scale)
                    cval = int(round(params.scale * pair / cts[i].scale))
                    for r in range(lift_tgt):
                        consts[b, r, 0] = cval % params.q_primes[r]
                cj = ctx.to_dev(consts)
                res = ctx.rescale2_many(
                    torch.cat([mul_mod(c0, cj, qf[None]), mul_mod(crp, cj, qf[None])]),
                    lift_tgt - 1,
                )
                for b, i in enumerate(idxs):
                    out[i] = C.Ciphertext(res[b], res[B + b], tgt, params.scale)
            else:
                for b, i in enumerate(idxs):
                    out[i] = C.Ciphertext(c0[b], crp[b], tgt, cts[i].scale)
    return out


def bootstrap_vec(net, cps, cv, source_pid, target_nmod=None):
    if net.pid == 0:
        return cv
    return collective_bootstrap_many(net, cps, cv, source_pid, target_nmod)


def bootstrap_mat(net, cps, cm, source_pid, target_nmod=None):
    if net.pid == 0:
        return cm
    flat = [ct for row in cm for ct in row]
    ref = collective_bootstrap_many(net, cps, flat, source_pid, target_nmod)
    out, ofs = [], 0
    for row in cm:
        out.append(ref[ofs : ofs + len(row)])
        ofs += len(row)
    return out


def bootstrap_mat_all(net, cps, cm, target_nmod=None):
    """Every data party's matrix refreshed in one combined round: each
    source broadcasts its ciphertexts (after announcing its per-row counts,
    so unbalanced partitions stay in lockstep), then one
    collective_bootstrap_many covers the union."""
    if net.pid == 0:
        return cm
    shapes = {}
    my_shape = [len(row) for row in cm]
    for source in range(1, net.nparty):
        if net.pid == source:
            for p in range(1, net.nparty):
                if p != source:
                    net.send(my_shape, p)
            shapes[source] = my_shape
        else:
            shapes[source] = net.recv(source)
    flat = []  # source-major; each source broadcasts its block
    for source in range(1, net.nparty):
        total = sum(shapes[source])
        blk = [ct for row in cm for ct in row] if net.pid == source else [None] * total
        flat.extend(broadcast_cvec(net, cps, blk, source))
    ref = collective_bootstrap_many(net, cps, flat, -1, target_nmod)
    ofs = sum(sum(shapes[s]) for s in range(1, net.pid))  # this party's slice
    out, pos = [], ofs
    for row in cm:
        out.append(ref[pos : pos + len(row)])
        pos += len(row)
    return out


# ---------------------------------------------------------------------------
# ciphertext transport and aggregation


def ct_to_wire(ct: C.Ciphertext):
    # the components stay on the device: the local transport passes them by
    # reference; only a codec reads them back
    return {"c0": ct.c0, "c1": ct.c1, "nmod": ct.nmod, "scale": float(ct.scale)}


def ct_from_wire(d, device=None) -> C.Ciphertext:
    """A ciphertext from its wire dict: tensors are kept as they are, numpy
    arrays (from a codec) become int32 tensors on `device` (the CPU if
    None)."""

    def t(x):
        if isinstance(x, torch.Tensor):
            return x
        x = rns.as_i32(np.asarray(x))
        return x if device is None else x.to(device)

    return C.Ciphertext(t(d["c0"]), t(d["c1"]), int(d["nmod"]), float(d["scale"]))


def send_ciphertext(net: Network, ct: C.Ciphertext, to: int):
    net.send(ct_to_wire(ct), to)


def recv_ciphertext(net: Network, frm: int, device=None) -> C.Ciphertext:
    return ct_from_wire(net.recv(frm), device)


def broadcast_ciphertext(net: Network, cps, ct, source_pid: int) -> C.Ciphertext:
    if net.pid == source_pid:
        for p in range(1, net.nparty):
            if p != source_pid:
                net.send(ct_to_wire(ct), p)
        return ct
    if net.pid > 0:
        return ct_from_wire(net.recv(source_pid), cps.ctx.device)
    return ct


def broadcast_cvec(net: Network, cps, cts, source_pid: int):
    """Broadcast a whole ciphertext list in one message (the receivers may
    pass a placeholder list; the wire carries the real ones)."""
    if net.pid == source_pid:
        wire = [ct_to_wire(ct) for ct in cts]
        for p in range(1, net.nparty):
            if p != source_pid:
                net.send(wire, p)
        return cts
    if net.pid > 0:
        return [ct_from_wire(d, cps.ctx.device) for d in net.recv(source_pid)]
    return cts


def aggregate_ct(net: Network, cps: CryptoParams, ct: C.Ciphertext) -> C.Ciphertext:
    """Sum a ciphertext across the data parties."""
    if net.pid == 0:
        return ct
    return aggregate_cvec(net, cps, [ct])[0]


def aggregate_cvec(net, cps, cv):
    """Sum ciphertext vectors across the data parties in one aggregation
    message; per position the levels may differ across parties, and the add
    aligns each pair (ckks.add)."""
    if net.pid == 0:
        return cv
    ctx = cps.ctx

    def add_fn(a, b):
        return [
            ct_to_wire(ctx.add(ct_from_wire(da, ctx.device), ct_from_wire(db, ctx.device)))
            for da, db in zip(a, b)
        ]

    out = net.aggregate([ct_to_wire(ct) for ct in cv], add_fn)
    return [ct_from_wire(d, ctx.device) for d in out]


def aggregate_cmat(net, cps, cm):
    if net.pid == 0:
        return cm
    flat = [ct for row in cm for ct in row]
    if not flat:
        return cm
    agg = aggregate_cvec(net, cps, flat)
    out, ofs = [], 0
    for row in cm:
        out.append(agg[ofs : ofs + len(row)])
        ofs += len(row)
    return out


def aggregate_int_vec(net: Network, vec: np.ndarray) -> np.ndarray:
    if net.pid == 0:
        return vec
    return np.asarray(net.aggregate(np.asarray(vec), lambda a, b: np.asarray(a) + np.asarray(b)))
