"""Secure matrix multiplication: ciphertext row-vectors times plaintext int8
genotype blocks via BSGS generalized diagonals (the device-resident, dense
path of sfgwas_tpu/gwas/matmult.py).

Per block row, one hoisted keyswitch batch rotates every A row by every
needed baby shift; the diagonal multiply-accumulate of the whole block row
is one launch of kernel K2 (mac_dense below, source csrc/mac_dense.cu) over
a CSR list of accumulator runs that the plan builds on the host; the
giant-step rotations of all accumulated groups run as one grouped
keyswitch; a combine per block column and one batched double rescale
finish.  Diagonals are encoded once (preprocess_matrix) and stay on the
device, or, for a matrix whose encoded diagonals would not fit the card
(PCA's X and X^T at example scale), stay on the host as pre-NTT integer
chunks (host_block_diagonals, spilled to .npy files and memory-mapped back)
and are reduced and NTT'd on the device just for the rows each MAC launch
reads, in groups bounded by a byte budget.  Nothing in a product reads a
value back from the device.

Within-party sharding (mat_mult_sharded, or set_pipeline_devices for every
product) splits each block row's MAC launch by shard slot (block column bj
goes to slot bj % len(devices)); each slot's launch runs on its device on
fresh accumulators, which are added on the party's device.  All arithmetic
is exact, so the result is the single-device one bit for bit.

The streamed product (mat_mult_stream) encodes one genotype block, on the
host (preprocess_matrix_host, safe on a prefetch thread) and then on the
device (finish_preprocess_matrix), multiplies it once and releases its
plan; dc_matmul_aat_b is the distributed A A^T B over row-partitioned A;
qx_lazy_norm_stream and qxt_lazy_norm_stream are the lazily normalised
products of the PCA power iteration; the cmult_mat_* helpers are the
ciphertext-by-ciphertext products of the logistic path (slot masks and
full-slot rotate-and-add sums).
"""

from __future__ import annotations

import ctypes
import math
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..crypto import basics as B
from ..crypto import ckks as C
from ..crypto.params import MM_LEVELS
from ..mpc import mhe
from ..mpc.mhe import CryptoParams
from ..ops import rns
from ..ops.cuda_build import CudaKernel, check, ptr
from ..ops.rns import add_mod
from ..parallel.mesh import local_devices
from ..utils import prof

# diagonal polys per MAC chunk are bounded by this many bytes (per A row);
# a giant group longer than that is split over several chunks
MM_CHUNK_BYTES = 256 * 1024 * 1024
# kernel K2 sums the raw products of one accumulator run in a uint64: every
# prime is below 2^26, so a run of up to 4096 terms, each (q-1)^2 < 2^52 at
# most, stays below 2^64
MAC_MAX_TERMS = 4096
_PLAIN_STEP = 64  # entries per int64 product in the plain MAC
_ENC_STEP = 1024  # diagonals per host FFT batch
# host-streamed plans: bytes of diagonal polys materialised on the device per
# MAC launch (the bounded working set of the streaming mode)
STREAM_GROUP_BYTES = 1 << 30
# the giant step keyswitches at most this many bytes of accumulated
# ciphertexts (c1) at once: its basis extension holds ~nmod+1 times as much,
# so the 15 rows of PCA's 183-segment cache go in 5 grouped keyswitches (one
# would hold ~30 GB); a block product of 8 or fewer rows at the example's
# shapes stays one grouped keyswitch
GIANT_BATCH_BYTES = 256 << 20

# within-party sharding for every product: when set (shard_matmult at
# protocol init), each mat_mult_cached call without devices= splits its MAC
# launches over these devices
_pipeline_devices: Optional[list] = None


def set_pipeline_devices(devices) -> None:
    """Route every later product over `devices`; a list of fewer than two
    (or None) routes nothing."""
    global _pipeline_devices
    _pipeline_devices = list(devices) if devices and len(devices) > 1 else None


def mm_nmod(cps: CryptoParams) -> int:
    return cps.params.base_nmod + 2 * MM_LEVELS


class DiagBlock:
    """Encoded diagonals of one slots x slots block of the plaintext matrix
    with their (giant, baby) indices, in one of two residencies:
    * device: `polys` holds the [K, nmod, N] int32 NTT-domain stack;
    * host-streaming: `chunks` holds the pre-NTT integer coefficients of the
      host encode as (hi, lo, kc) chunks of <= 1024 diagonals; a product
      materialises on the device just the rows each MAC launch reads
      (materialize_rows), so the working set stays bounded however long the
      SNP axis is (the Go sfgwas's DiagCacheStream, gwas/filestream.go)."""

    def __init__(self, giants, babies, polys, d, chunks=None):
        self.giants = np.asarray(giants, np.int32)  # [K]
        self.babies = np.asarray(babies, np.int32)  # [K]
        self.polys = polys  # [K, nmod, N] int32 or None
        self.d = d
        self.chunks = chunks  # host [(hi, lo, kc)] or None

    @property
    def empty(self) -> bool:
        return self.polys is None and self.chunks is None

    @property
    def num_diags(self) -> int:
        return len(self.giants)

    def materialize_rows(self, cps, nmod: int, a: int, b: int):
        """Device polys [b - a, nmod, N] of diagonal rows [a, b), from the
        host chunks (host-streaming mode)."""
        assert self.chunks is not None
        c0, c1 = a // _ENC_STEP, -(-b // _ENC_STEP)
        polys = _encode_diag_device(cps, self.chunks[c0:c1], nmod)
        return polys[a - c0 * _ENC_STEP : b - c0 * _ENC_STEP]


# ---------------------------------------------------------------------------
# diagonal encode


def _mod_ntt_b(hi, lo, basis, rows, plain: bool = False):
    """Device half of the plaintext encode: coefficients hi*2^31 + lo
    (hi [B, N] int32 with |hi| < q, lo [B, N] int32 in [0, 2^31)) ->
    [len(rows), B, N] NTT-domain residues."""
    q = rns._sel(basis, rows, hi.device)["q"].long()[:, :, None]  # [L, 1, 1]
    r31 = torch.remainder(torch.full_like(q, 1 << 31), q)
    v = torch.remainder(
        torch.remainder(hi.long()[None], q) * r31 + lo.long()[None], q
    ).to(torch.int32)
    return rns.ntt_b(v, basis, rows, plain=plain)


def _encode_diag_host(cps: CryptoParams, vecs: np.ndarray):
    """Host half of the diagonal encode: canonical-embedding FFT (torch.fft
    on the CPU, float64) + twiddle fold -> integer coefficients as
    (hi, lo, kc) chunks of <= 1024 diagonals."""
    enc = cps.ctx.encoder
    n = cps.ctx.n
    K = vecs.shape[0]
    scale = cps.ctx.params.scale
    tw_re = torch.from_numpy(enc.psi_inv_re_over_n * scale)
    tw_im = torch.from_numpy(enc.psi_inv_im_over_n * scale)
    chunks = []
    for k0 in range(0, K, _ENC_STEP):
        kc = min(_ENC_STEP, K - k0)
        A = np.zeros((_ENC_STEP, n), np.float64)
        A[:kc, enc.pos] = vecs[k0 : k0 + kc]
        A[:kc, enc.pos_conj] = vecs[k0 : k0 + kc]  # real data: conj = itself
        a = torch.fft.fft(torch.from_numpy(A), dim=1)
        coeffs = a.real * tw_re
        coeffs += a.imag * tw_im
        coeffs = torch.round_(coeffs)
        hi_t = torch.floor(coeffs * (1.0 / (1 << 31)))
        lo = (coeffs - hi_t * float(1 << 31)).to(torch.int64).numpy().astype(np.uint32)
        hi = hi_t.to(torch.int32).numpy()
        chunks.append((hi, lo, kc))
    return chunks


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over a host chunk; a spilled chunk (a read-only memory
    map) is read into memory first."""
    return torch.from_numpy(a if a.flags.writeable else np.array(a))


def _encode_diag_device(cps: CryptoParams, chunks, nmod: int):
    """Device half: per-prime reduction + NTT (kernel K1) of the host
    chunks -> [K, nmod, N] int32."""
    ctx = cps.ctx
    rows = tuple(range(nmod))
    K = sum(kc for _, _, kc in chunks)
    out = torch.empty((K, nmod, ctx.n), dtype=torch.int32, device=ctx.device)
    k0 = 0
    for hi, lo, kc in chunks:
        poly = _mod_ntt_b(
            _host_tensor(hi).to(ctx.device), _host_tensor(lo.view(np.int32)).to(ctx.device),
            ctx.basis, rows, plain=not ctx.kernels,
        )  # [nmod, step, N]
        out[k0 : k0 + kc] = poly[:, :kc].transpose(0, 1)
        k0 += kc
    return out


def block_shifts(S: int, r: int, c: int) -> np.ndarray:
    """The diagonal shifts of an r x c block in S slots, ascending: the set
    s = (i-j) mod S for i < r, j < c is exactly [0, r) u [S-c+1, S).  The
    giant and baby of shift s are s // d and s % d, d = ceil(sqrt(S))."""
    assert r <= S and c <= S
    return np.concatenate(
        [np.arange(r), np.arange(max(S - c + 1, r), S)]
    ).astype(np.int64)


def encode_block_diagonals_host(cps: CryptoParams, block: np.ndarray):
    """Host stage of encode_block_diagonals: diagonal scatter + FFT fold.
    Returns (giants, babies, d, host_chunks)."""
    S = cps.slots
    d = int(math.ceil(math.sqrt(S)))
    r, c = block.shape
    shifts = block_shifts(S, r, c)
    rank = np.zeros(S, np.int64)
    rank[shifts] = np.arange(len(shifts))
    i_idx = np.arange(r, dtype=np.int64)[:, None]
    j_idx = np.arange(c, dtype=np.int64)[None, :]
    s_idx = (i_idx - j_idx) % S  # [r, c] diagonal shift per entry
    col = (j_idx + (s_idx // d) * d) % S  # pre-rotated slot position
    vecs = np.zeros((len(shifts), S), np.float64)
    vecs[rank[s_idx], col] = block  # (s, col) pairs are unique per (i, j)
    return shifts // d, shifts % d, d, _encode_diag_host(cps, vecs)


def finish_block_diagonals(cps: CryptoParams, host_blk, nmod: int) -> DiagBlock:
    """Device stage of encode_block_diagonals: an
    encode_block_diagonals_host result -> a DiagBlock on the device."""
    giants, babies, d, chunks = host_blk
    return DiagBlock(giants, babies, _encode_diag_device(cps, chunks, nmod), d)


def encode_block_diagonals(cps: CryptoParams, block: np.ndarray, nmod: int) -> DiagBlock:
    """All generalized diagonals of one block: the diagonal of shift s is
    d_s[j] = X[(j+s) mod S, j], pre-rotated right by d*giant."""
    return finish_block_diagonals(cps, encode_block_diagonals_host(cps, block), nmod)


def host_block_diagonals(cps: CryptoParams, block: np.ndarray,
                         spill: Optional[str] = None) -> DiagBlock:
    """Host-streaming DiagBlock: the integer coefficient chunks only.  With
    `spill`, the chunks are written once to spill + .hi.npy / .lo.npy /
    .meta.npz and memory-mapped back, so host RSS stays bounded by the
    pages a product touches; an existing spill is loaded as it is (a
    restart)."""
    if spill and os.path.exists(spill + ".meta.npz"):
        return _load_host_block(spill)
    giants, babies, d, chunks = encode_block_diagonals_host(cps, block)
    blk = DiagBlock(giants, babies, None, d, chunks=chunks)
    if spill:
        _spill_host_block(blk, spill)
        return _load_host_block(spill)
    return blk


def _spill_host_block(blk: DiagBlock, path: str) -> None:
    """The JAX package's layout: hi [K, N] int32, lo [K, N] uint32 and the
    indices, so either package loads the other's spill."""
    np.save(path + ".hi.npy", np.concatenate([c[0][: c[2]] for c in blk.chunks]))
    np.save(path + ".lo.npy", np.concatenate([c[1][: c[2]] for c in blk.chunks]))
    np.savez(path + ".meta.npz", giants=blk.giants, babies=blk.babies, d=blk.d)


def _load_host_block(path: str) -> DiagBlock:
    with np.load(path + ".meta.npz") as z:
        giants, babies, d = z["giants"], z["babies"], int(z["d"])
    hi = np.load(path + ".hi.npy", mmap_mode="r")
    lo = np.load(path + ".lo.npy", mmap_mode="r")
    K = hi.shape[0]
    chunks = [(hi[k0 : k0 + _ENC_STEP], lo[k0 : k0 + _ENC_STEP], min(_ENC_STEP, K - k0))
              for k0 in range(0, K, _ENC_STEP)]
    return DiagBlock(giants, babies, None, d, chunks=chunks)


def preprocess_matrix(
    cps: CryptoParams,
    mat: np.ndarray,
    nmod: Optional[int] = None,
    cache_file: Optional[str] = None,
    host_resident: bool = False,
    disk_cache: bool = False,
) -> List[List[DiagBlock]]:
    """Encode the diagonals of every (block-row, block-col) of the
    plaintext matrix: device-resident, or with host_resident as host
    chunks (spilled beside cache_file as cache_file.w<bi>_<bj>.*) that a
    product streams to the device.  A device-resident encode loads
    cache_file when it exists, and writes it there only with disk_cache (a
    device -> host copy of the whole cache; the spill files serve
    restarts)."""
    nmod = nmod or mm_nmod(cps)
    S = cps.slots
    if cache_file and os.path.exists(cache_file) and not host_resident:
        return _load_diag_cache(cps, cache_file)
    n, m = mat.shape
    out = []
    for bi in range(0, n, S):
        row = []
        for bj in range(0, m, S):
            blk = mat[bi : bi + S, bj : bj + S]
            if host_resident:
                spill = f"{cache_file}.w{bi}_{bj}" if cache_file else None
                row.append(host_block_diagonals(cps, blk, spill=spill))
            else:
                row.append(encode_block_diagonals(cps, blk, nmod))
        out.append(row)
    if cache_file and disk_cache and not host_resident:
        _save_diag_cache(cache_file, out)
    return out


def _save_diag_cache(path: str, cache):
    """The JAX package's .npz layout (polys as uint32 residues)."""
    data = {"nbr": len(cache), "nbc": len(cache[0])}
    for i, row in enumerate(cache):
        for j, blk in enumerate(row):
            data[f"g_{i}_{j}"] = blk.giants
            data[f"b_{i}_{j}"] = blk.babies
            data[f"p_{i}_{j}"] = (
                rns.to_u32(blk.polys) if blk.polys is not None else np.zeros(0)
            )
            data[f"d_{i}_{j}"] = blk.d
    np.savez_compressed(path, **data)


def _load_diag_cache(cps: CryptoParams, path: str):
    """A diagonal cache of either package -> device-resident DiagBlocks."""
    ctx = cps.ctx

    def block(z, i, j):
        p = z[f"p_{i}_{j}"]
        return DiagBlock(z[f"g_{i}_{j}"], z[f"b_{i}_{j}"], ctx.to_dev(p) if p.size else None,
                         int(z[f"d_{i}_{j}"]))

    with np.load(path) as z:
        return [[block(z, i, j) for j in range(int(z["nbc"]))] for i in range(int(z["nbr"]))]


def preprocess_matrix_host(cps: CryptoParams, mat: np.ndarray):
    """Host stage of preprocess_matrix for every block of `mat` (diagonal
    scatter and FFT fold, numpy and CPU torch only), so a prefetch thread
    can encode block b+1 while the device multiplies block b."""
    S = cps.slots
    n, m = mat.shape
    return [
        [encode_block_diagonals_host(cps, mat[bi : bi + S, bj : bj + S])
         for bj in range(0, m, S)]
        for bi in range(0, n, S)
    ]


def finish_preprocess_matrix(cps: CryptoParams, host_rows, nmod: int) -> List[List[DiagBlock]]:
    """Device stage: per-prime reduction and NTT of a preprocess_matrix_host
    result."""
    return [[finish_block_diagonals(cps, hb, nmod) for hb in row] for row in host_rows]


# ---------------------------------------------------------------------------
# Kernel K2: the dense multiply-accumulate

_P, _I = ctypes.c_void_p, ctypes.c_int
MAC_DENSE = CudaKernel("mac_dense", "mac_dense", [_P] * 11 + [_I] * 5)


@dataclass
class MacRuns:
    """The CSR entry list of one K2 launch.  Run r owns the entries
    [run_start[r], run_start[r+1]), each a (diagonal, baby) pair, and adds
    into accumulator row run_sg[r]; no two runs share a row.  The device
    tensors feed the kernel; the host copies and the longest run, known
    when the plan is built, are all the wrapper and the plain version
    read, so a launch needs no read-back from the device."""

    entry_diag: torch.Tensor  # [E] int32: row of the launch's diagonal polys
    entry_baby: torch.Tensor  # [E] int32: row of the block row's rotations
    run_start: torch.Tensor  # [nruns + 1] int32 entry offsets
    run_sg: torch.Tensor  # [nruns] int32 accumulator rows
    run_start_host: np.ndarray
    run_sg_host: np.ndarray
    longest: int  # entries in the longest run

    @property
    def nruns(self) -> int:
        return len(self.run_sg_host)

    @classmethod
    def from_host(cls, entry_diag, entry_baby, run_start, run_sg, device) -> "MacRuns":
        """From host arrays (run_start [nruns+1] entry offsets)."""
        host = [np.ascontiguousarray(a, np.int32)
                for a in (entry_diag, entry_baby, run_start, run_sg)]
        dev = [torch.from_numpy(a).to(device) for a in host]
        return cls(*dev, run_start_host=host[2], run_sg_host=host[3],
                   longest=int(np.diff(host[2]).max(initial=0)))


def mac_dense_plain(ACC0, ACC1, R0, R1, polys, runs: MacRuns, q):
    """Plain version of K2, in place on ACC0/ACC1 [nacc, s, nmod, N]: for
    each run r, ACC[run_sg[r]] += sum_e R[entry_baby[e]] * polys[entry_diag[e]]
    (mod q) over the run's entries.  R*: [nb, s, nmod, N]; polys
    [K, nmod, N]; q [nmod, 1].  Walks the runs by their host copies."""
    q64 = q.long()
    starts = runs.run_start_host.tolist()
    for r, sg in enumerate(runs.run_sg_host.tolist()):
        a0 = a1 = 0
        for e0 in range(starts[r], starts[r + 1], _PLAIN_STEP):
            e1 = min(e0 + _PLAIN_STEP, starts[r + 1])
            P = polys[runs.entry_diag[e0:e1].long()].long()[:, None]  # [k, 1, nmod, N]
            b = runs.entry_baby[e0:e1].long()
            a0 = a0 + torch.remainder(R0[b].long() * P, q64).sum(0)
            a1 = a1 + torch.remainder(R1[b].long() * P, q64).sum(0)
        ACC0[sg] = add_mod(ACC0[sg], torch.remainder(a0, q64).to(torch.int32), q)
        ACC1[sg] = add_mod(ACC1[sg], torch.remainder(a1, q64).to(torch.int32), q)
    return ACC0, ACC1


def _mac_dense_shape(ACC0, ACC1, R0, R1, polys, runs: MacRuns, q, mu, logn: int):
    """Validate K2's inputs from their metadata and the runs' host copies
    alone (no device read); returns (nb, S, NM).  Raises ValueError on what
    the kernel does not take; the kernel's own limits (ring size, babies
    that fit its shared memory) are refused by the launch."""
    dev = ACC0.device
    _, S, NM, N = ACC0.shape
    if N != 1 << logn:
        raise ValueError(f"mac_dense: N={N} is not 2^{logn}")
    check(ACC0, "ACC0", dev)
    check(ACC1, "ACC1", dev, ACC0.shape)
    check(R0, "R0", dev)
    check(R1, "R1", dev, R0.shape)
    if R0.shape[1:] != ACC0.shape[1:]:
        raise ValueError(f"mac_dense: R {tuple(R0.shape)} vs ACC {tuple(ACC0.shape)}")
    check(polys, "polys", dev, (polys.shape[0], NM, N))
    E = int(runs.run_start_host[-1])
    check(runs.entry_diag, "entry_diag", dev, (E,))
    check(runs.entry_baby, "entry_baby", dev, (E,))
    check(runs.run_start, "run_start", dev, (runs.nruns + 1,))
    check(runs.run_sg, "run_sg", dev, (runs.nruns,))
    check(q, "q", dev, (NM, 1))
    check(mu, "mu", dev, (NM,), torch.int64)
    for name, t in (("R0", R0), ("R1", R1), ("polys", polys)):
        if t.data_ptr() % 16:
            raise ValueError(f"mac_dense: {name} is not 16-byte aligned")
    if runs.longest > MAC_MAX_TERMS:
        raise ValueError(f"mac_dense: {runs.longest} terms in a run > {MAC_MAX_TERMS}")
    return R0.shape[0], S, NM


def mac_dense(ACC0, ACC1, R0, R1, polys, runs: MacRuns, q, mu, logn: int):
    """Kernel K2 for CUDA tensors (the plain version for CPU tensors); in
    place on ACC0/ACC1, arguments as in mac_dense_plain, all int32 and
    contiguous; mu [nmod] int64 is rns.barrett_mu64 of the same rows."""
    if ACC0.device.type == "cpu":
        return mac_dense_plain(ACC0, ACC1, R0, R1, polys, runs, q)
    nb, S, NM = _mac_dense_shape(ACC0, ACC1, R0, R1, polys, runs, q, mu, logn)
    if runs.nruns == 0 or S == 0:
        return ACC0, ACC1
    MAC_DENSE.launch(
        ACC0.device, ptr(ACC0), ptr(ACC1), ptr(R0), ptr(R1), ptr(polys),
        ptr(runs.entry_diag), ptr(runs.entry_baby), ptr(runs.run_start), ptr(runs.run_sg),
        ptr(q), ptr(mu), runs.nruns, nb, S, NM, logn,
    )
    return ACC0, ACC1


def _combine_rotated(r0, r1, bj_ids, q, nbc: int):
    """Sum the rotated giant-group ciphertexts [R, s, nmod, N] per output
    block column -> [nbc, s, nmod, N] (int64 sums, one reduction)."""
    q64 = q.long()

    def comb(r):
        if nbc == 1:
            tot = r.long().sum(0)[None]
        else:
            tot = torch.zeros((nbc,) + tuple(r.shape[1:]), dtype=torch.int64, device=r.device)
            tot.index_add_(0, bj_ids, r.long())
        return torch.remainder(tot, q64).to(torch.int32)

    return comb(r0), comb(r1)


# ---------------------------------------------------------------------------
# the plan


class _MatmulPlan:
    """Static index plan for one preprocessed matrix in dense mode: global
    segment list (block-col, giant), per-block-row baby unions, and
    giant-aligned chunks (each chunk covers exactly one segment) stacked
    into one MAC launch per block row.  The chunks mirror the reference's
    (budget split, padding to k_pad with the zero row nb_pad, the nsub
    bound); the launches take their unpadded entries (groups()).  Sharded
    (groups(devices)), each block row has one launch per shard slot, on
    that slot's device.

    Streaming mode (any block kept as host chunks): each block row's
    chunks are split into launches of at most group_bytes of diagonal
    polys, and a launch's polys are materialised on the device only when
    the product reaches it."""

    def __init__(self, cps: CryptoParams, cache, nmod: int, row_batch: int = 1,
                 group_bytes: int = STREAM_GROUP_BYTES):
        self.cache = cache
        self.nmod = nmod
        self.row_batch = row_batch
        self.group_bytes = group_bytes
        self.d = cache[0][0].d
        nbr, nbc = len(cache), len(cache[0])
        self.nbr, self.nbc = nbr, nbc
        self.n = cps.ctx.n
        self.device = cps.ctx.device
        self._cps = cps
        self.stream = any(cache[bi][bj].chunks is not None
                          for bi in range(nbr) for bj in range(nbc))
        self.q_primes = list(cps.params.q_primes[:nmod])
        qmax = max(self.q_primes)
        # a u32 sum of t reduced terms is exact iff t*(q-1) <= 2^32-1
        self.max_lazy = (2**32 - 1) // (qmax - 1)
        assert self.max_lazy >= 2, "primes too large for lazy u32 accumulation"
        seg_index: Dict[Tuple[int, int], int] = {}
        for bj in range(nbc):
            giants = sorted({
                int(g) for bi in range(nbr) if not cache[bi][bj].empty
                for g in cache[bi][bj].giants
            })
            for g in giants:
                seg_index[(bj, g)] = len(seg_index)
        self.segments = sorted(seg_index, key=seg_index.get)
        self.seg_index = seg_index
        budget = max(1, MM_CHUNK_BYTES // (nmod * self.n * 4 * row_batch))
        self.babies: List[List[int]] = []
        self.chunks: List[List[dict]] = []
        for bi in range(nbr):
            bs = sorted({
                int(b) for bj in range(nbc) if not cache[bi][bj].empty
                for b in cache[bi][bj].babies
            })
            self.babies.append(bs)
            bpos = {b: k for k, b in enumerate(bs)}
            row_chunks: List[dict] = []
            for bj in range(nbc):
                blk = cache[bi][bj]
                if blk.empty:
                    continue
                K = len(blk.giants)
                bounds = [0] + [
                    k for k in range(1, K) if blk.giants[k] != blk.giants[k - 1]
                ] + [K]
                # one chunk per giant group, budget-split within a group
                for x in range(len(bounds) - 1):
                    g0, g1 = bounds[x], bounds[x + 1]
                    for k0 in range(g0, g1, budget):
                        row_chunks.append(
                            self._chunk(blk, bj, k0, min(k0 + budget, g1), bpos)
                        )
            self.chunks.append(row_chunks)
        all_chunks = [c for row in self.chunks for c in row]
        self.nb_pad = max((len(b) for b in self.babies if b), default=1)
        k_pad = max(len(c["bidx"]) for c in all_chunks)
        # the reference splits each chunk's lazy u32 sum into nsub parts of
        # <= max_lazy terms and then sums the nsub reduced parts lazily too,
        # which is exact only while nsub <= max_lazy
        self.nsub = -(-k_pad // self.max_lazy)
        assert self.nsub <= self.max_lazy, (self.nsub, self.max_lazy)
        self.k_pad = self.nsub * (-(-k_pad // self.nsub))
        for c in all_chunks:
            # padding entries index the all-zero rotation row nb_pad
            K = len(c["bidx"])
            c["bidx"] = np.concatenate(
                [c["bidx"], np.full(self.k_pad - K, self.nb_pad, np.int64)]
            ).astype(np.int32)
        self._groups: Dict[tuple, list] = {}
        self._giant: Optional[dict] = None

    def _chunk(self, blk: DiagBlock, bj: int, k0: int, k1: int, bpos) -> dict:
        segs = {int(g) for g in blk.giants[k0:k1]}
        assert len(segs) == 1, "dense chunk spans segments"
        return {
            "blk": blk,
            "k0": k0,
            "k1": k1,
            "bidx": np.array([bpos[int(b)] for b in blk.babies[k0:k1]], np.int64),
            "bj": bj,
            "sg": self.seg_index[(bj, segs.pop())],
        }

    def _build_group(self, cs, nb: int, dev=None) -> dict:
        """One MAC launch from a chunk list, on a shard's device `dev` (None:
        the plan's): the CSR entry list of its accumulator runs (the chunks'
        unpadded (diagonal, baby) pairs, consecutive chunks of one
        accumulator row forming one run), the diagonal polys the chunks
        touch, and the runs' chunk offsets.  In streaming mode the polys are
        a zero-argument function that materialises just the row range of
        each block the chunks read (on the plan's device)."""
        rng: Dict[int, list] = {}  # per block: [first row, end row] read here
        blks: List[DiagBlock] = []
        for c in cs:
            r = rng.get(id(c["blk"]))
            if r is None:
                rng[id(c["blk"])] = [c["k0"], c["k1"]]
                blks.append(c["blk"])
            else:
                r[0], r[1] = min(r[0], c["k0"]), max(r[1], c["k1"])
        offs: Dict[int, int] = {}
        tot = 0
        for b in blks:
            lo, hi = rng[id(b)]
            offs[id(b)] = tot - lo if self.stream else tot
            tot += hi - lo if self.stream else b.num_diags
        diag = [offs[id(c["blk"])] + np.arange(c["k0"], c["k1"]) for c in cs]
        baby = [c["bidx"][: c["k1"] - c["k0"]] for c in cs]
        sgs = np.array([c["sg"] for c in cs], np.int64)
        # runs of consecutive chunks sharing an accumulator row
        starts = [0] + [r for r in range(1, len(cs)) if sgs[r] != sgs[r - 1]]
        run_sg = sgs[starts]
        assert len(set(run_sg.tolist())) == len(run_sg), "accumulator row in two runs"
        chunk_start = np.array(starts + [len(cs)], np.int64)
        sizes = np.array([c["k1"] - c["k0"] for c in cs], np.int64)
        run_start = np.concatenate([[0], np.cumsum(sizes)])[chunk_start]
        entry_baby = np.concatenate(baby)
        assert entry_baby.max() < nb, "baby index past the block row's rotations"
        runs = MacRuns.from_host(np.concatenate(diag), entry_baby, run_start, run_sg,
                                 dev or self.device)
        qmax = max(self.q_primes)
        assert runs.longest <= MAC_MAX_TERMS and runs.longest * (qmax - 1) ** 2 < 2**64
        if self.stream:
            cps, nmod = self._cps, self.nmod
            ranges = [(b,) + tuple(rng[id(b)]) for b in blks]

            def polys():
                parts = [b.materialize_rows(cps, nmod, a, z) if b.chunks is not None
                         else b.polys[a:z] for b, a, z in ranges]
                return parts[0] if len(parts) == 1 else torch.cat(parts)

        elif len(blks) == 1:
            polys = blks[0].polys
        else:
            polys = torch.cat([b.polys for b in blks])
        if dev is not None and not callable(polys):
            polys = polys.to(dev)
        return {"dev": dev or self.device, "polys": polys, "runs": runs,
                "chunk_start": chunk_start}

    def groups(self, devices=None) -> list:
        """Per block row, the list of MAC launches: one, or in streaming
        mode runs of consecutive chunks of at most group_bytes of polys
        each (a chunk never exceeds it: plan chunks are budget-split).
        With devices, each block row's chunks are first split by shard slot
        (block column bj to slot bj % len(devices)) and each slot's
        launches run on devices[slot]; slots are keyed by position, so a
        device listed twice still makes two launches."""
        devs = [torch.device(d) for d in devices] if devices else [None]
        key = tuple(map(str, devs))  # ("None",): unsharded
        if key in self._groups:
            return self._groups[key]
        budget_rows = max(1, self.group_bytes // (self.nmod * self.n * 4))
        rows = []
        for bi, cs in enumerate(self.chunks):
            nb = len(self.babies[bi])
            by_slot: Dict[int, list] = {}
            for c in cs:  # slots in the order their first chunk comes
                by_slot.setdefault(c["bj"] % len(devs), []).append(c)
            row = []
            for slot, scs in by_slot.items():
                if not self.stream:
                    row.append(self._build_group(scs, nb, devs[slot]))
                    continue
                sub, used = [], 0
                for c in scs:
                    kr = c["k1"] - c["k0"]
                    if sub and used + kr > budget_rows:
                        row.append(self._build_group(sub, nb, devs[slot]))
                        sub, used = [], 0
                    sub.append(c)
                    used += kr
                if sub:
                    row.append(self._build_group(sub, nb, devs[slot]))
            rows.append(row)
        self._groups[key] = rows
        return rows

    def giant_index(self, ctx) -> dict:
        """Device index tensors of the giant step, built once per plan (a
        host-to-device copy per product would drain the queue): the rotated
        segments `rot` with their Galois elements `gels` (and the distinct
        ones `uniq_gels`, `gsel` mapping each segment to its key), their
        block columns `bj`, and the unrotated segments `zsegs` as (block
        column, segment) tensors."""
        if self._giant is None:
            d, slots = self.d, ctx.params.slots
            rot = [si for si, (bj, g) in enumerate(self.segments) if g > 0]
            gels = [ctx.galois_for_rotation((self.segments[si][1] * d) % slots) for si in rot]
            uniq = sorted(set(gels))
            pos = {g: x for x, g in enumerate(uniq)}
            zsegs = [(bj, self.seg_index[(bj, 0)]) for bj in range(self.nbc)
                     if (bj, 0) in self.seg_index]
            dev = self.device
            self._giant = {
                "rot": torch.tensor(rot, dtype=torch.long, device=dev),
                "gels": gels,
                "uniq_gels": uniq,
                "gsel": torch.tensor([pos[g] for g in gels], dtype=torch.long, device=dev),
                "bj": torch.tensor([self.segments[si][0] for si in rot], dtype=torch.long,
                                   device=dev),
                "zsegs": (
                    torch.tensor([z[0] for z in zsegs], dtype=torch.long, device=dev),
                    torch.tensor([z[1] for z in zsegs], dtype=torch.long, device=dev),
                ) if zsegs else None,
            }
        return self._giant


_plan_cache: Dict[int, _MatmulPlan] = {}


def _plan_for(cps, cache, nmod, row_batch: int = 1,
              group_bytes: int = STREAM_GROUP_BYTES) -> _MatmulPlan:
    plan = _plan_cache.get(id(cache))
    if (
        plan is None
        or plan.cache is not cache
        or plan.nmod != nmod
        or plan.row_batch != row_batch
        or plan.group_bytes != group_bytes
        or plan.device != cps.ctx.device
    ):
        plan = _MatmulPlan(cps, cache, nmod, row_batch, group_bytes)
        _plan_cache.clear()  # hold at most one plan
        _plan_cache[id(cache)] = plan
    return plan


def release_plan(cache) -> None:
    """Drop the staged plan of a one-shot diagonal cache, so its device
    buffers (GBs of encoded polys per block at PN14) free as soon as the
    block is consumed."""
    _plan_cache.pop(id(cache), None)


# ---------------------------------------------------------------------------
# the product


def baby_rotations(cps: CryptoParams, A: B.CipherMatrix, plan: _MatmulPlan, bi: int):
    """Block row bi of A rotated by each of the row's baby shifts (one
    hoisted keyswitch batch) -> (R0, R1) [len(plan.babies[bi]), s, nmod, N]."""
    ctx = cps.ctx
    nmod, s = plan.nmod, len(A)
    babies = plan.babies[bi]
    C0s = torch.stack([A[i][bi].c0[:nmod] for i in range(s)])
    C1s = torch.stack([A[i][bi].c1[:nmod] for i in range(s)])
    nz = [b for b in babies if b % cps.slots != 0]
    if nz:
        gl = [ctx.galois_for_rotation(b) for b in nz]
        ik0, ik1 = cps.stacked_keys_inv(gl, nmod)
        R0nz, R1nz = ctx.hoisted_rotations_all(C0s, C1s, ctx.perms_for(gl), ik0, ik1, nmod)
    rows0, rows1, j = [], [], 0
    for b0 in babies:
        if b0 % cps.slots == 0:
            rows0.append(C0s)
            rows1.append(C1s)
        else:
            rows0.append(R0nz[j])
            rows1.append(R1nz[j])
            j += 1
    return torch.stack(rows0), torch.stack(rows1)


def mat_mult_cached(
    cps: CryptoParams, A: B.CipherMatrix, cache: List[List[DiagBlock]],
    group_bytes: int = STREAM_GROUP_BYTES, devices=None,
) -> B.CipherMatrix:
    """A (s rows x nBlockRows cts) times the preprocessed matrix ->
    s x nBlockCols cts, rescaled by one level.  group_bytes bounds the
    diagonal polys materialised per MAC launch of a host-streamed cache.
    devices (None: those of set_pipeline_devices) of two or more entries
    shards the MAC over them; the result is the same bits either way."""
    if devices is None:
        devices = _pipeline_devices
    sharded = devices is not None and len(devices) > 1
    ctx = cps.ctx
    nbr, nbc = len(cache), len(cache[0])
    s = len(A)
    some = next(
        (cache[bi][bj] for bi in range(nbr) for bj in range(nbc) if not cache[bi][bj].empty),
        None,
    )
    if some is None:
        return [[ctx.zero_ct(mm_nmod(cps)) for _ in range(nbc)] for _ in range(s)]
    nmod = some.polys.shape[1] if some.polys is not None else mm_nmod(cps)
    q = ctx._t(range(nmod))["q"]
    mu = rns.barrett_mu64(ctx.basis, range(nmod), ctx.device)
    n = ctx.n
    plan = _plan_for(cps, cache, nmod, row_batch=s, group_bytes=group_bytes)
    nseg_tot = len(plan.segments)
    groups = plan.groups(devices if sharded else None)
    gi = plan.giant_index(ctx)

    ACC0 = torch.zeros((nseg_tot + 1, s, nmod, n), dtype=torch.int32, device=ctx.device)
    ACC1 = torch.zeros_like(ACC0)
    for bi in range(nbr):
        if not plan.babies[bi]:
            continue
        with prof.span("mm_hoisted"):
            R0, R1 = baby_rotations(cps, A, plan, bi)
        with prof.span("mm_mac"):
            for g in groups[bi]:
                dv = g["dev"]
                polys = g["polys"]() if callable(g["polys"]) else g["polys"]
                if sharded:
                    # a shard's partial sums on fresh accumulators on its device
                    acc = (torch.zeros_like(ACC0, device=dv), torch.zeros_like(ACC1, device=dv))
                    args = acc + (R0.to(dv), R1.to(dv), polys.to(dv), g["runs"], q.to(dv))
                else:
                    args = (ACC0, ACC1, R0, R1, polys, g["runs"], q)
                if ctx.kernels:
                    mac_dense(*args, mu=mu.to(dv), logn=ctx.params.logn)
                else:
                    mac_dense_plain(*args)
                if sharded:
                    ACC0 = add_mod(ACC0, acc[0].to(ctx.device), q)
                    ACC1 = add_mod(ACC1, acc[1].to(ctx.device), q)
                    del acc
                del polys, args  # streamed polys free before the next group's
        del R0, R1

    in_scale = A[0][0].scale * ctx.params.scale
    with prof.span("mm_giant"):
        if gi["gels"]:
            ig0, ig1 = cps.stacked_keys_inv(gi["uniq_gels"], nmod)
            nrot = len(gi["gels"])
            step = max(1, GIANT_BATCH_BYTES // (s * nmod * n * 4))
            c0f = c1f = None
            for k0 in range(0, nrot, step):
                sl = slice(k0, min(k0 + step, nrot))
                r0, r1 = ctx.rotate_grouped_b(
                    ACC0[gi["rot"][sl]], ACC1[gi["rot"][sl]], ctx.perms_for(gi["gels"][sl]),
                    ig0[gi["gsel"][sl]], ig1[gi["gsel"][sl]], nmod,
                )
                p0, p1 = _combine_rotated(r0, r1, gi["bj"][sl], q, nbc)
                del r0, r1
                if c0f is None:
                    c0f, c1f = p0, p1
                else:
                    c0f, c1f = add_mod(c0f, p0, q), add_mod(c1f, p1, q)
        else:
            c0f = torch.zeros((nbc, s, nmod, n), dtype=torch.int32, device=ctx.device)
            c1f = torch.zeros_like(c0f)
        if gi["zsegs"] is not None:
            bjz, siz = gi["zsegs"]
            c0f[bjz] = add_mod(c0f[bjz], ACC0[siz], q)
            c1f[bjz] = add_mod(c1f[bjz], ACC1[siz], q)
    with prof.span("mm_rescale"):
        stack = torch.cat(
            [c0f.reshape(nbc * s, nmod, n), c1f.reshape(nbc * s, nmod, n)]
        )
        res = ctx.rescale2_many(stack, nmod - 1)
    out_scale = in_scale / ctx.basis.primes[nmod - 1] / ctx.basis.primes[nmod - 2]
    r0f = res[: nbc * s].view(nbc, s, nmod - 2, n)
    r1f = res[nbc * s :].view(nbc, s, nmod - 2, n)
    return [
        [C.Ciphertext(r0f[bj, i], r1f[bj, i], nmod - 2, out_scale) for bj in range(nbc)]
        for i in range(s)
    ]


def mat_mult_sharded(cps: CryptoParams, A: B.CipherMatrix, cache: List[List[DiagBlock]],
                     devices=None) -> B.CipherMatrix:
    """mat_mult_cached with each block row's MAC split over a party's
    devices (the reference's within-party chip sharding).  devices=None:
    every local device of the context's kind (all cuda:i on a card, [cpu]
    on the CPU); with one device this is the unsharded product.  Bit-equal
    to the single-device product."""
    if not devices:
        devices = local_devices(cps.ctx.device.type)
    if len(devices) == 1:
        return mat_mult_cached(cps, A, cache)
    return mat_mult_cached(cps, A, cache, devices=devices)


def mat_mult_stream(
    cps: CryptoParams,
    A: B.CipherMatrix,
    geno: Optional[np.ndarray],
    compute_sums: bool = False,
    square: bool = False,
    host_pre=None,
):
    """Multiply the CipherMatrix with one genotype block (MatMult4Stream of
    the Go sfgwas), optionally squaring the block elementwise and returning
    the plaintext dosage sums and square sums per column.  host_pre, a
    preprocess_matrix_host result for this block, skips the host encode
    (the prefetched path).  Returns (product, sums, square sums)."""
    if host_pre is not None:
        assert not compute_sums and not square, (
            "prefetched path: sums and squaring happen on the prefetch thread"
        )
        cache = finish_preprocess_matrix(cps, host_pre, mm_nmod(cps))
    else:
        mat = np.asarray(geno)
        if square:
            mat = mat * mat
        cache = preprocess_matrix(cps, mat, mm_nmod(cps))
    out = mat_mult_cached(cps, A, cache)
    # a streamed block is multiplied once: free the plan's device buffers now
    release_plan(cache)
    dosage_sum = dosage_sq_sum = None
    if compute_sums:
        dosage_sum = geno.astype(np.float64).sum(axis=0)
        dosage_sq_sum = (geno.astype(np.float64) ** 2).sum(axis=0)
    return out, dosage_sum, dosage_sq_sum


# ---------------------------------------------------------------------------
# Distributed A A^T B (DCMatMulAAtB of the Go sfgwas, gwas/matmult.go:121-194)


def dc_matmul_aat_b(
    cps: CryptoParams,
    mpc,
    A: B.CipherMatrix,
    Bmat,
    nrows_all: List[int],
    ncol_out: int,
    inner_fn: Optional[Callable],
    bs_target: Optional[int] = None,
) -> B.CipherMatrix:
    """For A row-partitioned across parties: out = A (A^T B), computed per
    column of A from aggregated inner products.  inner_fn(cps, A[c], Bmat, j)
    gives the local products of column c with column j of B; None is the
    batched ciphertext-ciphertext inner product.  The aggregated cross terms
    are refreshed to bs_target (default two primes below the top, where the
    refresh resets the scale exactly) before the outer product."""
    slots = cps.slots
    pid = mpc.pid
    ctx = cps.ctx
    n_ct = ((nrows_all[pid] - 1) // slots) + 1 if pid > 0 else 1
    if bs_target is None:
        bs_target = ctx.nq - 2
    batched = inner_fn is None
    # accumulate with first-term adoption (a czeros start would impose the
    # preset scale on products whose scale drifted in rescaling)
    out = [None] * ncol_out
    for c in range(len(A)):
        if batched:
            prods = None
            for t in range(n_ct):
                row = B.cmult_one_to_many(cps, A[c][t], [Bmat[j][t] for j in range(ncol_out)])
                prods = row if prods is None else [ctx.add(p, r) for p, r in zip(prods, row)]
            ctq_loc = B.rotate_and_add_many(cps, prods, slots)
        else:
            ctq_loc = [B.inner_sum_all(cps, inner_fn(cps, A[c], Bmat, j))
                       for j in range(ncol_out)]
        ctq = mhe.aggregate_cvec(mpc.net, cps, ctq_loc)
        ctq = mhe.bootstrap_vec(mpc.net, cps, ctq, -1, target_nmod=bs_target)
        if batched:
            for t in range(n_ct):
                col = B.cmult_one_to_many(cps, A[c][t], ctq)
                for j in range(ncol_out):
                    if out[j] is None:
                        out[j] = [None] * n_ct
                    prev = out[j][t]
                    if prev is None:
                        out[j][t] = col[j]
                    else:
                        nm = min(prev.nmod, col[j].nmod)
                        out[j][t] = ctx.add(ctx.drop_to(prev, nm), ctx.drop_to(col[j], nm))
        else:
            for j in range(ncol_out):
                cc = B.cmult_scalar(cps, A[c], ctq[j])
                out[j] = cc if out[j] is None else B.cadd(cps, _match_vec(cps, out[j], cc), cc)
    return out


def _match_vec(cps, X, ref):
    """X dropped, ciphertext by ciphertext, to the lower level of itself and
    ref."""
    return [cps.ctx.drop_to(x, min(x.nmod, r.nmod)) for x, r in zip(X, ref)]


# ---------------------------------------------------------------------------
# Lazily normalised QX / QX^T (the Go sfgwas's gwas/matmult.go:27-116)


def qx_lazy_norm_stream(
    cps: CryptoParams,
    mpc,
    Q: B.CipherMatrix,
    xt_cache: List[List[DiagBlock]],
    x_mean: B.CipherVector,
    x_stdinv: B.CipherVector,
    num_ind: int,
    post_scale: float = 1.0,
    group_bytes: int = STREAM_GROUP_BYTES,
) -> B.CipherMatrix:
    """Q (kp x nsnp) times X (nsnp x nind) with lazy normalisation:
    [(Q*S)*X - ((Q*S)*m) 1^T] * post_scale.  The product band leaves no
    level for the trailing-slot mask, so the result is refreshed once
    (one collective round for every data party's rows) and masked at the
    top."""
    if mpc.pid == 0:
        return None
    ctx, slots = cps.ctx, cps.slots
    QS = [B.cmult(cps, Q[i], x_stdinv) for i in range(len(Q))]
    out = mat_mult_cached(cps, QS, xt_cache, group_bytes)
    for i in range(len(QS)):
        qsm = B.inner_prod(cps, QS[i], x_mean)  # the value in every slot
        nm = min(out[i][0].nmod, qsm.nmod)
        out[i] = [ctx.sub(ctx.drop_to(ct, nm), ctx.drop_to(qsm, nm)) for ct in out[i]]
    out = mhe.bootstrap_mat_all(mpc.net, cps, out)
    for i in range(len(out)):
        for j in range(len(out[i])):
            n_keep = slots if j < len(out[i]) - 1 else ((num_ind - 1) % slots) + 1
            out[i][j] = B.mask_trunc(cps, out[i][j], n_keep, post_scale)
    return out


def qxt_lazy_norm_stream(
    cps: CryptoParams,
    mpc,
    Q: B.CipherMatrix,
    x_cache: List[List[DiagBlock]],
    x_mean: B.CipherVector,
    x_stdinv: B.CipherVector,
    post_scale: float = 1.0,
    group_bytes: int = STREAM_GROUP_BYTES,
) -> B.CipherMatrix:
    """Q (kp x nind) times X^T (nind x nsnp) with lazy normalisation:
    ((Q X^T) - (Q 1) m^T) * S * post_scale.  One refresh after the mean
    correction; the stdinv multiply and the constant share one double
    rescale."""
    if mpc.pid == 0:
        return None
    ctx = cps.ctx
    out = mat_mult_cached(cps, Q, x_cache, group_bytes)
    for i in range(len(out)):
        q1m = B.cmult_scalar(cps, x_mean, B.inner_sum_all(cps, Q[i]))
        nm = min(out[i][0].nmod, q1m[0].nmod)
        out[i] = [ctx.sub(ctx.drop_to(o, nm), ctx.drop_to(m, nm)) for o, m in zip(out[i], q1m)]
    out = mhe.bootstrap_mat_all(mpc.net, cps, out)
    for i in range(len(out)):
        out[i] = B.cmult_with_const(cps, out[i], x_stdinv, post_scale)
    return out


# ---------------------------------------------------------------------------
# Ciphertext-by-ciphertext products of the logistic path (the Go sfgwas's
# gwas/matmult.go:1915-2066)


def _add_low(cps, acc, x):
    """acc + x at the lower level of the two (acc None: x)."""
    if acc is None:
        return x
    nm = min(acc.nmod, x.nmod)
    return cps.ctx.add(cps.ctx.drop_to(acc, nm), cps.ctx.drop_to(x, nm))


def cmult_mat_inner_prod(cps, Cm, Wz):
    """Row-packed C^T Wz: out[i] holds <C[i], Wz[j]> in slot j
    (CMultMatInnerProd)."""
    out = []
    for i in range(len(Cm)):
        acc = None
        for j in range(len(Wz)):
            ip = B.inner_prod(cps, Cm[i], Wz[j])  # the value in every slot
            acc = _add_low(cps, acc, B.mask(cps, ip, j, False))
        out.append([acc])
    return out


def cmult_mat_inner_prod_vector(cps, Cm, yv):
    """Packed C^T y: slot i holds <C[i], y> (CMultMatInnerProdVector)."""
    acc = None
    for i in range(len(Cm)):
        acc = _add_low(cps, acc, B.mask(cps, B.inner_prod(cps, Cm[i], yv), i, False))
    return [acc]


def add_vec_low(cps, acc, x):
    """acc + x, ciphertext by ciphertext, at the lower level of the two
    (acc None: x)."""
    if acc is None:
        return x
    nm = min(acc[0].nmod, x[0].nmod)
    return [cps.ctx.add(cps.ctx.drop_to(a, nm), cps.ctx.drop_to(b, nm)) for a, b in zip(acc, x)]


def cmult_mat_col_times_col_to_col(cps, Cm, packed, n_ct):
    """sum_i C[i] * packed[slot i] as a column vector
    (CMultMatColTimesColToCol)."""
    out = None
    for i in range(len(Cm)):
        w_i = B.rotate_and_add(cps, B.mask(cps, packed[0], i, False), cps.slots)
        out = add_vec_low(cps, out, B.cmult_scalar(cps, Cm[i], w_i))
    return out


def cmult_mat_col_times_row_to_col(cps, Wz, M, ncols):
    """Column-encrypted Wz (n x c) times row-packed M (c x c): column k is
    sum_j Wz[j] * M[j][slot k] (CMultMatColTimesRowToCol)."""
    out = []
    for k in range(ncols):
        acc = None
        for j in range(len(Wz)):
            mjk = B.rotate_and_add(cps, B.mask(cps, M[j][0], k, False), cps.slots)
            acc = add_vec_low(cps, acc, B.cmult_scalar(cps, Wz[j], mjk))
        out.append(acc)
    return out
