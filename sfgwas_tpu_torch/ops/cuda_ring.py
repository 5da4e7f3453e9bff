"""Kernels K8-K11 and their plain versions: the SS ring's device path
(counterpart of the jitted device methods of sfgwas_tpu/ops/ring.py;
source csrc/ring.cu).

Each wrapper takes int32 digit tensors ([..., nlimb], ops/ring.py's
layout) and launches the CUDA kernel for CUDA tensors; for CPU tensors it
runs the plain torch version beside it, which the tests hold bit-equal to
the JAX device path.  It never falls back to the plain version on the
card: a CUDA tensor the kernel cannot take raises.

  reduce   (K8)  any signed digit array, at most 2L - 1 digits -> canonical
  combine  (K8)  canonical sa a + sb b (b optional, |sa|, |sb| < 2^9): the
                 JAX package's _add_dev, _sub_dev, _neg_dev and small mul_int
  sum_axis (K8)  the sum of canonical rows over one batch axis (_sum_dev)
  from_i32 (K8)  int32 values -> canonical digits (from_i32's device branch)
  mul      (K9)  elementwise product of canonical arrays
  matmul   (K10) [r, k, L] x [k, c, L] -> [r, c, L], any k
  dot      (K11) sum_k a[..., k, :] * coeffs[k, :]

K8's combine entry and K9 read a broadcast or transposed operand in place
from its axes' strides (_operand); an operand whose digit axis is not
contiguous is copied out first and counted in OPERAND_COPIES.

The plain versions compute in int64, exactly, with the JAX functions'
steps: the carry passes, folds and conditional subtracts of _reduce_dev
(after the elementwise step of each K8 entry), the digit convolutions of
_mul_dev, _matmul_dev and _dot_coeffs_dev.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from . import native_ring
from .cuda_build import CudaKernel, check, ptr

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_count_lock = threading.Lock()  # the party threads launch concurrently

RING_REDUCE = CudaKernel("ring", "ring_reduce", [_I, _P, _P, _LL, _I])
RING_COMBINE = CudaKernel("ring", "ring_combine", [_I, _P, _P, _P, _P, _P, _LL, _I, _I])
RING_SUM = CudaKernel("ring", "ring_sum", [_I, _P, _P, _LL, _I, _LL])
RING_FROM_I32 = CudaKernel("ring", "ring_from_i32", [_I, _P, _P, _LL])
RING_MUL = CudaKernel("ring", "ring_mul", [_I, _P, _P, _P, _P, _P, _LL])
RING_MATMUL = CudaKernel("ring", "ring_matmul", [_I, _P, _P, _P, _I, _I, _I])
RING_DOT = CudaKernel("ring", "ring_dot", [_I, _P, _P, _P, _LL, _I])
RING_MATMUL_MAX_K = 1 << 27  # MATMUL_MAX_K in csrc/ring.cu: K10's 64-bit column sums

DIGIT_BITS = 8
SMALL = 1 << 9  # combine's bound on |sa|, |sb|: mul_int's small-constant path
MAX_AXES = 4  # ring.cu's MAXD: batch axes of an operand read in place
_GEOM = ctypes.c_longlong * (1 + 2 * MAX_AXES)
# operands of K8's combine entry and K9 copied out before a launch (_operand)
OPERAND_COPIES = 0


def _rid(ring) -> int:
    rid = native_ring.ring_id(ring.modulus, ring.kind)
    if rid is None:
        raise ValueError(f"no device kernel for {ring}")
    return rid


def _operand(t: torch.Tensor, shape) -> tuple:
    """An operand of an elementwise op over `shape` as K8's combine entry and
    K9 read it in place: (t, its rows' geometry for ring.cu's Rows:
    {nd, sizes, strides} of its batch axes, broadcast ones at stride 0, axes
    that follow each other in memory merged).  A digit axis that is not
    contiguous, or more than MAX_AXES axes left after merging, is copied out
    first (OPERAND_COPIES counts those)."""
    global OPERAND_COPIES
    if t.shape == shape and t.is_contiguous():
        return t, _GEOM(1, t.numel() // t.shape[-1], t.shape[-1])
    v = t.expand(shape)
    axes: list = []  # (size, stride), outermost first
    for size, stride in zip(v.shape[:-1], v.stride()[:-1]):
        if size == 1:
            continue
        if axes and axes[-1][1] == stride * size:
            axes[-1] = (axes[-1][0] * size, stride)
        else:
            axes.append((size, stride))
    if v.stride(-1) != 1 or len(axes) > MAX_AXES:
        with _count_lock:
            OPERAND_COPIES += 1
        v = v.contiguous()
        axes = [(v.numel() // v.shape[-1], v.shape[-1])]
    axes = axes or [(1, 0)]
    return v, _GEOM(len(axes), *(a for a, _ in axes), *(b for _, b in axes))


def _broadcast(*shapes) -> torch.Size:
    """torch.broadcast_shapes of tensor shapes, without its cost for the
    common case of equal shapes."""
    if all(sh == shapes[0] for sh in shapes):
        return shapes[0]
    nd = max(len(sh) for sh in shapes)
    out = [1] * nd
    for sh in shapes:
        for i, d in enumerate(sh, nd - len(sh)):
            if d != 1 and out[i] not in (1, d):
                raise ValueError(f"shapes {[tuple(x) for x in shapes]} do not broadcast")
            out[i] = d if d != 1 else out[i]
    return torch.Size(out)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous, starting on a 16-byte boundary (the kernels read and
    write a row's digits 4 at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


# ------------------------------------------------------------ plain versions


def _carry(x: torch.Tensor):
    """Exact carry over the digit axis (int64): (digits in [0, 255],
    carry out), x left as it is.  Carries shrink by 2^8 a pass."""
    out = x
    c_out = torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    while True:
        q = out >> DIGIT_BITS
        if not bool(q.any()):
            return (x.clone() if out is x else out), c_out
        out = out & ((1 << DIGIT_BITS) - 1)  # out - (q << 8): a new tensor
        out[..., 1:] += q[..., :-1]
        c_out += q[..., -1]


def reduce_plain(ring, x: torch.Tensor) -> torch.Tensor:
    """_reduce_dev in int64: exact carry, fold of the digits past L by
    fold_c (dropped for the power-of-two rings), two more carry-and-fold
    passes, a last carry, then the conditional subtracts of p (or the top
    digit's mask)."""
    L = ring.nlimb
    x = x.to(torch.int64)
    if x.shape[-1] < L:
        x = torch.nn.functional.pad(x, (0, L - x.shape[-1]))
    x, c_out = _carry(x)
    if x.shape[-1] > L:
        lo, hi = x[..., :L], x[..., L:]
        nh = hi.shape[-1]
        if nh >= L:
            raise ValueError("reduce: input too wide; reduce in chunks")
        x = lo.clone()
        if ring.kind == "prime":
            x[..., :nh] += hi * ring.fold_c
            x[..., nh] += c_out * ring.fold_c
    elif ring.kind == "prime":
        x[..., 0] += c_out * ring.fold_c
    for _ in range(2):
        x, c_out = _carry(x)
        if ring.kind == "prime":
            x[..., 0] += c_out * ring.fold_c
    x, _ = _carry(x)
    if ring.kind == "prime":
        p = torch.tensor(ring._p_digits, dtype=torch.int64, device=x.device)
        for _ in range((1 << (DIGIT_BITS * L)) // ring.modulus):
            y, borrow = _carry(x - p)
            x = torch.where((borrow == 0)[..., None], y, x)
    else:
        x[..., -1] &= ring.top_mask
    return x.to(torch.int32)


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Digit convolution of canonical arrays -> [..., 2L-1] int64: the
    digit products a_i b_j in an [L, 2L] row-major block (zeros past
    column L), read with a row stride of 2L - 1 so that column k sums the
    products with i + j = k."""
    L = a.shape[-1]
    a, b = torch.broadcast_tensors(a.to(torch.int64), b.to(torch.int64))
    outer = torch.nn.functional.pad(a[..., :, None] * b[..., None, :], (0, L))
    skew = outer.reshape(a.shape[:-1] + (2 * L * L,))[..., : L * (2 * L - 1)]
    return skew.reshape(a.shape[:-1] + (L, 2 * L - 1)).sum(dim=-2)


def mul_plain(ring, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return reduce_plain(ring, _conv(a, b))


def combine_plain(ring, a: torch.Tensor, b, sa: int, sb: int) -> torch.Tensor:
    """_reduce_dev of sa a + sb b (of sa a without b)."""
    x = sa * a.to(torch.int64)
    return reduce_plain(ring, x if b is None else x + sb * b.to(torch.int64))


def sum_plain(ring, a: torch.Tensor, axis: int) -> torch.Tensor:
    """_reduce_dev of the digit sums over a batch axis."""
    return reduce_plain(ring, torch.sum(a.to(torch.int64), dim=axis))


def from_i32_plain(ring, v: torch.Tensor) -> torch.Tensor:
    """_reduce_dev of v's 4 bytes, little-endian, as digits."""
    v = v.to(torch.int32)
    x = torch.stack([(v >> (DIGIT_BITS * i)) & 0xFF for i in range(4)], dim=-1)
    return reduce_plain(ring, torch.nn.functional.pad(x, (0, ring.nlimb - 4)))


def matmul_plain(ring, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """sum over k of the digit convolutions of A[:, t] and B[t, :], exact in
    int64 (no integer matrix product: the card has none)."""
    L = ring.nlimb
    r, k, _ = A.shape
    c = B.shape[1]
    conv = torch.zeros((r, c, 2 * L - 1), dtype=torch.int64, device=A.device)
    A64, B64 = A.to(torch.int64), B.to(torch.int64)
    for t in range(k):
        for i in range(L):
            conv[..., i : i + L] += A64[:, t, None, i : i + 1] * B64[t][None]
    return reduce_plain(ring, conv)


def dot_plain(ring, a: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    L = ring.nlimb
    a64, c64 = a.to(torch.int64), coeffs.to(torch.int64)
    conv = torch.zeros(a.shape[:-2] + (2 * L - 1,), dtype=torch.int64, device=a.device)
    for i in range(L):
        conv[..., i : i + L] += (a64[..., :, i : i + 1] * c64).sum(-2)
    return reduce_plain(ring, conv)


# ------------------------------------------------------------------ wrappers


def reduce(ring, x: torch.Tensor) -> torch.Tensor:
    """K8: signed int32 digits [..., nd] -> canonical int32 [..., L]."""
    if x.device.type == "cpu":
        return reduce_plain(ring, x)
    L, nd = ring.nlimb, x.shape[-1]
    if not 1 <= nd <= 2 * L - 1:
        raise ValueError(f"ring_reduce: {nd} digits, at most {2 * L - 1}")
    x = x.contiguous()
    check(x, "x", x.device)
    out = torch.empty(x.shape[:-1] + (L,), dtype=torch.int32, device=x.device)
    n = out.numel() // L
    if n:
        RING_REDUCE.launch(x.device, _rid(ring), ptr(x), ptr(out), n, nd)
    return out


def _canonical(ring, name: str, *ts) -> None:
    for i, t in enumerate(ts):
        if t.dtype != torch.int32 or t.dim() < 1 or t.shape[-1] != ring.nlimb:
            raise ValueError(f"{name}: operand {i} {t.dtype} {tuple(t.shape)}, expected int32 "
                             f"[..., {ring.nlimb}]")
    if len({t.device for t in ts}) > 1:
        raise ValueError(f"{name}: operands on {sorted(str(t.device) for t in ts)}")


def combine(ring, a: torch.Tensor, b, sa: int, sb: int) -> torch.Tensor:
    """K8's combine entry: canonical sa a + sb b over the broadcast shape
    (sa a alone where b is None), |sa|, |sb| < 2^9, one launch; the JAX
    package's _add_dev (1, 1), _sub_dev (1, -1), _neg_dev (-1) and mul_int's
    small path (v), each one program there."""
    if not (-SMALL < sa < SMALL and -SMALL < sb < SMALL):
        raise ValueError(f"ring_combine: scales {sa}, {sb} outside (-{SMALL}, {SMALL})")
    if a.device.type == "cpu" and (b is None or b.device.type == "cpu"):
        return combine_plain(ring, a, b, sa, sb)
    ts = (a,) if b is None else (a, b)
    _canonical(ring, "ring_combine", *ts)
    shape = _broadcast(*(t.shape for t in ts))
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    n = out.numel() // ring.nlimb
    if n:
        a, ag = _operand(a, shape)
        b, bg = (None, None) if b is None else _operand(b, shape)
        RING_COMBINE.launch(out.device, _rid(ring), ptr(a), ag, None if b is None else ptr(b),
                            bg, ptr(out), n, sa, sb)
    return out


def sum_axis(ring, a: torch.Tensor, axis: int) -> torch.Tensor:
    """K8's sum entry: the sum of canonical rows over batch axis `axis`, in
    one launch (the JAX package's _sum_dev); fewer than 2^22 terms."""
    if a.device.type == "cpu":
        return sum_plain(ring, a, axis)
    _canonical(ring, "ring_sum", a)
    ax = axis % a.dim()
    if ax == a.dim() - 1:
        raise ValueError("ring_sum: the digit axis is not a batch axis")
    k = a.shape[ax]
    if k >= 1 << 22:
        raise ValueError(f"ring_sum: {k} terms, fewer than 2^22")
    out = torch.empty(a.shape[:ax] + a.shape[ax + 1 :], dtype=torch.int32, device=a.device)
    n = out.numel() // ring.nlimb
    if n and not k:
        out.zero_()
    elif n:
        a = a.contiguous()
        RING_SUM.launch(a.device, _rid(ring), ptr(a), ptr(out), n, k,
                        math.prod(a.shape[ax + 1 : -1]))
    return out


def from_i32(ring, v: torch.Tensor) -> torch.Tensor:
    """K8's from_i32 entry: int32 values [...] -> canonical digits [..., L]
    of each value's 4 bytes (its value mod 2^32), in one launch."""
    if v.device.type == "cpu":
        return from_i32_plain(ring, v)
    v = v.to(torch.int32).contiguous()
    out = torch.empty(v.shape + (ring.nlimb,), dtype=torch.int32, device=v.device)
    n = v.numel()
    if n:
        RING_FROM_I32.launch(v.device, _rid(ring), ptr(v), ptr(out), n)
    return out


def mul(ring, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K9: canonical a * b, elementwise over the broadcast shape; a
    broadcast or transposed operand is read in place (_operand)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mul_plain(ring, a, b)
    _canonical(ring, "ring_mul", a, b)
    shape = _broadcast(a.shape, b.shape)
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    n = out.numel() // ring.nlimb
    if n:
        a, ag = _operand(a, shape)
        b, bg = _operand(b, shape)
        RING_MUL.launch(out.device, _rid(ring), ptr(a), ag, ptr(b), bg, ptr(out), n)
    return out


def matmul(ring, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """K10: [r, k, L] x [k, c, L] -> [r, c, L]."""
    if A.device.type == "cpu" and B.device.type == "cpu":
        return matmul_plain(ring, A, B)
    L = ring.nlimb
    r, k, _ = A.shape
    k2, c, _ = B.shape
    if k != k2 or A.shape[-1] != L or B.shape[-1] != L:
        raise ValueError(f"ring_matmul: {tuple(A.shape)} x {tuple(B.shape)}")
    if k > RING_MATMUL_MAX_K:
        raise ValueError(f"ring_matmul: k = {k} terms; the kernel takes at most "
                         f"{RING_MATMUL_MAX_K}")
    A, B = _aligned(A), _aligned(B)
    check(A, "A", A.device)
    check(B, "B", A.device)
    if k == 0:
        return torch.zeros((r, c, L), dtype=torch.int32, device=A.device)
    out = torch.empty((r, c, L), dtype=torch.int32, device=A.device)
    if r and c:
        RING_MATMUL.launch(A.device, _rid(ring), ptr(A), ptr(B), ptr(out), r, k, c)
    return out


def dot(ring, a: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """K11: sum_k a[..., k, :] * coeffs[k, :] -> [..., L]."""
    if a.device.type == "cpu" and coeffs.device.type == "cpu":
        return dot_plain(ring, a, coeffs)
    k, L = coeffs.shape
    if a.shape[-1] != L or a.shape[-2] != k or L != ring.nlimb:
        raise ValueError(f"ring_dot: {tuple(a.shape)} . {tuple(coeffs.shape)}")
    a, coeffs = _aligned(a), _aligned(coeffs)
    check(a, "a", a.device)
    check(coeffs, "coeffs", a.device)
    out = torch.empty(a.shape[:-2] + (L,), dtype=torch.int32, device=a.device)
    n = out.numel() // L
    if n and k:
        RING_DOT.launch(a.device, _rid(ring), ptr(a), ptr(coeffs), ptr(out), n, k)
    elif n:
        out.zero_()
    return out
