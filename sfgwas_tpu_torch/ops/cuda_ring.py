"""Kernels K8-K11 and their plain versions: the SS ring's device path
(counterpart of the jitted device methods of sfgwas_tpu/ops/ring.py;
source csrc/ring.cu).

Each wrapper takes int32 digit tensors ([..., nlimb], ops/ring.py's
layout) and launches the CUDA kernel for CUDA tensors; for CPU tensors it
runs the plain torch version beside it, which the tests hold bit-equal to
the JAX device path.  It never falls back to the plain version on the
card: a CUDA tensor the kernel cannot take raises.

  reduce (K8)  any signed digit array, at most 2L - 1 digits -> canonical
  mul    (K9)  elementwise product of canonical arrays (broadcast first)
  matmul (K10) [r, k, L] x [k, c, L] -> [r, c, L], any k
  dot    (K11) sum_k a[..., k, :] * coeffs[k, :]

The plain versions compute in int64, exactly, with the JAX functions'
steps: the carry passes, folds and conditional subtracts of _reduce_dev,
the digit convolutions of _mul_dev, _matmul_dev and _dot_coeffs_dev.
"""

from __future__ import annotations

import ctypes

import torch

from . import native_ring
from .cuda_build import CudaKernel, check, ptr

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

RING_REDUCE = CudaKernel("ring", "ring_reduce", [_I, _P, _P, _LL, _I])
RING_MUL = CudaKernel("ring", "ring_mul", [_I, _P, _P, _P, _LL])
RING_MATMUL = CudaKernel("ring", "ring_matmul", [_I, _P, _P, _P, _I, _I, _I])
RING_DOT = CudaKernel("ring", "ring_dot", [_I, _P, _P, _P, _LL, _I])

DIGIT_BITS = 8


def _rid(ring) -> int:
    rid = native_ring.ring_id(ring.modulus, ring.kind)
    if rid is None:
        raise ValueError(f"no device kernel for {ring}")
    return rid


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous, starting on a 16-byte boundary (the kernels read and
    write a row's digits 4 at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


# ------------------------------------------------------------ plain versions


def _carry(x: torch.Tensor):
    """Exact carry over the digit axis (int64): (digits in [0, 255],
    carry out).  Carries shrink by 2^8 a pass."""
    out = x.clone()
    c_out = torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    while True:
        q = out >> DIGIT_BITS
        if not bool(q.any()):
            return out, c_out
        out -= q << DIGIT_BITS
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
    """Digit convolution of canonical arrays -> [..., 2L-1] int64."""
    L = a.shape[-1]
    a, b = torch.broadcast_tensors(a.to(torch.int64), b.to(torch.int64))
    conv = torch.zeros(a.shape[:-1] + (2 * L - 1,), dtype=torch.int64, device=a.device)
    for i in range(L):
        conv[..., i : i + L] += a[..., i : i + 1] * b
    return conv


def mul_plain(ring, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return reduce_plain(ring, _conv(a, b))


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


def mul(ring, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K9: canonical a * b, elementwise over the broadcast shape."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mul_plain(ring, a, b)
    L = ring.nlimb
    if a.shape[-1] != L or b.shape[-1] != L:
        raise ValueError(f"ring_mul: digit axes {a.shape[-1]}, {b.shape[-1]}, expected {L}")
    a, b = (_aligned(t) for t in torch.broadcast_tensors(a, b))
    check(a, "a", a.device)
    check(b, "b", a.device)
    out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    n = out.numel() // L
    if n:
        RING_MUL.launch(a.device, _rid(ring), ptr(a), ptr(b), ptr(out), n)
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
