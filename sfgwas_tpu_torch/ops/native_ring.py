"""ctypes bindings for the native ring engine (native/ring.cpp, the port's
copy of sfgwas_tpu/native/ring.cpp).

The host SS engine's hot paths (elementwise 256/128-bit modular add, sub,
neg and mul, signed-digit reduction, weighted dot, matmul) run as C++
64-bit-limb loops with the GIL released and OpenMP across the elements;
Python keeps the canonical base-2^8 digit arrays of ops/ring.py at every
boundary, so PRG streams, the wire format and the shares are unchanged.

The library is compiled with g++ at its first use into
sfgwas_tpu_torch/_build/ (listed in .gitignore), named by a hash of the
source and the flags; nothing is built when this module is imported.  A
failed build or load raises with the compiler's output: nothing falls back
to the numpy path quietly.  The numpy path is chosen explicitly, by a ring
built with native=False (ops/ring.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

PKG = Path(__file__).resolve().parents[1]
SRC = PKG / "native" / "ring.cpp"
BUILD_DIR = PKG / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-fopenmp"]

# (modulus, kind) -> ring id in native/ring.cpp
_RING_IDS = {
    ((1 << 256) - 189, "prime"): 0,
    ((1 << 127) - 1, "prime"): 1,
    (1 << 256, "pow2"): 2,
    (1 << 127, "pow2"): 3,
}

_LIB = None
_lock = threading.Lock()  # party threads reach the first use together


class NativeBuildError(RuntimeError):
    """A native library (the ring engine, the TCP transport) could not be
    built or loaded."""


def ring_id(modulus: int, kind: str):
    """The engine's id of a ring, or None if the engine does not have it."""
    return _RING_IDS.get((modulus, kind))


def target(src: Path = None, prefix: str = "libsfgring", flags=None) -> Path:
    """The library path for a source (default SRC) built with `flags`
    (default CXX_FLAGS): _build/<prefix>-<hash of both>.so."""
    h = hashlib.sha256(Path(src or SRC).read_bytes())
    h.update(" ".join(CXX_FLAGS if flags is None else flags).encode())
    return BUILD_DIR / f"{prefix}-{h.hexdigest()[:12]}.so"


def build(src: Path = None, out: Path = None, flags=None) -> Path:
    """Compile `src` (default SRC) with `flags` (default CXX_FLAGS) into
    `out` (default: target(src)) unless it exists; raises NativeBuildError
    with g++'s output on a failure."""
    src = Path(src or SRC)
    flags = CXX_FLAGS if flags is None else flags
    out = Path(out) if out is not None else target(src)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        p = subprocess.run(["g++", *flags, "-o", tmp, str(src)], capture_output=True,
                           text=True)
    except OSError as e:
        os.unlink(tmp)
        raise NativeBuildError(f"g++ could not run: {e}") from e
    if p.returncode != 0:
        os.unlink(tmp)
        raise NativeBuildError(f"g++ failed on {src} (rc {p.returncode}):\n{p.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def load(path: Path) -> ctypes.CDLL:
    """Load and bind a built engine; raises NativeBuildError on a failure."""
    try:
        L = ctypes.CDLL(str(path))
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        # the elementwise ops take raw pointers: their one caller
        # (ring.Ring._native_canon2) hands them C-contiguous int32 rows, and
        # ndpointer's checks cost more than the op at the SS protocol's sizes
        for name in ("sfg_ring_add", "sfg_ring_sub", "sfg_ring_mul"):
            fn = getattr(L, name)
            fn.restype = None
            fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                           ctypes.c_void_p]
        L.sfg_ring_neg.restype = None
        L.sfg_ring_neg.argtypes = [ctypes.c_int, i32p, ctypes.c_int64, i32p]
        L.sfg_ring_reduce64.restype = None
        L.sfg_ring_reduce64.argtypes = [ctypes.c_int, i64p, ctypes.c_int64, ctypes.c_int, i32p]
        L.sfg_ring_dot.restype = None
        L.sfg_ring_dot.argtypes = [ctypes.c_int, i32p, i32p, ctypes.c_int64, ctypes.c_int64,
                                   i32p]
        L.sfg_ring_matmul.restype = None
        L.sfg_ring_matmul.argtypes = [ctypes.c_int, i32p, i32p, ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int64, i32p]
    except (OSError, AttributeError) as e:
        raise NativeBuildError(f"cannot load the native ring engine {path}: {e}") from e
    return L


def lib() -> ctypes.CDLL:
    """The engine, built and loaded at the first call."""
    global _LIB
    if _LIB is None:
        with _lock:
            if _LIB is None:
                _LIB = load(build())
    return _LIB
