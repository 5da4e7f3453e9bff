"""Build and bind the port's CUDA kernels.

Each source csrc/<name>.cu exposes a plain C interface and is compiled by
hand with nvcc for sm_90a into a shared library that ctypes loads; no
PyTorch headers are involved, so a build takes seconds.  Libraries go to
sfgwas_tpu_torch/_build/ (listed in .gitignore), named by a hash of the
source, the shared headers csrc/*.cuh and the flags, so a changed source or
header is rebuilt at its first use.
Nothing is built or loaded when this module is imported.

The parties of a local simulation are threads that share one card, so the
first use of a library (build, load, bind) and the launch counters are
guarded by one lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

import torch

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
SOURCES = ("ntt", "mac_dense", "ks_digit", "crp", "bs_share", "crt_lift", "ring")


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile the named sources that have no current library, one nvcc
    process per source, all started together.  Returns seconds per source
    built; raises with nvcc's output on a failure.  ptxas' register and
    shared-memory report is kept beside each library (<lib>.log)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        procs.append((name, out, tmp, p, time.time()))
    secs: Dict[str, float] = {}
    failed: List[str] = []
    for name, out, tmp, p, t0 in procs:
        log = p.communicate()[0].decode(errors="replace")
        secs[name] = time.time() - t0
        Path(str(out) + ".log").write_text(log)
        if p.returncode != 0:
            os.unlink(tmp)
            failed.append(f"--- {name}.cu (rc {p.returncode})\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return secs


def ptxas_report(name: str) -> List[Dict]:
    """Per kernel of the current build of a source, from ptxas -v: its
    (mangled) name, registers, stack frame, spill stores and loads in bytes,
    and static shared memory in bytes."""
    p = Path(str(_target(name)) + ".log")
    if not p.exists():
        return []
    out: List[Dict] = []
    for line in p.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            out.append({"kernel": m.group(1), "registers": None, "stack": 0, "spill_stores": 0,
                        "spill_loads": 0, "smem": 0})
            continue
        if not out:
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            out[-1]["stack"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[-1]["spill_stores"], out[-1]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[-1]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            out[-1]["smem"] = int(m.group(1))
    return out


_libs: Dict[str, ctypes.CDLL] = {}
# guards _libs, the build at first use, each kernel's binding and its
# launch count (party threads launch concurrently)
_lock = threading.RLock()


def load(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            out = _target(name)
            if not out.exists():
                build([name])
            _libs[name] = ctypes.CDLL(str(out))
        return _libs[name]


# every CudaKernel ever constructed, by kernel name (read by chip_smoke.py)
REGISTRY: Dict[str, "CudaKernel"] = {}


class CudaKernel:
    """One exported launcher `int symbol(args..., cudaStream_t)` of a csrc
    library.  The C function launches on the given stream and returns
    cudaGetLastError(); a nonzero code raises here.  `launches` counts the
    successful launches."""

    def __init__(self, lib: str, symbol: str, argtypes: List):
        self.lib = lib
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]  # + stream
        self.launches = 0
        self._fn = None
        REGISTRY[symbol] = self

    def _bind(self):
        with _lock:
            if self._fn is not None:
                return
            lib = load(self.lib)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, "csrc_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._err = err
            self._fn = fn  # last: another thread sees a bound kernel only when complete

    def launch(self, device: torch.device, *args) -> None:
        if self._fn is None:
            self._bind()
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = self._fn(*args, stream)
        if rc != 0:
            raise RuntimeError(
                f"{self.symbol}: CUDA error {rc} ({self._err(rc).decode()})"
            )
        with _lock:
            self.launches += 1


def reset_launch_counts() -> None:
    with _lock:
        for k in REGISTRY.values():
            k.launches = 0


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check(t: torch.Tensor, name: str, device: torch.device, shape=None, dtype=torch.int32):
    """Raise unless t is a contiguous tensor of `dtype` on `device` (and of
    `shape`, where given)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
