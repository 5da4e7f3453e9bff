"""ctypes bindings for the native TCP transport (native/transport.cpp, the
port's copy of sfgwas_tpu/native/transport.cpp).

NativeTCPTransport has the wire and the connection discipline of the JAX
package's NativeTCPTransport: the lower pid of a pair listens on the pair's
base port + channel and the higher one dials it; every frame is an 8-byte
little-endian length and the payload; the dialling party announces its pid
in its first frame (4 bytes, little-endian).  Blocking sends and receives
run in C with the interpreter lock released.

The library is compiled with g++ at its first use into
sfgwas_tpu_torch/_build/libsfgtransport-<hash>.so (the hash of the source
and the flags), as ops/native_ring.py builds the ring engine; nothing is
built when this module is imported.  A failed build or load raises
NativeBuildError with the compiler's output.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Any, Dict

from ..ops import native_ring
from ..ops.native_ring import NativeBuildError

PKG = Path(__file__).resolve().parents[1]
SRC = PKG / "native" / "transport.cpp"
CXX_FLAGS = ["-O2", "-fPIC", "-shared"]

_LIB = None
_lock = threading.Lock()  # a striped mesh opens its channels from several threads


def target(src: Path = None) -> Path:
    """The library path for a source (default SRC):
    _build/libsfgtransport-<hash>.so."""
    return native_ring.target(src or SRC, "libsfgtransport", CXX_FLAGS)


def build(src: Path = None, out: Path = None) -> Path:
    """Compile `src` (default SRC) into `out` (default: target(src)) unless
    it exists; raises NativeBuildError with g++'s output on a failure."""
    src = Path(src or SRC)
    return native_ring.build(src, Path(out) if out is not None else target(src), CXX_FLAGS)


def load(path: Path) -> ctypes.CDLL:
    """Load and bind a built transport; raises NativeBuildError on a failure."""
    try:
        L = ctypes.CDLL(str(path))
        L.sfg_listen.restype = ctypes.c_int
        L.sfg_listen.argtypes = [ctypes.c_int, ctypes.c_char_p]
        L.sfg_accept.restype = ctypes.c_int
        L.sfg_accept.argtypes = [ctypes.c_int]
        L.sfg_accept_within.restype = ctypes.c_int
        L.sfg_accept_within.argtypes = [ctypes.c_int, ctypes.c_int]
        L.sfg_connect.restype = ctypes.c_int
        L.sfg_connect.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        L.sfg_send_frame.restype = ctypes.c_int
        L.sfg_send_frame.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int64]
        L.sfg_recv_frame_len.restype = ctypes.c_int64
        L.sfg_recv_frame_len.argtypes = [ctypes.c_int]
        L.sfg_recv_frame_body.restype = ctypes.c_int
        L.sfg_recv_frame_body.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int64]
        L.sfg_close.restype = None
        L.sfg_close.argtypes = [ctypes.c_int]
    except (OSError, AttributeError) as e:
        raise NativeBuildError(f"cannot load the native transport {path}: {e}") from e
    return L


def lib() -> ctypes.CDLL:
    """The transport library, built and loaded at the first call."""
    global _LIB
    if _LIB is None:
        with _lock:
            if _LIB is None:
                _LIB = load(build())
    return _LIB


class NativeTCPTransport:
    """One connection per peer on one channel: port = the pair's base port
    (servers[lower pid]["ports"][higher pid]) + channel.  A party waits for
    each peer as long on either side of a pair: it dials `retries` times
    `retry_delay_ms` apart, and it waits that long for a peer to dial in,
    then raises ConnectionError."""

    def __init__(
        self,
        pid: int,
        nparty: int,
        servers: Dict[int, Dict[str, Any]],
        channel: int = 0,
        binding_ip: str = "0.0.0.0",
        retries: int = 100,
        retry_delay_ms: int = 1000,
    ):
        L = lib()
        self.pid = pid
        self.fds: Dict[int, int] = {}
        listen_fds: Dict[int, int] = {}
        try:
            for other in range(pid + 1, nparty):
                port = int(servers[pid]["ports"][other]) + channel
                fd = L.sfg_listen(port, binding_ip.encode())
                if fd < 0:
                    raise ConnectionError(f"party {pid}: cannot listen on {binding_ip}:{port}")
                listen_fds[other] = fd
            for other in range(nparty):
                if other == pid:
                    continue
                if other > pid:
                    fd = L.sfg_accept_within(listen_fds[other], retries * retry_delay_ms)
                    if fd < 0:
                        raise ConnectionError(f"party {pid}: party {other} did not dial in within "
                                              f"{retries * retry_delay_ms} ms")
                    self.fds[other] = fd
                    L.sfg_close(listen_fds.pop(other))
                    # the dialling party announces its pid in its first frame
                    got = self.recv_bytes(other)
                    if len(got) != 4 or int.from_bytes(got, "little") != other:
                        raise ConnectionError(
                            f"party {pid}: expected party {other}'s handshake, got {got!r}")
                else:
                    ip = servers[other]["ip"]
                    port = int(servers[other]["ports"][pid]) + channel
                    fd = L.sfg_connect(ip.encode(), port, retries, retry_delay_ms)
                    if fd < 0:
                        raise ConnectionError(f"party {pid}: cannot reach party {other} at "
                                              f"{ip}:{port}")
                    self.fds[other] = fd
                    self.send_bytes(other, pid.to_bytes(4, "little"))
        except BaseException:
            for fd in listen_fds.values():
                L.sfg_close(fd)
            self.close()
            raise

    def _fd(self, peer: int) -> int:
        fd = self.fds.get(peer)
        if fd is None:
            raise ConnectionError(f"party {self.pid}: no open connection to party {peer}")
        return fd

    def send_bytes(self, to: int, data: bytes):
        if lib().sfg_send_frame(self._fd(to), bytes(data), len(data)) != 0:
            raise ConnectionError(f"party {self.pid}: send to party {to} failed")

    def recv_bytes(self, frm: int, timeout=None) -> bytearray:
        """The next frame from party frm, received in place into the buffer
        returned (blocking; timeout is not used)."""
        L = lib()
        fd = self._fd(frm)
        n = L.sfg_recv_frame_len(fd)
        if n < 0:
            raise ConnectionError(f"party {self.pid}: the connection to party {frm} closed")
        buf = bytearray(n)
        if n and L.sfg_recv_frame_body(fd, (ctypes.c_char * n).from_buffer(buf), n) != 0:
            raise ConnectionError(f"party {self.pid}: the connection to party {frm} closed "
                                  "inside a frame")
        return buf

    def close(self):
        fds, self.fds = self.fds, {}
        for fd in fds.values():
            lib().sfg_close(fd)
