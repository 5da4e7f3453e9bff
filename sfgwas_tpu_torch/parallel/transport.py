"""Party-to-party communication (counterpart of the local part of
sfgwas_tpu/parallel/transport.py):

* the wire codec (encode/decode), which writes the reference's frame bytes
  and takes torch tensors where the reference takes jax arrays (an int32
  tensor, the port's form of a uint32 residue array, goes as uint32);
* LocalCluster / LocalTransport: an in-process mesh of queues, one per
  (party pair, channel), for parties that run as threads of one process.
  Messages pass by reference (zero-copy): a tensor on the card stays there.
  A failing party closes the mesh, and every other party's next receive
  raises ClusterClosed (the JAX package's mesh has no close: its parties
  wait out their receive timeouts);
* the TCP mesh, for parties in separate processes: TCPTransport (sockets),
  native_transport.NativeTCPTransport (the same wire in C), StripedTransport
  (K channels a pair, each large frame striped across them) and
  make_tcp_transport, the factory the protocol calls.  The lower pid of a
  pair listens on the pair's base port + channel; every frame is an 8-byte
  little-endian length and the payload, and the dialling party announces its
  pid in its first frame.  That is the JAX package's wire, so parties of both
  packages run one protocol together (its pure-Python TCPTransport sends the
  pid raw instead; the port's two transports both speak the framed
  handshake of its native one, which is the one it uses);
* Network: typed blocking send/recv with per-peer byte and message counters,
  the pid-ordered symmetric exchange and the hub-rooted aggregation trees.

Messages passed by reference are shared between parties: no party writes in
place into a tensor it sent or received.  Over a socket every message goes
through the codec: a tensor arrives as a numpy array, and an int32 tensor as
uint32.
"""

from __future__ import annotations

import io
import math
import queue
import socket
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .native_transport import NativeTCPTransport

# ---------------------------------------------------------------------------
# Codec


def _enc(obj, out: io.BytesIO):
    if obj is None:
        out.write(b"N")
    elif isinstance(obj, bool):
        out.write(b"b" + (b"\x01" if obj else b"\x00"))
    elif isinstance(obj, (int, np.integer)):
        out.write(b"I" + struct.pack("<q", int(obj)))
    elif isinstance(obj, float):
        out.write(b"F" + struct.pack("<d", obj))
    elif isinstance(obj, bytes):
        out.write(b"B" + struct.pack("<q", len(obj)) + obj)
    elif isinstance(obj, str):
        e = obj.encode()
        out.write(b"S" + struct.pack("<q", len(e)) + e)
    elif isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        dt = a.dtype.str.encode()
        out.write(b"A" + struct.pack("<B", len(dt)) + dt)
        out.write(struct.pack("<B", a.ndim))
        out.write(struct.pack(f"<{a.ndim}q", *a.shape))
        out.write(a.reshape(-1).view(np.uint8))  # the array's bytes, copied once
    elif isinstance(obj, (list, tuple)):
        tag = b"L" if isinstance(obj, list) else b"T"
        out.write(tag + struct.pack("<q", len(obj)))
        for it in obj:
            _enc(it, out)
    elif isinstance(obj, dict):
        out.write(b"D" + struct.pack("<q", len(obj)))
        for k, v in obj.items():
            _enc(k, out)
            _enc(v, out)
    elif isinstance(obj, torch.Tensor):
        # a tensor travels as the numpy array of its dtype (read back from
        # the card where it lies there), but an int32 tensor is the port's
        # uint32 residue: it goes as <u4 with the same bits, as the
        # reference frames its residues
        a = obj.detach().cpu().numpy()
        _enc(a.view(np.uint32) if a.dtype == np.int32 else a, out)
    else:
        arr = np.asarray(obj)
        if arr.dtype == object:
            raise TypeError(f"cannot serialize {type(obj)}")
        _enc(arr, out)


class _Reader:
    """A cursor over a frame's bytes: reads are views, not copies."""

    def __init__(self, data):
        self.mv = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        v = self.mv[self.pos : self.pos + n]
        if len(v) != n:
            raise ValueError(f"frame ends inside a value ({len(v)} of {n} bytes)")
        self.pos += n
        return v

    def unpack(self, fmt: str):
        out = struct.unpack_from(fmt, self.take(struct.calcsize(fmt)))
        return out[0] if len(out) == 1 else out


def _dec(r: _Reader):
    tag = bytes(r.take(1))
    if tag == b"N":
        return None
    if tag == b"b":
        return bytes(r.take(1)) == b"\x01"
    if tag == b"I":
        return r.unpack("<q")
    if tag == b"F":
        return r.unpack("<d")
    if tag == b"B":
        return bytes(r.take(r.unpack("<q")))
    if tag == b"S":
        return str(r.take(r.unpack("<q")), "utf-8")
    if tag == b"A":
        dt = np.dtype(str(r.take(r.unpack("<B")), "ascii"))
        nd = r.unpack("<B")
        shape = struct.unpack_from(f"<{nd}q", r.take(8 * nd)) if nd else ()
        count = math.prod(shape)
        # one copy: the array owns its memory, not a view into the frame
        return np.frombuffer(r.take(count * dt.itemsize), dtype=dt).reshape(shape).copy()
    if tag in (b"L", b"T"):
        items = [_dec(r) for _ in range(r.unpack("<q"))]
        return items if tag == b"L" else tuple(items)
    if tag == b"D":
        n = r.unpack("<q")
        return {_dec(r): _dec(r) for _ in range(n)}
    raise ValueError(f"bad tag {tag!r}")


def encode(obj) -> bytes:
    out = io.BytesIO()
    _enc(obj, out)
    return out.getvalue()


def decode(data):
    """The object of a frame (bytes or any bytes-like buffer)."""
    return _dec(_Reader(data))


# ---------------------------------------------------------------------------
# The local transport


class ClusterClosed(ConnectionError):
    """A send or receive on a LocalCluster that was closed."""


_CLOSED = object()  # the end-of-cluster marker in every queue


class LocalCluster:
    """In-process mesh: queues per (src, dst, channel)."""

    def __init__(self, nparty: int, nchannel: int = 1):
        self.nparty = nparty
        self.nchannel = nchannel
        self.queues: Dict[tuple, queue.Queue] = {}
        self.closed_reason: Optional[str] = None
        for s in range(nparty):
            for d in range(nparty):
                for c in range(nchannel):
                    if s != d:
                        self.queues[(s, d, c)] = queue.Queue()

    def transport(self, pid: int, channel: int = 0) -> "LocalTransport":
        return LocalTransport(self, pid, channel)

    def close(self, reason: str):
        """End the mesh: every later send, and every receive once the
        messages already queued are read, raises ClusterClosed at once.  A
        party that fails closes it, so the others do not wait out their
        receive timeouts."""
        if self.closed_reason is None:
            self.closed_reason = reason
        for q in self.queues.values():
            q.put(_CLOSED)

    def _put(self, key, obj):
        if self.closed_reason is not None:
            raise ClusterClosed(self.closed_reason)
        self.queues[key].put(obj)

    def _get(self, key, timeout: Optional[float]):
        q = self.queues[key]
        obj = q.get(timeout=timeout)
        if obj is _CLOSED:
            q.put(_CLOSED)  # for the next receive on this queue
            raise ClusterClosed(self.closed_reason)
        return obj


def _to_host(obj):
    """Normalize a message for zero-copy local delivery: tensors pass by
    reference (a tensor on the card is not read back), numpy arrays are
    frozen (writeable=False) so neither side can change the shared buffer,
    other array-likes become frozen numpy arrays."""
    if isinstance(obj, np.ndarray):
        try:
            obj.flags.writeable = False
        except ValueError:
            pass
        return obj
    if isinstance(obj, (type(None), bool, int, float, bytes, str, np.integer, torch.Tensor)):
        return obj
    if isinstance(obj, list):
        return [_to_host(x) for x in obj]
    if isinstance(obj, tuple):
        return tuple(_to_host(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    arr = np.asarray(obj)
    if arr.dtype == object:
        raise TypeError(f"cannot send {type(obj)}")
    return _to_host(arr)


def _approx_size(obj) -> int:
    """Logical wire size for the byte counters (zero-copy path)."""
    if isinstance(obj, np.ndarray):
        return obj.nbytes + 16
    if isinstance(obj, torch.Tensor):
        return obj.nelement() * obj.element_size() + 16
    if isinstance(obj, (list, tuple)):
        return 9 + sum(_approx_size(x) for x in obj)
    if isinstance(obj, dict):
        return 9 + sum(_approx_size(k) + _approx_size(v) for k, v in obj.items())
    if isinstance(obj, (bytes, str)):
        return len(obj) + 9
    return 9


class LocalTransport:
    """In-process transport: messages pass as Python object references
    (zero-copy).  All parties use the card's default stream, so a tensor
    handed across is complete for every later launch of the receiver."""

    zero_copy = True

    def __init__(self, cluster: LocalCluster, pid: int, channel: int):
        self.cluster = cluster
        self.pid = pid
        self.channel = channel

    def send_obj(self, to: int, obj):
        self.cluster._put((self.pid, to, self.channel), obj)

    def recv_obj(self, frm: int, timeout: Optional[float] = 3600.0):
        return self.cluster._get((frm, self.pid, self.channel), timeout)

    def send_bytes(self, to: int, data: bytes):
        self.cluster._put((self.pid, to, self.channel), data)

    def recv_bytes(self, frm: int, timeout: Optional[float] = 3600.0) -> bytes:
        return self.cluster._get((frm, self.pid, self.channel), timeout)

    def close(self):
        pass


# ---------------------------------------------------------------------------
# The TCP mesh


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], min(n - got, 1 << 24))
        if k == 0:
            raise ConnectionError("the peer closed the connection")
        got += k
    return buf


class TCPTransport:
    """One socket per peer on one channel: port = the pair's base port
    (servers[lower pid]["ports"][higher pid]) + channel; the lower pid
    listens.  The wire, the handshake and the waits for a peer are
    NativeTCPTransport's."""

    def __init__(
        self,
        pid: int,
        nparty: int,
        servers: Dict[int, Dict[str, Any]],
        channel: int = 0,
        binding_ip: str = "0.0.0.0",
        retries: int = 100,
        retry_delay: float = 1.0,
    ):
        self.pid = pid
        self.socks: Dict[int, socket.socket] = {}
        self.lock: Dict[int, threading.Lock] = {}
        listen: Dict[int, socket.socket] = {}
        try:
            for other in range(pid + 1, nparty):
                srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                listen[other] = srv
                srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                srv.bind((binding_ip, int(servers[pid]["ports"][other]) + channel))
                srv.listen(1)
                srv.settimeout(retries * retry_delay)
            for other in range(nparty):
                if other == pid:
                    continue
                self.lock[other] = threading.Lock()
                if other > pid:
                    try:
                        conn, _ = listen[other].accept()
                    except socket.timeout:
                        raise ConnectionError(f"party {pid}: party {other} did not dial in "
                                              f"within {retries * retry_delay} s") from None
                    conn.settimeout(None)
                    listen.pop(other).close()
                    self._add(other, conn)
                    # the dialling party announces its pid in its first frame
                    got = self.recv_bytes(other)
                    if len(got) != 4 or int.from_bytes(got, "little") != other:
                        raise ConnectionError(
                            f"party {pid}: expected party {other}'s handshake, got {got!r}")
                else:
                    ip = servers[other]["ip"]
                    port = int(servers[other]["ports"][pid]) + channel
                    self._add(other, self._dial(ip, port, retries, retry_delay))
                    self.send_bytes(other, pid.to_bytes(4, "little"))
        except BaseException:
            for srv in listen.values():
                srv.close()
            self.close()
            raise

    def _dial(self, ip: str, port: int, retries: int, retry_delay: float) -> socket.socket:
        for _ in range(retries):
            try:
                s = socket.create_connection((ip, port), timeout=10)
            except OSError:
                time.sleep(retry_delay)
                continue
            s.settimeout(None)  # connect with a timeout, then block like the native transport
            return s
        raise ConnectionError(f"party {self.pid}: cannot reach {ip}:{port}")

    def _add(self, other: int, s: socket.socket):
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.socks[other] = s

    def _sock(self, peer: int) -> socket.socket:
        s = self.socks.get(peer)
        if s is None:
            raise ConnectionError(f"party {self.pid}: no open connection to party {peer}")
        return s

    def send_bytes(self, to: int, data: bytes):
        s = self._sock(to)
        with self.lock[to]:
            s.sendall(struct.pack("<q", len(data)))
            s.sendall(data)

    def recv_bytes(self, frm: int, timeout: Optional[float] = None) -> bytearray:
        """The next frame from party frm (blocking; timeout is not used)."""
        s = self._sock(frm)
        (n,) = struct.unpack("<q", _recv_exact(s, 8))
        return _recv_exact(s, n)

    def close(self):
        socks, self.socks = self.socks, {}
        for s in socks.values():
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            s.close()


STRIPE_MIN = 1 << 20  # frames below this many bytes ride channel 0 whole


class StripedTransport:
    """K single-channel transports a party pair (channel c on base port + c),
    each large frame cut into K stripes that move through them at once.

    The wire of one message, the JAX package's:
      channel 0:  a tag byte, 0 = the payload inline, or 1 = striped, then
                  <q total length> and stripe 0;
      channel c:  stripe c (c = 1..K-1), only when striped.
    Channel-0 frames alone set the order of a pair's messages.  Which frames
    are striped (stripe_min) is the sender's choice: the tag tells the
    receiver."""

    def __init__(self, make_channel: Callable[[int], Any], nchannel: int,
                 stripe_min: int = STRIPE_MIN):
        if nchannel < 1:
            raise ValueError(f"nchannel must be >= 1, got {nchannel}")
        self.nchannel = nchannel
        self.stripe_min = stripe_min
        self.chans = []
        try:
            for c in range(nchannel):
                self.chans.append(make_channel(c))
        except BaseException:
            self.close()
            raise
        self._broken = False
        self._pool = (ThreadPoolExecutor(max_workers=nchannel - 1, thread_name_prefix="stripe")
                      if nchannel > 1 else None)

    def send_bytes(self, to: int, data: bytes):
        k = self.nchannel
        if k == 1 or len(data) < self.stripe_min:
            self.chans[0].send_bytes(to, b"\x00" + data)
            return
        step = (len(data) + k - 1) // k
        view = memoryview(data)
        futs = [self._pool.submit(self.chans[c].send_bytes, to, view[c * step:(c + 1) * step])
                for c in range(1, k)]
        self.chans[0].send_bytes(to, b"\x01" + struct.pack("<q", len(data)) + data[:step])
        for f in futs:
            f.result()

    def recv_bytes(self, frm: int, timeout: Optional[float] = None):
        """The next message from party frm (bytes-like)."""
        if self._broken:
            raise ConnectionError("the striped transport broke on an earlier receive")
        head = self.chans[0].recv_bytes(frm, timeout)
        if head[:1] == b"\x00":
            return head[1:]
        (total,) = struct.unpack("<q", head[1:9])
        futs = [self._pool.submit(self.chans[c].recv_bytes, frm, timeout)
                for c in range(1, self.nchannel)]
        try:
            parts = [head[9:]] + [f.result() for f in futs]
        except BaseException:
            # a header and some stripes were read: the pair's streams are out
            # of step for good, so the whole mesh fails now
            self._broken = True
            self.close()
            raise
        out = b"".join(parts)
        if len(out) != total:
            self._broken = True
            self.close()
            raise ConnectionError(f"striped frame from party {frm}: {len(out)} of {total} bytes")
        return out

    def close(self):
        for ch in self.chans:
            ch.close()
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.shutdown(wait=False)


def make_tcp_transport(
    pid: int,
    nparty: int,
    servers: Dict[int, Dict[str, Any]],
    nchannel: int = 1,
    binding_ip: str = "0.0.0.0",
    native: bool = True,
):
    """The protocol's TCP mesh: NativeTCPTransport (native=False:
    TCPTransport), striped over nchannel connections a pair when nchannel >
    1.  A failure to build the native library or to connect raises; nothing
    falls back to the other transport."""
    if nchannel > 1:
        # pair (a, b)'s channel k is on base + k: bases closer than nchannel
        # would put two pairs' channels on one port
        bases = sorted(int(port) for a in range(nparty)
                       for port in servers.get(a, {}).get("ports", {}).values())
        for lo, hi in zip(bases, bases[1:]):
            if hi - lo < nchannel:
                raise ValueError(
                    f"pair base ports {lo} and {hi} are closer than mpc_num_threads="
                    f"{nchannel}: the striped channels would collide; space the ports.party* "
                    "bases further apart")
    channel_cls = NativeTCPTransport if native else TCPTransport

    def make_channel(c: int):
        return channel_cls(pid, nparty, servers, c, binding_ip)

    if nchannel <= 1:
        return make_channel(0)
    return StripedTransport(make_channel, nchannel)


# ---------------------------------------------------------------------------
# Network: typed messaging + counters + hub helpers


class Network:
    def __init__(self, transport, pid: int, nparty: int, hub_pid: int = 1, rand=None):
        self.t = transport
        self.pid = pid
        self.nparty = nparty
        self.hub_pid = hub_pid
        self.rand = rand
        self.log_enabled = True
        self.reset_log()

    # -- counters ------------------------------------------------------------

    def reset_log(self):
        self.sent_bytes = {p: 0 for p in range(self.nparty)}
        self.recv_bytes = {p: 0 for p in range(self.nparty)}
        self.sent_msgs = {p: 0 for p in range(self.nparty)}
        self.recv_msgs = {p: 0 for p in range(self.nparty)}

    def enable_logging(self):
        self.log_enabled = True

    def disable_logging(self):
        self.log_enabled = False

    def print_log(self):
        for p in range(self.nparty):
            if p == self.pid:
                continue
            print(
                f"[net pid={self.pid}] peer {p}: sent {self.sent_bytes[p]} B "
                f"({self.sent_msgs[p]} msgs), recv {self.recv_bytes[p]} B "
                f"({self.recv_msgs[p]} msgs)"
            )

    # -- typed send/recv -----------------------------------------------------

    def send(self, obj, to: int):
        if getattr(self.t, "zero_copy", False):
            obj = _to_host(obj)
            if self.log_enabled:
                self.sent_bytes[to] += _approx_size(obj)
                self.sent_msgs[to] += 1
            self.t.send_obj(to, obj)
            return
        data = encode(obj)
        if self.log_enabled:
            self.sent_bytes[to] += len(data)
            self.sent_msgs[to] += 1
        self.t.send_bytes(to, data)

    def recv(self, frm: int):
        if getattr(self.t, "zero_copy", False):
            obj = self.t.recv_obj(frm)
            if self.log_enabled:
                self.recv_bytes[frm] += _approx_size(obj)
                self.recv_msgs[frm] += 1
            return obj
        data = self.t.recv_bytes(frm)
        if self.log_enabled:
            self.recv_bytes[frm] += len(data)
            self.recv_msgs[frm] += 1
        return decode(data)

    def send_int(self, v: int, to: int):
        self.send(int(v), to)

    def recv_int(self, frm: int) -> int:
        v = self.recv(frm)
        if not isinstance(v, int):
            raise TypeError(f"recv_int: got {type(v)} from party {frm}")
        return v

    def exchange(self, obj, other: int):
        """Symmetric exchange, ordered by pid (the lower pid sends first)."""
        if self.pid < other:
            self.send(obj, other)
            return self.recv(other)
        got = self.recv(other)
        self.send(obj, other)
        return got

    # -- hub aggregation trees ----------------------------------------------

    def hub_gather_sum(self, x, add_fn, include_zero: bool = False):
        """Data parties send to the hub; the hub returns the sum (None at
        the others).  Parties below `first` (the dealer, unless
        include_zero) do not take part and get their input back."""
        first = 0 if include_zero else 1
        if self.pid < first:
            return x
        if self.pid == self.hub_pid:
            acc = x
            for p in range(first, self.nparty):
                if p == self.pid:
                    continue
                acc = add_fn(acc, self.recv(p))
            return acc
        self.send(x, self.hub_pid)
        return None

    def hub_broadcast(self, x, include_zero: bool = False):
        first = 0 if include_zero else 1
        if self.pid < first:
            return x
        if self.pid == self.hub_pid:
            for p in range(first, self.nparty):
                if p != self.pid:
                    self.send(x, p)
            return x
        return self.recv(self.hub_pid)

    def aggregate(self, x, add_fn, include_zero: bool = False):
        """Gather-add at the hub, then broadcast back: every participating
        party gets the sum; the dealer gets its input back."""
        s = self.hub_gather_sum(x, add_fn, include_zero)
        return self.hub_broadcast(s, include_zero)

    def close(self):
        self.t.close()
