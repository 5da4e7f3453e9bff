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
* Network: typed blocking send/recv with per-peer byte and message counters,
  the pid-ordered symmetric exchange and the hub-rooted aggregation trees.

Messages passed by reference are shared between parties: no party writes in
place into a tensor it sent or received.  The TCP transports come with the
CLI slice.
"""

from __future__ import annotations

import io
import queue
import struct
from typing import Dict, Optional

import numpy as np
import torch

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
        out.write(a.tobytes())
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


def _dec(buf: io.BytesIO):
    tag = buf.read(1)
    if tag == b"N":
        return None
    if tag == b"b":
        return buf.read(1) == b"\x01"
    if tag == b"I":
        return struct.unpack("<q", buf.read(8))[0]
    if tag == b"F":
        return struct.unpack("<d", buf.read(8))[0]
    if tag == b"B":
        (n,) = struct.unpack("<q", buf.read(8))
        return buf.read(n)
    if tag == b"S":
        (n,) = struct.unpack("<q", buf.read(8))
        return buf.read(n).decode()
    if tag == b"A":
        (dl,) = struct.unpack("<B", buf.read(1))
        dt = np.dtype(buf.read(dl).decode())
        (nd,) = struct.unpack("<B", buf.read(1))
        shape = struct.unpack(f"<{nd}q", buf.read(8 * nd)) if nd else ()
        count = int(np.prod(shape)) if shape else 1
        data = buf.read(count * dt.itemsize)
        return np.frombuffer(data, dtype=dt).reshape(shape).copy()
    if tag in (b"L", b"T"):
        (n,) = struct.unpack("<q", buf.read(8))
        items = [_dec(buf) for _ in range(n)]
        return items if tag == b"L" else tuple(items)
    if tag == b"D":
        (n,) = struct.unpack("<q", buf.read(8))
        return {_dec(buf): _dec(buf) for _ in range(n)}
    raise ValueError(f"bad tag {tag!r}")


def encode(obj) -> bytes:
    out = io.BytesIO()
    _enc(obj, out)
    return out.getvalue()


def decode(data: bytes):
    return _dec(io.BytesIO(data))


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
