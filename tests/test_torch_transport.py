"""The port's TCP mesh (sfgwas_tpu_torch/parallel/transport.py and
native_transport.py) against the JAX package's, byte for byte, over
loopback on ports the OS hands out at run time: the port's native and
Python transports each talk to the reference's NativeTCPTransport (the
framed pid handshake, then frames both ways), the striped transports talk
to each other (a 5 MB frame striped over 3 channels, then a small one
inline, in order), and Network messages cross in both directions (a torch
int32 tensor reaches the reference as <u4 with the same bits; a reference
ciphertext dict reaches the port and ct_from_wire restores it bit for
bit).  Also: the port-collision check, a failed build that raises, a
closed peer that raises at the next receive, and no silent fallback from
the native transport to the Python one."""

import socket
import threading
import time

import numpy as np
import pytest
import torch

from sfgwas_tpu.parallel import native_transport as RN
from sfgwas_tpu.parallel import transport as RT
from sfgwas_tpu_torch.mpc import mhe as PM
from sfgwas_tpu_torch.ops import native_ring
from sfgwas_tpu_torch.parallel import native_transport as PN
from sfgwas_tpu_torch.parallel import transport as PT

JOIN_S = 60


def free_base(k: int = 1) -> int:
    """A port p with p..p+k-1 free on 127.0.0.1 right now."""
    for _ in range(100):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + k > 65535:
            continue
        socks = []
        try:
            for c in range(k):
                t = socket.socket()
                socks.append(t)
                t.bind(("127.0.0.1", base + c))
            return base
        except OSError:
            continue
        finally:
            for t in socks:
                t.close()
    raise RuntimeError("no free port range")


def two_party_servers(base: int) -> dict:
    return {0: {"ip": "127.0.0.1", "ports": {1: base}}, 1: {"ip": "127.0.0.1", "ports": {}}}


def run_pair(fn0, fn1):
    """fn0 and fn1 as parties 0 and 1 in two threads; returns their results
    and raises the first error."""
    res, errs = [None, None], []

    def work(pid, fn):
        try:
            res[pid] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    ts = [threading.Thread(target=work, args=(p, f), daemon=True)
          for p, f in enumerate((fn0, fn1))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in ts), "a party hung"
    if errs:
        raise errs[0]
    return res


PORT_KINDS = {
    "port_native": lambda pid, servers: PN.NativeTCPTransport(
        pid, 2, servers, 0, "127.0.0.1", retries=50, retry_delay_ms=100),
    "port_python": lambda pid, servers: PT.TCPTransport(
        pid, 2, servers, 0, "127.0.0.1", retries=50, retry_delay=0.1),
}


def ref_native(pid, servers):
    return RN.NativeTCPTransport(pid, 2, servers, 0, "127.0.0.1", retries=50,
                                 retry_delay_ms=100)


def _talk(t, pid: int):
    """Party 0 sends a frame and reads the echo; party 1 echoes it back
    with a suffix, then both send an empty frame."""
    try:
        if pid == 0:
            t.send_bytes(1, b"hello" * 1000)
            got = t.recv_bytes(1)
            t.send_bytes(1, b"")
            return got
        got = t.recv_bytes(0)
        t.send_bytes(0, got + b"!")
        return t.recv_bytes(0)
    finally:
        t.close()


@pytest.mark.parametrize("port_pid", [0, 1])
@pytest.mark.parametrize("kind", sorted(PORT_KINDS))
def test_port_transport_talks_to_reference_native(kind, port_pid):
    """Either port transport as the listening or the dialling party, the
    reference's native transport as the other: the framed handshake
    completes and frames cross unchanged."""
    servers = two_party_servers(free_base())
    make = {port_pid: PORT_KINDS[kind], 1 - port_pid: ref_native}
    res = run_pair(lambda: _talk(make[0](0, servers), 0), lambda: _talk(make[1](1, servers), 1))
    assert res[0] == b"hello" * 1000 + b"!"
    assert res[1] == b""


def test_port_native_builds_from_its_own_source():
    lib = PN.lib()
    path = PN.target()
    assert path.parent == PN.PKG / "_build" and path.exists()
    assert path.name.startswith("libsfgtransport-")
    assert PN.SRC == PN.PKG / "native" / "transport.cpp"
    assert lib._name == str(path)


@pytest.mark.parametrize("native", [True, False])
def test_port_striped_talks_to_reference_striped(native):
    """nchannel 3: a 5 MB frame goes striped, then a small frame inline, in
    order, port -> reference; then the reference stripes a frame back."""
    base = free_base(3)
    servers = two_party_servers(base)
    big = np.random.default_rng(0).integers(0, 255, size=5_000_000, dtype=np.uint8).tobytes()

    def port():
        t = PT.make_tcp_transport(0, 2, servers, nchannel=3, binding_ip="127.0.0.1",
                                  native=native)
        try:
            assert isinstance(t, PT.StripedTransport) and t.nchannel == 3
            t.send_bytes(1, big)
            t.send_bytes(1, b"ping")
            return t.recv_bytes(1)
        finally:
            t.close()

    def ref():
        t = RT.make_tcp_transport(1, 2, servers, nchannel=3)
        try:
            got = [t.recv_bytes(0), t.recv_bytes(0)]
            t.send_bytes(0, got[0][::-1])
            return got
        finally:
            t.close()

    res = run_pair(port, ref)
    assert res[1][0] == big and res[1][1] == b"ping"
    assert res[0] == big[::-1]


def test_stripe_threshold_is_the_senders_choice():
    """The port's stripe_min is a constructor argument; the tag byte tells
    the receiver, so a port that stripes every frame still talks to a
    reference that stripes only large ones."""
    servers = two_party_servers(free_base(2))
    msgs = [b"", b"x", bytes(range(256)) * 3]

    def port():
        t = PT.StripedTransport(
            lambda c: PN.NativeTCPTransport(0, 2, servers, c, "127.0.0.1"), 2, stripe_min=1)
        try:
            for m in msgs:
                t.send_bytes(1, m)
            return [t.recv_bytes(1) for _ in msgs]
        finally:
            t.close()

    def ref():
        t = RT.make_tcp_transport(1, 2, servers, nchannel=2)
        try:
            got = [t.recv_bytes(0) for _ in msgs]
            for m in got:
                t.send_bytes(0, m)
            return got
        finally:
            t.close()

    res = run_pair(port, ref)
    assert res[0] == msgs and res[1] == msgs


def test_network_messages_cross_packages():
    """Typed Network messages over the port's native transport and the
    reference's: a torch int32 tensor of residues arrives at the reference
    as <u4 with the same bits; a reference ciphertext dict (jax uint32
    arrays) arrives at the port and ct_from_wire restores it bit for bit;
    nested objects keep their Python types both ways."""
    import jax.numpy as jnp

    servers = two_party_servers(free_base())
    rng = np.random.default_rng(5)
    res_u32 = rng.integers(0, 1 << 26, size=(3, 64), dtype=np.uint32)
    c0 = rng.integers(0, 1 << 26, size=(2, 64), dtype=np.uint32)
    c1 = rng.integers(0, 1 << 26, size=(2, 64), dtype=np.uint32)
    meta = {"n": 7, "f": 2.5, "s": "x", "l": [1, None, True], "t": (b"b", np.int64(3))}

    def port():
        net = PT.Network(PN.NativeTCPTransport(0, 2, servers, 0, "127.0.0.1"), 0, 2, 1)
        try:
            net.send(torch.from_numpy(res_u32.view(np.int32)), 1)
            net.send(meta, 1)
            ct = PM.ct_from_wire(net.recv(1), "cpu")
            back = net.recv(1)
            return ct, back, net.sent_bytes[1], net.recv_bytes[1]
        finally:
            net.close()

    def ref():
        net = RT.Network(RN.NativeTCPTransport(1, 2, servers, 0, "127.0.0.1"), 1, 2, 1)
        try:
            got = net.recv(0)
            got_meta = net.recv(0)
            net.send({"c0": jnp.asarray(c0), "c1": jnp.asarray(c1), "nmod": 2,
                      "scale": 2.0 ** 30}, 0)
            net.send(got_meta, 0)
            return got, got_meta
        finally:
            net.close()

    (ct, back, sent, recvd), (got, got_meta) = run_pair(port, ref)
    assert got.dtype == np.dtype("<u4") and np.array_equal(got, res_u32)
    assert got_meta == {"n": 7, "f": 2.5, "s": "x", "l": [1, None, True], "t": (b"b", 3)}
    assert back == got_meta
    assert ct.c0.dtype == torch.int32 and ct.nmod == 2 and ct.scale == 2.0 ** 30
    assert np.array_equal(ct.c0.numpy().view(np.uint32), c0)
    assert np.array_equal(ct.c1.numpy().view(np.uint32), c1)
    assert sent > res_u32.nbytes and recvd > c0.nbytes + c1.nbytes


def test_colliding_channel_ports_raise():
    servers = {0: {"ip": "127.0.0.1", "ports": {1: 40000, 2: 40002}},
               1: {"ip": "127.0.0.1", "ports": {2: 40100}}, 2: {"ip": "127.0.0.1", "ports": {}}}
    with pytest.raises(ValueError, match="collide"):
        PT.make_tcp_transport(0, 3, servers, nchannel=3)


def test_failed_transport_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s message, a file that
    is not a library raises at load, and the protocol's factory raises too:
    it does not fall back to the Python transport."""
    bad = tmp_path / "transport.cpp"
    bad.write_text("this is not C++;\n")
    with pytest.raises(native_ring.NativeBuildError, match="error"):
        PN.build(bad, tmp_path / "libbad.so")
    assert not (tmp_path / "libbad.so").exists()
    junk = tmp_path / "libjunk.so"
    junk.write_bytes(b"not a shared library")
    with pytest.raises(native_ring.NativeBuildError, match="cannot load"):
        PN.load(junk)
    monkeypatch.setattr(PN, "_LIB", None)
    monkeypatch.setattr(PN, "SRC", bad)
    monkeypatch.setattr(native_ring, "BUILD_DIR", tmp_path / "build")
    servers = two_party_servers(free_base())
    with pytest.raises(native_ring.NativeBuildError):
        PT.make_tcp_transport(0, 2, servers, binding_ip="127.0.0.1")
    with socket.socket() as s:  # nothing was left listening on the pair's port
        s.bind(("127.0.0.1", servers[0]["ports"][1]))


@pytest.mark.parametrize("kind", sorted(PORT_KINDS))
def test_closed_peer_raises_at_next_receive(kind):
    """A party that closes its end: the peer's receive raises
    ConnectionError at once, and so does any use of a closed transport."""
    servers = two_party_servers(free_base())
    make = PORT_KINDS[kind]

    def p0():
        t = make(0, servers)
        try:
            t.send_bytes(1, b"last")
            with pytest.raises(ConnectionError):
                t.recv_bytes(1)
        finally:
            t.close()
        with pytest.raises(ConnectionError):
            t.send_bytes(1, b"after close")
        return True

    def p1():
        t = make(1, servers)
        got = t.recv_bytes(0)
        t.close()
        return got

    assert run_pair(p0, p1) == [True, b"last"]


def test_three_party_mesh_over_both_port_transports():
    """Three parties, one on each kind of transport (the port's native and
    Python ones and the reference's native one), aggregate through the hub,
    and the data parties exchange."""
    base = free_base(300)
    servers = {0: {"ip": "127.0.0.1", "ports": {1: base, 2: base + 100}},
               1: {"ip": "127.0.0.1", "ports": {2: base + 200}}, 2: {"ip": "127.0.0.1", "ports": {}}}
    makers = {
        0: lambda: PT.Network(PN.NativeTCPTransport(0, 3, servers, 0, "127.0.0.1"), 0, 3, 1),
        1: lambda: PT.Network(PT.TCPTransport(1, 3, servers, 0, "127.0.0.1"), 1, 3, 1),
        2: lambda: RT.Network(RN.NativeTCPTransport(2, 3, servers, 0, "127.0.0.1"), 2, 3, 1),
    }
    res, errs = [None] * 3, []

    def work(pid):
        try:
            net = makers[pid]()
            try:
                s = net.aggregate(np.full(4, pid + 1, np.int64), lambda a, b: a + b,
                                  include_zero=True)
                x = net.exchange(np.arange(3) * pid, 3 - pid) if pid else None
                res[pid] = (np.asarray(s), x)
            finally:
                net.close()
        except BaseException as e:  # noqa: BLE001 - reported below
            errs.append(e)

    ts = [threading.Thread(target=work, args=(p,), daemon=True) for p in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=JOIN_S)
    assert not errs and not any(t.is_alive() for t in ts), errs
    for pid in range(3):
        assert (res[pid][0] == 6).all()
    assert np.array_equal(res[1][1], np.arange(3) * 2)
    assert np.array_equal(res[2][1], np.arange(3) * 1)


@pytest.mark.parametrize("pid", [0, 1])
@pytest.mark.parametrize("kind", ["native", "python"])
def test_missing_peer_raises_within_the_dial_budget(kind, pid):
    """A peer that never comes up: the listening party stops waiting for it
    after as long as a dialling party tries (retries x delay), and the
    dialling party after its retries; both raise ConnectionError."""
    servers = two_party_servers(free_base())
    t0 = time.time()
    with pytest.raises(ConnectionError, match="did not dial in|cannot reach"):
        if kind == "native":
            PN.NativeTCPTransport(pid, 2, servers, 0, "127.0.0.1", retries=3, retry_delay_ms=100)
        else:
            PT.TCPTransport(pid, 2, servers, 0, "127.0.0.1", retries=3, retry_delay=0.1)
    assert time.time() - t0 < 10
    with socket.socket() as s:  # the listening socket was closed
        s.bind(("127.0.0.1", servers[0]["ports"][1]))


def test_python_transport_blocks_without_a_timeout():
    """Both ends of the port's Python transport block on a receive for as
    long as it takes: the dialling end does not keep the 10 s timeout it
    connects with (the JAX package's TCPTransport keeps it, so a wait over
    10 s there raises TimeoutError)."""
    servers = two_party_servers(free_base())
    socks = run_pair(lambda: PORT_KINDS["port_python"](0, servers),
                     lambda: PORT_KINDS["port_python"](1, servers))
    try:
        assert socks[0].socks[1].gettimeout() is None
        assert socks[1].socks[0].gettimeout() is None
    finally:
        for t in socks:
            t.close()
