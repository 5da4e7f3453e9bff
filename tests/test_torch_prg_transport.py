"""Port parity: the PRG table, the wire codec and the local network of
sfgwas_tpu_torch against sfgwas_tpu, and the thread safety of the kernel
registry that the party threads share."""

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfgwas_tpu.crypto import ckks as RC
from sfgwas_tpu.mpc import mhe as RM
from sfgwas_tpu.mpc import prg as RP
from sfgwas_tpu.parallel import transport as RT
from sfgwas_tpu_torch.crypto import ckks as PC
from sfgwas_tpu_torch.crypto.params import get_params
from sfgwas_tpu_torch.mpc import mhe as PM
from sfgwas_tpu_torch.mpc import prg as PP
from sfgwas_tpu_torch.ops import cuda_build, rns
from sfgwas_tpu_torch.parallel import transport as PT
from sfgwas_tpu_torch.parallel.simulate import run_network_parties


def _draws(rand, pid, nparty):
    """Bytes and ints from every shared stream: global, each pair, their
    forks."""
    out = []
    for other in [-1] + [p for p in range(nparty) if p != pid]:
        with rand.using(other) as g:
            out.append(g.bytes(24))
            out.append(int(g.integers(0, 1 << 40)))
        rand.switch(other)
        out.append(rand.rand_int(1000003))
        out.append(rand.rand_bytes(17))
        rand.restore()
    child = rand.fork(5)
    for other in [-1] + [p for p in range(nparty) if p != pid]:
        with child.using(other) as g:
            out.append(g.bytes(16))
    return out


@pytest.mark.parametrize("nparty", [2, 3, 4])
def test_random_streams_match_reference(nparty):
    for pid in range(nparty):
        ref, port = RP.Random(pid, nparty), PP.Random(pid, nparty)
        assert _draws(port, pid, nparty) == _draws(ref, pid, nparty)
        assert port._cur == ref._cur == pid


def _message(arr, res=None):
    """A nested message whose arrays are built by `arr` from numpy, and its
    uint32 residue array by `res` (default `arr`)."""
    rng = np.random.default_rng(3)
    return {
        "c0": (res or arr)(rng.integers(0, 1 << 26, size=(3, 16)).astype(np.uint32)),
        # a host array in both: an int32 tensor of the port is a residue array
        "i32": rng.integers(-100, 100, size=(2, 2, 2)).astype(np.int32),
        "f32": arr(rng.normal(size=5).astype(np.float32)),
        "f64": rng.normal(size=(4,)),  # a host array in both (jax has no float64 here)
        "nmod": 7, "scale": 1.25e15, "ok": True, "none": None, "name": "ct", "raw": b"\x00\x01",
        "list": [1, -2, arr(np.arange(3, dtype=np.float32)), (4, "x", [np.int64(9)])],
        7: np.arange(4, dtype=np.uint8),
    }


def test_codec_writes_the_reference_bytes():
    """torch tensors where the reference has jax arrays: the same frame."""
    want = RT.encode(_message(jnp.asarray))
    assert PT.encode(_message(torch.from_numpy, rns.as_i32)) == want  # residues as int32
    assert PT.encode(_message(torch.from_numpy)) == want  # and as uint32
    assert PT.encode(_message(lambda a: a)) == want


def test_decode_round_trips():
    msg = _message(torch.from_numpy, rns.as_i32)
    got = PT.decode(PT.encode(msg))
    assert set(got) == set(msg)
    for k in ("c0", "i32", "f32", "f64"):
        want = rns.to_u32(msg[k]) if k == "c0" else np.asarray(msg[k])
        assert isinstance(got[k], np.ndarray) and np.array_equal(got[k], want)
        assert got[k].dtype == want.dtype
    assert got["list"][3] == (4, "x", [9]) and isinstance(got["list"][3], tuple)
    assert (got["nmod"], got["scale"], got["ok"], got["none"], got["raw"]) == (
        7, 1.25e15, True, None, b"\x00\x01")
    assert np.array_equal(got[7], np.arange(4, dtype=np.uint8))
    # and the reference decodes the port's frame
    ref = RT.decode(PT.encode(msg))["c0"]
    assert ref.dtype == np.uint32 and np.array_equal(ref, rns.to_u32(msg["c0"]))


def test_ciphertext_frame_is_the_references():
    """A TEST8 ciphertext: the port's frame of ct_to_wire is the reference's
    byte for byte (residues as <u4), and each side decodes the other's
    frame to the same residues."""
    ctx = PC.CkksContext(get_params("TEST8"), device="cpu")
    rng = np.random.default_rng(11)
    sk = ctx.gen_secret_key(rng)
    ct = ctx.encrypt(ctx.encode(rng.normal(size=ctx.params.slots), ctx.nq),
                     ctx.gen_public_key(sk, rng), rng)
    rct = RC.Ciphertext(jnp.asarray(rns.to_u32(ct.c0)), jnp.asarray(rns.to_u32(ct.c1)), ct.nmod,
                        ct.scale)
    frame, ref_frame = PT.encode(PM.ct_to_wire(ct)), RT.encode(RM.ct_to_wire(rct))
    assert frame == ref_frame
    back = PM.ct_from_wire(PT.decode(ref_frame))
    assert torch.equal(back.c0, ct.c0) and torch.equal(back.c1, ct.c1)
    assert (back.nmod, back.scale) == (ct.nmod, ct.scale)
    rback = RM.ct_from_wire(RT.decode(frame))
    for a, b in ((rback.c0, rct.c0), (rback.c1, rct.c1)):
        assert a.dtype == jnp.uint32 and np.array_equal(np.asarray(a), np.asarray(b))
    assert (rback.nmod, rback.scale) == (ct.nmod, ct.scale)


def test_network_collectives_across_threads():
    """aggregate, hub_broadcast, exchange and the int messages over the
    local mesh; tensors pass by reference, numpy arrays frozen."""

    def fn(net):
        pid = net.pid
        t = torch.full((4,), pid, dtype=torch.int64)
        agg = net.aggregate(t, lambda a, b: a + b)
        agg0 = net.aggregate(np.array([pid, 1]), lambda a, b: a + b, include_zero=True)
        hub = net.hub_broadcast(torch.arange(3) if pid == net.hub_pid else None)
        swapped = [net.exchange((pid, f"from {pid}"), o) for o in range(net.nparty) if o != pid]
        if pid == 2:
            net.send_int(41, 0)
        got_int = net.recv_int(2) if pid == 0 else None
        return agg, agg0, hub, swapped, got_int, dict(net.sent_msgs)

    res = run_network_parties(3, fn, timeout=120)
    assert torch.equal(res[0][0], torch.zeros(4, dtype=torch.int64))  # the dealer keeps its own
    for pid in (1, 2):
        assert torch.equal(res[pid][0], torch.full((4,), 3, dtype=torch.int64))
        assert torch.equal(res[pid][2], torch.arange(3))
    assert res[1][0] is res[2][0]  # zero-copy: one tensor
    for pid in range(3):
        assert np.array_equal(res[pid][1], [3, 3])
        assert not res[pid][1].flags.writeable  # the shared sum is frozen
        others = [o for o in range(3) if o != pid]
        assert res[pid][3] == [(o, f"from {o}") for o in others]
    assert res[0][2] is None and res[0][4] == 41
    assert res[2][5][0] == 2  # the exchange and the int


def test_run_network_parties_reraises_a_party_failure():
    def fn(net):
        if net.pid == 2:
            raise ValueError("party 2 fails")
        return net.pid

    with pytest.raises(ValueError, match="party 2 fails"):
        run_network_parties(3, fn, timeout=60)


def test_kernel_binding_and_counts_are_thread_safe(monkeypatch):
    """Many threads launch one kernel for the first time at once: it is
    loaded and bound once and every launch is counted."""
    loads = []

    class Lib:
        def __init__(self):
            self.k = lambda *a: 0
            self.csrc_error_string = lambda e: b""

    def fake_load(name):
        with cuda_build._lock:
            loads.append(name)
            return Lib()

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(cuda_build, "load", fake_load)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    kernel = cuda_build.CudaKernel("fake", "k", [])
    del cuda_build.REGISTRY["k"]  # not one of the port's kernels
    nthreads, per = 16, 300
    start = threading.Barrier(nthreads)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            start.wait(timeout=60)
            for _ in range(per):
                kernel.launch(torch.device("cpu"))

        threads = [threading.Thread(target=work) for _ in range(nthreads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert loads == ["fake"]
    assert kernel.launches == nthreads * per
