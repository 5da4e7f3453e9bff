"""Port parity: the SS ring's device path (sfgwas_tpu_torch/ops/ring.py on
torch tensors, ops/cuda_ring.py's plain versions of K8-K11 on the CPU)
against sfgwas_tpu/ops/ring.py's jitted device path (jax arrays on the
CPU), and the MPC layer's device mode (ring.host False) against its host
mode.

Every op of the four digit rings runs on the same inputs, made from a seed,
in both packages: the port's result is a tensor bit-equal to the
reference's jax array (matmul at k > 896, the reference's chunk; reduce of
a 2L-1-digit array).  Then the port's sqrt_and_sqrt_inverse and 3 x 3
matrix_inverse_sqrt_svd run three parties in host mode and in device mode
under the same PRG keys: every party's outputs are bit-equal.  In device
mode numpy may not read a tensor implicitly (Tensor.__array__ raises, as
a CUDA tensor's does), so every host copy the protocol makes is explicit.
Last, one small case runs both packages in device mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sfgwas_tpu.ops import ring as RR
from sfgwas_tpu.parallel import simulate as RS
from sfgwas_tpu_torch.mpc import linalg as PL
from sfgwas_tpu_torch.mpc import mpc as PM
from sfgwas_tpu_torch.ops import cuda_ring
from sfgwas_tpu_torch.ops import ring as PR
from sfgwas_tpu_torch.parallel import simulate as PS

LIMB_RINGS = ["LElem256", "LElem128", "LElem2N256", "LElem2N127"]
F = 30


def _elems(ring, n, seed):
    """n canonical elements with 0 and modulus - 1 in front."""
    a = np.array(ring.rand(np.random.default_rng(seed), (n,)))
    a[0] = ring.from_ints([0])[0]
    a[1] = ring.from_ints([ring.modulus - 1])[0]
    return a


# each op: (ring, array constructor, inputs) -> result; the constructor makes
# the package's device array (jnp.asarray, torch.as_tensor) of a numpy array
DEV_OPS = {
    "add": lambda r, T, x: r.add(T(x["a"]), T(x["b"])),
    "add_host_operand": lambda r, T, x: r.add(T(x["a"]), x["b"]),
    "sub": lambda r, T, x: r.sub(T(x["a"]), T(x["b"])),
    "neg": lambda r, T, x: r.neg(T(x["a"])),
    "mul": lambda r, T, x: r.mul(T(x["a"]), T(x["b"])),
    "mul_broadcast": lambda r, T, x: r.mul(T(x["a"].reshape(3, 11, -1)), T(x["b"][:11])),
    "mul_const": lambda r, T, x: r.mul_const(T(x["a"]), T(r.const_np(123456789123456789).copy())),
    "mul_int_small": lambda r, T, x: r.mul_int(T(x["a"]), -37),
    "mul_int_big": lambda r, T, x: r.mul_int(T(x["a"]), -(1 << 70) - 5),
    "matmul": lambda r, T, x: r.matmul(T(x["a"][:15].reshape(3, 5, -1)),
                                       T(x["b"][:10].reshape(5, 2, -1))),
    "matmul_k900": lambda r, T, x: r.matmul(T(x["big"][:1800].reshape(2, 900, -1)),
                                            T(x["big"][1800:].reshape(900, 1, -1))),
    "dot_coeffs": lambda r, T, x: r.dot_coeffs(T(x["a"][:30].reshape(3, 10, -1)), T(x["b"][:10])),
    "sum": lambda r, T, x: r.sum(T(x["a"].reshape(3, 11, -1)), axis=1),
    "reduce_narrow": lambda r, T, x: r.reduce(T(x["wide"][:, :3])),
    "reduce_full": lambda r, T, x: r.reduce(T(x["wide"][:, : r.nlimb])),
    "reduce_wide": lambda r, T, x: r.reduce(T(x["wide"])),
    "from_i32": lambda r, T, x: r.from_i32(T(x["i32"])),
    "trunc_low": lambda r, T, x: [r.trunc_low(T(x["a"]), m) for m in (0, 5, 8, 30, 61)],
    "bits_msb_first": lambda r, T, x: r.bits_msb_first(T(x["a"]), 40),
}


def _inputs(ring, seed):
    rng = np.random.default_rng(seed + 1000)
    return {
        "a": _elems(ring, 33, seed),
        "b": _elems(ring, 33, seed + 1)[::-1].copy(),
        "big": np.array(ring.rand(rng, (2700,))),
        # digits whose exact carries stay inside the reference's int32 scans
        "wide": rng.integers(-(2**22), 2**22, size=(17, 2 * ring.nlimb - 1)).astype(np.int32),
        "i32": rng.integers(0, 2**31 - 1, size=(4, 5)).astype(np.int32),
    }


def _host(x):
    return [_host(v) for v in x] if isinstance(x, list) else np.asarray(x)


@pytest.mark.parametrize("op", sorted(DEV_OPS))
@pytest.mark.parametrize("name", LIMB_RINGS)
def test_device_op_matches_reference_device_path(name, op):
    ref, port = getattr(RR, name), getattr(PR, name)
    x = _inputs(ref, 11)
    want = _host(DEV_OPS[op](ref, jnp.asarray, x))
    got = DEV_OPS[op](port, torch.as_tensor, {k: v.copy() for k, v in x.items()})
    for g, w in zip(got if isinstance(got, list) else [got], want if isinstance(want, list) else [want]):
        assert isinstance(g, torch.Tensor), (name, op, type(g))
        assert g.dtype == torch.int32, (name, op, g.dtype)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{name}.{op}")


@pytest.mark.parametrize("name", LIMB_RINGS)
def test_device_constants_and_indexed_updates(name):
    ref, port = getattr(RR, name), getattr(PR, name)
    cpu = torch.device("cpu")
    for v in (0, -1, 77, 1 << 200):
        c = port.const(v, cpu)
        assert isinstance(c, torch.Tensor) and c.dtype == torch.int32
        np.testing.assert_array_equal(c.numpy(), np.asarray(ref.const(v)))
    np.testing.assert_array_equal(port.pow2_digits(200, cpu).numpy(),
                                  np.asarray(ref.pow2_digits(200)))
    if port.kind == "prime":
        np.testing.assert_array_equal(port.inv_pow2_digits(30, cpu).numpy(),
                                      np.asarray(ref.inv_pow2_digits(30)))
    a, b = _elems(ref, 6, 3), _elems(ref, 6, 4)
    d = np.arange(2)
    for idx, val in ((1, b[0]), ((d, d), b[:2]), ((slice(1, None), 0), b[:1])):
        A = a.reshape(2, 3, -1) if isinstance(idx, tuple) else a
        want = np.asarray(RR.aset(jnp.asarray(A), idx, jnp.asarray(val)))
        got = PR.aset(torch.as_tensor(A), idx, torch.as_tensor(val))
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(RR.aadd(jnp.asarray(a), jnp.asarray([1, 1, 4]), jnp.asarray(b[:3])))
    got = PR.aadd(torch.as_tensor(a), [1, 1, 4], torch.as_tensor(b[:3]))
    np.testing.assert_array_equal(got.numpy(), want)


def test_reduce_rejects_a_too_wide_array():
    """reduce takes at most 2L - 1 digits, as the reference's does (its
    "reduce in chunks" assert): a wider array raises."""
    ring = PR.LElem256
    x = torch.zeros((2, 2 * ring.nlimb), dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_ring.reduce_plain(ring, torch.cat([x, x], dim=1))


# a second device for the operands: "meta" tensors have shapes and no data
TWO_DEVICE_OPS = {
    "add": lambda r, a, b: r.add(a, b),
    "sub": lambda r, a, b: r.sub(a, b),
    "mul": lambda r, a, b: r.mul(a, b),
    "mul_const": lambda r, a, b: r.mul_const(a, b[0]),
    "matmul": lambda r, a, b: r.matmul(a.reshape(2, 3, -1), b.reshape(3, 2, -1)),
    "dot_coeffs": lambda r, a, b: r.dot_coeffs(a.reshape(1, 6, -1), b),
    "aset": lambda r, a, b: PR.aset(a, 1, b[0]),
    "aadd": lambda r, a, b: PR.aadd(a, [1, 2], b[:2]),
    "cat": lambda r, a, b: PM._cat([a, b]),
}


@pytest.mark.parametrize("op", sorted(TWO_DEVICE_OPS))
def test_operands_on_two_devices_raise(op):
    """An op given tensors on two devices raises: it never copies a share
    from one device to another (a CUDA share to the host) on its own."""
    ring = PR.LElem256
    a = torch.as_tensor(_elems(ring, 6, 1))
    b = torch.zeros(a.shape, dtype=torch.int32, device="meta")
    for x, y in ((a, b), (b, a)):
        with pytest.raises(ValueError, match="different devices"):
            TWO_DEVICE_OPS[op](ring, x, y)


@pytest.mark.parametrize("op", ["aset", "aadd"])
def test_indexed_update_of_a_host_array_by_a_tensor(op):
    """A host array updated by a tensor comes back a tensor on that
    tensor's device, as the reference's device arrays do under .at[]: a
    share written into a host accumulator stays on its device."""
    ring = PR.LElem256
    acc = ring.zeros((3,))  # a broadcast host view, as the protocol makes
    val = _elems(ring, 2, 5)
    fn = getattr(PR, op)
    got = fn(acc, [0, 2], torch.as_tensor(val))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), fn(acc, [0, 2], val))


@pytest.mark.parametrize("host,share,where", [
    (True, "tensor", "numpy"), (False, "numpy", "numpy"), (False, "tensor", "meta")])
def test_masks_staged_on_the_share_device(monkeypatch, host, share, where):
    """A Beaver mask is drawn on the host and staged on the device of the
    share it masks in device mode (host False) alone."""
    ring = PR.LElem256
    monkeypatch.setattr(ring, "host", host)
    mask = _elems(ring, 4, 2)
    sh = torch.zeros(mask.shape, dtype=torch.int32, device="meta") if share == "tensor" else mask
    got = PM._staged(ring, mask, sh)
    if where == "numpy":
        assert got is mask
    else:
        assert isinstance(got, torch.Tensor) and got.device.type == where
        assert got.dtype == torch.int32 and tuple(got.shape) == mask.shape


# ------------------------------------------------------------ device mode


@pytest.fixture
def strict_tensors(monkeypatch):
    """numpy may not read a tensor implicitly, as it may not a CUDA one."""

    def no_implicit(self, *a, **k):
        raise TypeError("implicit host copy of a tensor")

    monkeypatch.setattr(torch.Tensor, "__array__", no_implicit)


def _device_mode(monkeypatch, ring):
    monkeypatch.setattr(ring, "host", False, raising=False)


def _run(case, vals, to_dev):
    """case(mpc, shares) at three parties of the port, the local PRGs
    seeded alike; shares are given as tensors when to_dev."""

    def party(mpc):
        mpc.rand.table[mpc.pid] = np.random.Generator(np.random.Philox(key=[5, mpc.pid]))
        sh = PS.make_shares(mpc, vals)
        return case(mpc, torch.as_tensor(sh) if to_dev else sh)

    return PS.run_parties(3, party)


def _host_all(x):
    if isinstance(x, (list, tuple)):
        return [_host_all(v) for v in x]
    return PR.to_host(x)


def _assert_same(got, want, where):
    if isinstance(want, list):
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
        return
    assert got.shape == want.shape, (where, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=where)


def _host_vs_device(monkeypatch, case, vals):
    host = [_host_all(r) for r in _run(case, vals, False)]
    with monkeypatch.context() as m:
        _device_mode(m, PR.LElem256)
        dev = _run(case, vals, True)
    # in device mode the data parties' results are tensors
    assert any(isinstance(v, torch.Tensor) for v in dev[1]), [type(v) for v in dev[1]]
    for pid in range(3):
        _assert_same(_host_all(dev[pid]), host[pid], f"pid{pid}")
    return host


def _decode(ints):
    q = PR.P256
    return np.array([(int(v) - q if int(v) > q // 2 else int(v)) / (1 << F) for v in ints])


def test_sqrt_device_mode_equals_host_mode(monkeypatch, strict_tensors):
    x = np.array([0.01, 0.5, 1.0, 3.9, 250.0, 7.25])
    vals = [int(round(v * (1 << F))) for v in x]

    def case(mpc, sh):
        s, si = mpc.sqrt_and_sqrt_inverse(sh)  # the boolean-share normaliser
        f, fi = mpc.sqrt_and_sqrt_inverse(sh[:2], False)  # the field one
        return [s, si, f, fi, PS.reveal_ints(mpc, si), PS.reveal_ints(mpc, fi)]

    host = _host_vs_device(monkeypatch, case, vals)
    np.testing.assert_allclose(_decode(host[1][4]), 1 / np.sqrt(x), rtol=1e-4)
    np.testing.assert_allclose(_decode(host[1][5]), 1 / np.sqrt(x[:2]), rtol=1e-4)


def test_matrix_inverse_sqrt_device_mode_equals_host_mode(monkeypatch, strict_tensors):
    A = np.array([[2.0, 0.3, -0.1], [0.1, 1.5, 0.2], [0.0, 0.4, 3.0]])
    vals = [int(round(v * (1 << F))) for v in A.reshape(-1)]

    def case(mpc, sh):
        B = PL.matrix_inverse_sqrt_svd(mpc, sh.reshape((3, 3) + tuple(sh.shape[1:])))
        return [B, PS.reveal_ints(mpc, B.reshape((9,) + tuple(B.shape[2:])))]

    host = _host_vs_device(monkeypatch, case, vals)
    Bf = _decode(host[1][1]).reshape(3, 3)
    np.testing.assert_allclose(Bf.T @ Bf, np.linalg.inv(A + A.T), atol=1e-5)


def test_port_device_mode_matches_reference_device_mode(monkeypatch):
    """ss_mult_elem and sqrt_and_sqrt_inverse in both packages' device mode
    (jax arrays, torch tensors), the local PRGs seeded alike."""
    vals = [int(round(v * (1 << F))) for v in (0.25, 2.0, 9.5)]

    def case(T):
        def fn(mpc):
            mpc.rand.table[mpc.pid] = np.random.Generator(np.random.Philox(key=[9, mpc.pid]))
            sh = T(np.asarray((PS if T is torch.as_tensor else RS).make_shares(mpc, vals)))
            prod = mpc.ss_mult_elem(sh, sh)
            s, si = mpc.sqrt_and_sqrt_inverse(sh)
            return [np.asarray(PR.to_host(v)) for v in (prod, s, si)]

        return fn

    monkeypatch.setattr(RR.LElem256, "host", False)
    ref = RS.run_parties(3, case(jnp.asarray))
    with monkeypatch.context() as m:
        _device_mode(m, PR.LElem256)
        port = PS.run_parties(3, case(torch.as_tensor))
    for pid in range(3):
        _assert_same(port[pid], ref[pid], f"pid{pid}")
