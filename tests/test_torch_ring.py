"""Port parity: the host ring arithmetic of sfgwas_tpu_torch/ops/ring.py
against sfgwas_tpu/ops/ring.py on the CPU.

For every ring (the four LElem rings, the small bit field and GF(2)) each
host op of the port is bit-equal to the reference's host path on the same
inputs, made from a seed: once on the port's native engine and once on its
numpy path (a ring built with native=False).  The sampling ops draw the
reference's stream from equal generators and leave the generators at the
same position."""

import numpy as np
import pytest

from sfgwas_tpu.ops import ring as RR
from sfgwas_tpu_torch.ops import ring as PR

LIMB_RINGS = ["LElem256", "LElem128", "LElem2N256", "LElem2N127"]


def _rings(name):
    """(reference ring, port ring on the native engine, port ring on numpy)."""
    ref = getattr(RR, name)
    port = getattr(PR, name)
    return ref, port, PR.ring(ref.modulus, ref.kind, name, native=False)


def _elems(ring, n, seed):
    """n canonical elements with 0 and modulus - 1 in front."""
    a = np.array(ring.rand(np.random.default_rng(seed), (n,)))
    a[0] = ring.from_ints([0])[0]
    a[1] = ring.from_ints([ring.modulus - 1])[0]
    return a


# each op: (reference-or-port ring, the module holding it, inputs) -> result
LIMB_OPS = {
    "add": lambda r, M, x: r.add(x["a"], x["b"]),
    "sub": lambda r, M, x: r.sub(x["a"], x["b"]),
    "neg": lambda r, M, x: r.neg(x["a"]),
    "mul": lambda r, M, x: r.mul(x["a"], x["b"]),
    "mul_broadcast": lambda r, M, x: r.mul(x["a"].reshape(3, 11, -1), x["b"][:11]),
    "mul_const": lambda r, M, x: r.mul_const(x["a"], r.const_np(123456789123456789)),
    "mul_int_small": lambda r, M, x: r.mul_int(x["a"], -37),
    "mul_int_big": lambda r, M, x: r.mul_int(x["a"], -(1 << 70) - 5),
    "matmul": lambda r, M, x: r.matmul(x["a"][:15].reshape(3, 5, -1),
                                       x["b"][:10].reshape(5, 2, -1)),
    "dot_coeffs": lambda r, M, x: r.dot_coeffs(x["a"][:30].reshape(3, 10, -1), x["b"][:10]),
    "sum": lambda r, M, x: r.sum(x["a"].reshape(3, 11, -1), axis=1),
    "reduce_narrow": lambda r, M, x: r.np_reduce(x["wide"][:, :3]),
    "reduce_full": lambda r, M, x: r.np_reduce(x["wide"][:, : r.nlimb]),
    "reduce_wide": lambda r, M, x: r.np_reduce(x["wide"]),
    "from_i32": lambda r, M, x: r.from_i32(x["i32"]),
    "trunc_low": lambda r, M, x: np.stack([r.trunc_low(x["a"], m) for m in (0, 5, 8, 30, 61)]),
    "bits_msb_first": lambda r, M, x: r.bits_msb_first(x["a"], 40),
    "from_to_ints": lambda r, M, x: r.from_ints(list(r.to_ints(x["a"])) + [-5, 1 << 100]),
    "centered_ints": lambda r, M, x: np.asarray(r.centered_ints(x["a"]).astype(str)),
    "from_float": lambda r, M, x: r.from_float(x["f"], 30),
    "to_float": lambda r, M, x: np.stack([r.to_float(x["a"], 30),
                                          r.to_float(r.from_float(x["f"], 30), 30)]),
    "to_float_scalar": lambda r, M, x: np.asarray(r.to_float(r.from_float(-2.5, 30), 30)),
    "consts": lambda r, M, x: np.stack([r.const_np(-1), r.pow2_digits(200), r.ones((2,))[1],
                                       r.zeros((1,))[0]]),
    "aset_aadd": lambda r, M, x: np.stack([M.aset(x["a"][:4], 1, x["b"][0]),
                                          M.aadd(x["a"][:4], [1, 1], x["b"][:2])]),
}


def _limb_inputs(ring, seed):
    rng = np.random.default_rng(seed + 1000)
    return {
        "a": _elems(ring, 33, seed),
        "b": _elems(ring, 33, seed + 1)[::-1].copy(),
        "wide": rng.integers(-(2**40), 2**40, size=(17, 2 * ring.nlimb - 1)),
        "i32": rng.integers(0, 2**31 - 1, size=(4, 5)).astype(np.int32),
        "f": np.concatenate([rng.normal(scale=1e3, size=30), [0.0, -1e-9, 2.0**29]]),
    }


@pytest.mark.parametrize("op", sorted(LIMB_OPS))
@pytest.mark.parametrize("name", LIMB_RINGS)
def test_limb_ring_op_matches_reference(name, op):
    ref, port, plain = _rings(name)
    x = _limb_inputs(ref, 7)
    want = np.asarray(LIMB_OPS[op](ref, RR, x))
    for r in (port, plain):
        got = LIMB_OPS[op](r, PR, {k: v.copy() for k, v in x.items()})
        assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype, (op, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f"{name}.{op} native={r.native}")


@pytest.mark.parametrize("name", ["LElem256", "LElem128"])
def test_prime_ring_inverses_match_reference(name):
    ref, port, plain = _rings(name)
    for r in (port, plain):
        for m in (0, 1, 30, 60):
            np.testing.assert_array_equal(r.inv_pow2_np(m), ref.inv_pow2_np(m))
            np.testing.assert_array_equal(r.inv_pow2_digits(m),
                                          np.asarray(ref.inv_pow2_digits(m)))
        assert r.inv_int(12345) == ref.inv_int(12345)
        assert r.const(77).dtype == np.int32


@pytest.mark.parametrize("name", LIMB_RINGS)
@pytest.mark.parametrize("draw", ["rand", "rand_bits", "rand_scalar"])
def test_limb_ring_draws_match_reference(name, draw):
    """The same generator gives the reference's elements and leaves the
    generator where the reference leaves it."""
    ref, port, plain = _rings(name)
    call = {
        "rand": lambda r, g: r.rand(g, (5, 7)),
        "rand_bits": lambda r, g: r.rand_bits(g, (9,), 61),
        "rand_scalar": lambda r, g: r.rand(g, ()),
    }[draw]
    g_ref = np.random.default_rng(5)
    want = call(ref, g_ref)
    for r in (port, plain):
        g = np.random.default_rng(5)
        got = call(r, g)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert g.bit_generator.state == g_ref.bit_generator.state


SMALL_OPS = {
    "add": lambda F, a, b: F.add(a, b),
    "sub": lambda F, a, b: F.sub(a, b),
    "neg": lambda F, a, b: F.neg(a),
    "mul": lambda F, a, b: F.mul(a, b),
    "zeros": lambda F, a, b: F.zeros((3, 2)),
}


@pytest.mark.parametrize("field,op", [(f, op) for f in ("SElem", "GF2")
                                      for op in sorted(SMALL_OPS) + ["rand"]]
                         + [("SElem", "matmul")])
def test_bit_field_op_matches_reference(field, op):
    ref, port = getattr(RR, field), getattr(PR, field)
    assert port.modulus == ref.modulus
    if op == "rand":
        g1, g2 = np.random.default_rng(3), np.random.default_rng(3)
        want, got = ref.rand(g1, (13, 5)), port.rand(g2, (13, 5))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
        assert g1.bit_generator.state == g2.bit_generator.state
        return
    a = ref.rand(np.random.default_rng(1), (13, 5))
    b = ref.rand(np.random.default_rng(2), (13, 5))
    if op == "matmul":
        want, got = ref.matmul(a, b.T), port.matmul(a, b.T)
    else:
        want, got = SMALL_OPS[op](ref, a, b), SMALL_OPS[op](port, a.copy(), b.copy())
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


def test_ring_singletons_and_companions():
    """The companion rings are singletons per engine choice, as the binary
    protocols compare them by identity; an unregistered ring has none."""
    assert PR.pow2_ring_for(PR.LElem256) is PR.LElem2N256
    assert PR.pow2_ring_for(PR.LElem128) is PR.LElem2N127
    plain = PR.field_for_size(256, native=False)
    assert plain is PR.ring(PR.P256, "prime", native=False) and not plain.native
    assert PR.pow2_ring_for(plain) is PR.ring(1 << 256, "pow2", native=False)
    assert PR.field_for_size(128) is PR.LElem128
    assert plain._nlib is None and PR.LElem256._nlib is not None
    with pytest.raises(ValueError):
        PR.pow2_ring_for(PR.Ring(PR.P256, "prime"))
    with pytest.raises(ValueError):
        PR.field_for_size(64)
    assert PR.LElem256 == plain and hash(PR.LElem256) == hash(plain)
    assert PR.LElem256.nlimb == RR.LElem256.nlimb
    assert PR.LElem2N127.top_mask == RR.LElem2N127.top_mask
