"""Port parity of the SS ring ops that run as one launch of a K8 entry on the
card (sfgwas_tpu_torch/ops/ring.py's tensor branches of add, sub, neg,
small mul_int, sum and from_i32; ops/cuda_ring.py's combine, sum_axis and
from_i32, here their plain versions on CPU tensors) against the JAX
package's jitted device programs on jax arrays (_add_dev, _sub_dev,
_neg_dev, mul_int's reduce of a * v, _sum_dev, from_i32's device branch),
at the four limb rings.  Inputs come from a numpy seed and hold 0,
modulus - 1 and all-255 digits, and broadcast rows; a product of broadcast
or transposed operands equals the product of the operands copied out in
full, and the geometry the kernels read such an operand by points at its
rows."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sfgwas_tpu.ops import ring as RR
from sfgwas_tpu_torch.ops import cuda_ring
from sfgwas_tpu_torch.ops import ring as PR

LIMB_RINGS = ["LElem256", "LElem128", "LElem2N256", "LElem2N127"]


def _rows(ring, n, seed):
    """n digit rows from the seed: 0, modulus - 1 and all 255 first."""
    a = np.array(ring.rand(np.random.default_rng(seed), (n,)))
    a[0] = ring.from_ints([0])[0]
    a[1] = ring.from_ints([ring.modulus - 1])[0]
    a[2] = 255
    return a


def _inputs(ring, seed):
    return {"a": _rows(ring, 12, seed), "b": _rows(ring, 12, seed + 1)[::-1].copy(),
            "row": _rows(ring, 3, seed + 2)[1:2].copy(),
            "i32": np.random.default_rng(seed).integers(-(2**31), 2**31 - 1, size=(3, 4)).astype(
                np.int32)}


# each op: (ring, array constructor, inputs) -> result, run by both packages
FUSED_OPS = {
    "add": lambda r, T, x: r.add(T(x["a"]), T(x["b"])),
    "add_row": lambda r, T, x: r.add(T(x["a"]), T(x["row"])),
    "add_digits_row": lambda r, T, x: r.add(T(x["row"][0]), T(x["a"].reshape(3, 4, -1))),
    "sub": lambda r, T, x: r.sub(T(x["a"]), T(x["b"])),
    "sub_row": lambda r, T, x: r.sub(T(x["row"]), T(x["a"])),
    "neg": lambda r, T, x: r.neg(T(x["a"])),
    "mul_int_m511": lambda r, T, x: r.mul_int(T(x["a"]), -511),
    "mul_int_m3": lambda r, T, x: r.mul_int(T(x["a"]), -3),
    "mul_int_2": lambda r, T, x: r.mul_int(T(x["a"]), 2),
    "mul_int_511": lambda r, T, x: r.mul_int(T(x["a"]), 511),
    "sum_axis0": lambda r, T, x: r.sum(T(x["a"].reshape(3, 4, -1)), axis=0),
    "sum_axis1": lambda r, T, x: r.sum(T(x["a"].reshape(3, 4, -1)), axis=1),
    "from_i32": lambda r, T, x: r.from_i32(T(x["i32"])),
}


@pytest.mark.parametrize("op", sorted(FUSED_OPS))
@pytest.mark.parametrize("name", LIMB_RINGS)
def test_fused_op_matches_reference_device_program(name, op):
    ref, port = getattr(RR, name), getattr(PR, name)
    x = _inputs(port, 29)
    want = np.asarray(FUSED_OPS[op](ref, jnp.asarray, x))
    got = FUSED_OPS[op](port, torch.as_tensor, {k: v.copy() for k, v in x.items()})
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int32, (name, op)
    np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{name}.{op}")


# operand forms: one row against [n, L] (mul_const), [c, 1, L] against
# [c, n, L], [n, L] against [c, n, L], a row expanded with stride 0,
# broadcast axes between the operand's own, a transposed matrix
BROADCASTS = {
    "row": lambda a, b: (a, b[:1]),
    "digits": lambda a, b: (a, b[0]),
    "column": lambda a, b: (a.reshape(3, 4, -1), b[:3].reshape(3, 1, -1)),
    "leading": lambda a, b: (a[:4], b.reshape(3, 4, -1)),
    "expanded": lambda a, b: (a, b[:1].expand(a.shape)),
    "interleaved": lambda a, b: (a[:6].reshape(2, 1, 3, -1), b[:4].reshape(1, 4, 1, -1)),
    "transposed": lambda a, b: (a.reshape(3, 4, -1).transpose(0, 1), b.reshape(4, 3, -1)),
}


@pytest.mark.parametrize("form", sorted(BROADCASTS))
@pytest.mark.parametrize("name", LIMB_RINGS)
def test_mul_of_broadcast_operands_equals_materialised_product(name, form):
    ring = PR.__dict__[name]
    a = torch.as_tensor(_rows(ring, 12, 31))
    b = torch.as_tensor(_rows(ring, 12, 32))
    x, y = BROADCASTS[form](a, b)
    shape = torch.broadcast_shapes(x.shape, y.shape)
    X, Y = x.expand(shape).contiguous(), y.expand(shape).contiguous()
    for u, v, U, V in ((x, y, X, Y), (y, x, Y, X)):
        want = ring.mul(U, V)
        np.testing.assert_array_equal(ring.mul(u, v).numpy(), want.numpy())
        np.testing.assert_array_equal(cuda_ring.mul_plain(ring, u, v).numpy(), want.numpy())
    np.testing.assert_array_equal(ring.sub(x, y).numpy(), ring.sub(X, Y).numpy())


@pytest.mark.parametrize("form", sorted(BROADCASTS))
def test_operand_rows_in_place(form):
    """_operand's geometry: output element e, as an index over the merged
    batch axes' sizes, reads the row at sum_d i_d stride[d] of the operand's
    storage, broadcast and transposed operands alike, with no copy."""
    a = torch.arange(12 * 4, dtype=torch.int32).reshape(12, 4)
    x, y = BROADCASTS[form](a, -a)
    shape = torch.broadcast_shapes(x.shape, y.shape)
    for t in (x, y):
        copies = cuda_ring.OPERAND_COPIES
        v, geom = cuda_ring._operand(t, shape)
        assert cuda_ring.OPERAND_COPIES == copies
        nd = geom[0]
        sizes, strides = list(geom[1 : 1 + nd]), list(geom[1 + nd : 1 + 2 * nd])
        store = torch.as_strided(v, (v.untyped_storage().nbytes() // 4,), (1,), 0)
        full = t.expand(shape).reshape(-1, 4)
        for e in range(full.shape[0]):
            off, r = v.storage_offset(), e
            for d in range(nd - 1, -1, -1):
                off += (r % sizes[d] if d else r) * strides[d]
                r //= sizes[d]
            assert torch.equal(store[off : off + 4], full[e]), (form, e)


def test_operand_with_too_many_axes_is_copied():
    """More than MAX_AXES batch axes left after merging: copied out first."""
    a = torch.arange(2**5 * 4, dtype=torch.int32).reshape(2, 1, 2, 1, 2, 1, 2, 1, 2, 4)
    shape = (2,) * 9 + (4,)
    copies = cuda_ring.OPERAND_COPIES
    v, geom = cuda_ring._operand(a, shape)
    assert cuda_ring.OPERAND_COPIES == copies + 1
    assert v.is_contiguous() and tuple(v.shape) == shape and list(geom[:3]) == [1, 2**9, 4]
