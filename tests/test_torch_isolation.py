"""The port stands alone: no jax and no sfgwas_tpu at import time or in its
sources, no quiet CPU fallback, and kernel wrappers that take their plain
versions only for CPU tensors."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sfgwas_tpu_torch
from sfgwas_tpu_torch.crypto import ckks as PC
from sfgwas_tpu_torch.crypto.params import get_params
from sfgwas_tpu_torch.gwas import matmult as PMM
from sfgwas_tpu_torch.mpc import mhe as PM
from sfgwas_tpu_torch.ops import cuda_build, cuda_ntt, cuda_ring
from sfgwas_tpu_torch.ops import ring as PR
from sfgwas_tpu_torch.ops import rns

PKG = Path(sfgwas_tpu_torch.__file__).parent
MODULES = sorted(
    "sfgwas_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
    for p in PKG.rglob("*.py")
    if p.name != "__init__.py"
)


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in MODULES)
        + "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'sfgwas_tpu' or m.startswith('sfgwas_tpu.'))\n"
        "print(','.join(bad))\n"
    )
    root = str(PKG.parent)
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=root,
        env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout
    assert len(MODULES) >= 12
    for m in ("mpc.prg", "parallel.transport", "parallel.simulate", "mpc.mhe", "ops.threefry",
              "ops.ring", "ops.native_ring", "mpc.mpc", "mpc.boolean", "mpc.linalg",
              "mpc.ss_he", "utils.ddfloat", "crypto.basics", "gwas.qrfact", "gwas.assoc",
              "gwas.params", "gwas.filestream", "gwas.utilities", "gwas.qc", "gwas.pgen",
              "gwas.matmult", "gwas.protocol", "cli", "utils.config", "utils.watchdog",
              "parallel.native_transport", "ops.cuda_ring"):
        assert "sfgwas_tpu_torch." + m in MODULES


def test_sources_name_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax\b|sfgwas_tpu(?!_torch))", re.M)
    for p in PKG.rglob("*.py"):
        assert not pat.search(p.read_text()), p
    smoke = PKG.parent / "chip_smoke.py"
    assert not pat.search(smoke.read_text())


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PC.CkksContext(get_params("TEST8"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PC.CkksContext(get_params("TEST8"), device="cuda")
    assert PC.CkksContext(get_params("TEST8"), device="cpu").device.type == "cpu"


def test_tcp_party_needs_a_card_unless_told(tmp_path, monkeypatch):
    """The CLI's one-process-a-party path, like --local-sim, runs on the
    card: with no card and no --platform it raises before the party opens
    its mesh."""
    from sfgwas_tpu_torch import cli
    from sfgwas_tpu_torch.parallel import transport as PT

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def mesh(*a, **k):
        raise AssertionError("the mesh was opened")

    monkeypatch.setattr(PT, "make_tcp_transport", mesh)
    cfg = tmp_path / "g.toml"
    cfg.write_text('num_inds = [0, 4, 4]\nnum_snps = 10\n')
    monkeypatch.setenv("PID", "2")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--config-global", str(cfg)])


def test_protocol_layers_pick_no_device(monkeypatch):
    """The ciphertext-matrix suite and the covariate basis run on their key
    bundle's context: they name no device of their own (so no CPU path can
    stand in for the card), and a bundle built with the default device
    needs a card."""
    for m in ("crypto/basics.py", "gwas/qrfact.py", "gwas/assoc.py", "gwas/qc.py",
              "gwas/utilities.py"):
        src = (PKG / m).read_text()
        assert not re.search(r"""["']cpu["']|torch\.device\(|\.cpu\(\)""", src), m
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from sfgwas_tpu_torch import interop

    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.crypto_params(PC.CkksContext(get_params("TEST8")), np.zeros(1), (0, 0), {})


def test_wrappers_take_plain_path_on_cpu():
    basis = get_params("TEST8").basis
    rng = np.random.default_rng(2)
    rows = (0, 1)
    x = rns.as_i32(
        np.stack([rng.integers(0, basis.primes[r], size=(3, basis.n)) for r in rows])
        .astype(np.uint32)
    )
    before = {k: v.launches for k, v in cuda_build.REGISTRY.items()}
    y = cuda_ntt.ntt_b_kernel(x, basis, rows)
    assert torch.equal(y, rns._ntt_b_butterfly(x, basis, rows))
    assert torch.equal(cuda_ntt.ntt_b_kernel(y, basis, rows, True), x)

    q = rns._sel(basis, rows, "cpu")["q"]
    mu = rns.barrett_mu64(basis, rows, "cpu")
    ext = x.permute(1, 0, 2).reshape(1, 3, 1, 2, basis.n)  # [G, S, J, X, N]
    key = ext[:, :2].contiguous()  # [G, Bk=2, J, X, N]
    o0, o1 = PC.ks_digit_product(ext, key, key, q, mu, basis.logn)
    p0, p1 = PC.ks_digit_product_plain(ext, key, key, q)
    assert torch.equal(o0, p0) and torch.equal(o1, p1)

    acc = torch.zeros((2, 1, 2, basis.n), dtype=torch.int32)
    R = x[:, 0][None, None]  # [1, 1, 2, N]: one baby
    runs = PMM.MacRuns.from_host([0], [0], [0, 1], [1], "cpu")
    args = (R, R, x.transpose(0, 1).contiguous(), runs, q)
    a0, a1 = PMM.mac_dense(acc.clone(), acc.clone(), *args, mu=mu, logn=basis.logn)
    b0, b1 = PMM.mac_dense_plain(acc.clone(), acc.clone(), *args)
    assert torch.equal(a0, b0) and torch.equal(a1, b1)
    assert a0[1].any() and not a0[0].any()

    # K4, K5 and K6 on CPU tensors
    seed = (7, 8)
    assert torch.equal(PC.uniform_mod(q, mu, seed, 3, 2, basis.logn),
                       PC.uniform_mod_plain(q, seed, 3, 2, basis.n))
    pw = torch.ones((2, 3), dtype=torch.int32)
    tab = {"pw": pw, "ps": pw, "q": q, "mu": mu, "lazy": True}  # as _bs_tables holds them
    m = PM.bs_mask(tab, tab, seed, 0, 2, 3, 5, basis.logn)
    p = PM.bs_mask_plain(pw, pw, q, q, seed, 0, 2, 3, 5, basis.n)
    assert torch.equal(m[0], p[0]) and torch.equal(m[1], p[1])
    rws = torch.tensor(rows, dtype=torch.int32)
    xb = x.transpose(0, 1).contiguous()  # [B, L, N]
    args = (xb, xb, x[:, 0], rws, rws, x, x, x, x, q, q)
    c = PM.bs_combine(*args, mu, mu, basis.logn)
    p = PM.bs_combine_plain(*args)
    assert torch.equal(c[0], p[0]) and torch.equal(c[1], p[1])
    t = rns._crt_tables(basis, rows, (0, 1, 2), "cpu")
    assert torch.equal(rns.crt_lift(x[:, 0], t), rns.crt_lift_plain(x[:, 0], t))
    # K8 and its entries, K9-K11 on CPU tensors
    ring = PR.LElem256
    a = torch.as_tensor(np.array(ring.rand(rng, (4, 3))))
    assert torch.equal(cuda_ring.reduce(ring, a[0] * 7), cuda_ring.reduce_plain(ring, a[0] * 7))
    assert torch.equal(cuda_ring.mul(ring, a[0], a[1]), cuda_ring.mul_plain(ring, a[0], a[1]))
    assert torch.equal(cuda_ring.matmul(ring, a[:2], a[1:]), cuda_ring.matmul_plain(ring, a[:2], a[1:]))
    assert torch.equal(cuda_ring.dot(ring, a, a[0]), cuda_ring.dot_plain(ring, a, a[0]))
    assert torch.equal(cuda_ring.combine(ring, a[0], a[1], 1, -1),
                       cuda_ring.combine_plain(ring, a[0], a[1], 1, -1))
    assert torch.equal(cuda_ring.sum_axis(ring, a, 0), cuda_ring.sum_plain(ring, a, 0))
    v = torch.arange(-3, 3, dtype=torch.int32)
    assert torch.equal(cuda_ring.from_i32(ring, v), cuda_ring.from_i32_plain(ring, v))
    assert {k: v.launches for k, v in cuda_build.REGISTRY.items()} == before
    assert set(cuda_build.REGISTRY) == {"ntt_fwd", "ntt_inv", "ks_digit_product", "mac_dense",
                                        "uniform_mod", "bs_mask", "bs_mask_generic",
                                        "bs_combine", "crt_lift",
                                        "ring_reduce", "ring_combine", "ring_sum",
                                        "ring_from_i32", "ring_mul", "ring_matmul", "ring_dot"}
