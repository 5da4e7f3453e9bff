"""GWAS file utilities: collective decrypt-and-save, cache IO (counterpart
of sfgwas_tpu/gwas/utilities.py; the Go sfgwas's gwas/utilities.go and
mpc/mhe.go:554-606).

The ciphertext cache is an .npz of residue arrays in the reference's
layout: the port's int32 residue tensors are written as uint32 arrays with
the same bits, as the reference writes them, so a cache file written by
either package loads in the other."""

from __future__ import annotations

import numpy as np

from ..crypto import basics as B
from ..crypto import ckks as C
from ..mpc import mhe
from ..ops import rns


def save_matrix_collective(
    net, cps, cm: B.CipherMatrix, n_cols: int, source_pid: int, filename: str
):
    """Collectively decrypt a CipherMatrix and save it as CSV rows at the
    source (at every data party for source_pid < 0)."""
    if net.pid == 0:
        return None
    # dims can differ per party (row-partitioned matrices): the source
    # announces its shape
    if source_pid > 0:
        if net.pid == source_pid:
            for p in range(1, net.nparty):
                if p != net.pid:
                    net.send((len(cm), len(cm[0])), p)
            nr, nc = len(cm), len(cm[0])
        else:
            nr, nc = net.recv(source_pid)
            cm = [[None] * nc for _ in range(nr)]
    rows = []
    for cv in cm:
        pts = mhe.collective_decrypt_many(net, cps, cv, source_pid)
        rows.append(np.concatenate([cps.ctx.decode(pt) for pt in pts])[:n_cols])
    M = np.stack(rows)
    if source_pid < 0 or net.pid == source_pid:
        np.savetxt(filename, M, delimiter=",", fmt="%.6e")
    return M


def load_matrix_float(filename: str) -> np.ndarray:
    return np.loadtxt(filename, delimiter=",", ndmin=2)


def save_cipher_matrix(cps, cm: B.CipherMatrix, filename: str, extra=None):
    """Ciphertext cache: per ciphertext its c0 and c1 as uint32 residues and
    (nmod, scale); `extra` adds plaintext side arrays (the dosage sums
    stored beside a block's products)."""
    data = {"rows": len(cm), "cols": len(cm[0])}
    for i, cv in enumerate(cm):
        for j, ct in enumerate(cv):
            data[f"c0_{i}_{j}"] = rns.to_u32(ct.c0)
            data[f"c1_{i}_{j}"] = rns.to_u32(ct.c1)
            data[f"m_{i}_{j}"] = np.array([ct.nmod, ct.scale])
    if extra:
        data.update({k: np.asarray(v) for k, v in extra.items()})
    np.savez_compressed(filename, **data)


def load_cipher_matrix(cps, filename: str) -> B.CipherMatrix:
    """A ciphertext cache of either package -> int32 residue tensors on the
    bundle's device."""
    ctx = cps.ctx
    with np.load(filename) as z:
        return [
            [
                C.Ciphertext(
                    ctx.to_dev(z[f"c0_{i}_{j}"]), ctx.to_dev(z[f"c1_{i}_{j}"]),
                    int(z[f"m_{i}_{j}"][0]), float(z[f"m_{i}_{j}"][1]),
                )
                for j in range(int(z["cols"]))
            ]
            for i in range(int(z["rows"]))
        ]


def write_filter(filename: str, filt: np.ndarray):
    np.savetxt(filename, np.asarray(filt).astype(int), fmt="%d")


def read_filter(filename: str, n: int) -> np.ndarray:
    out = np.loadtxt(filename).astype(bool)
    if len(out) != n:
        raise ValueError(f"{filename}: {len(out)} filter entries, expected {n}")
    return out
