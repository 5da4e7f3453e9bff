"""The benchmark's inputs, made from the run's seed, and the helpers that lay
them out for the program.  Plain numpy and the standard library: nothing here
imports the program.

Frozen copies (the benchmark keeps its own, so a later change to the origin
does not move the yardstick):
- assoc_data: chip_smoke.py::_assoc_data
- count_file: chip_smoke.py::_count_file
- free_port_bases: chip_smoke.py::free_ports, widened to runs of
  consecutive ports (a pair's striped channels take base + k)
- tcp_servers: the [servers.partyN] map that chip_smoke.py::tcp_configs
  writes, as the port's config loader hands it to the transport
"""

from __future__ import annotations

import os
import socket

import numpy as np

# the five covariates' column scales (chip_smoke.py phase 8)
COV_SCALES = (1.0, 20.0, 0.1, 50.0, 0.3)


def seed_words(seed: int) -> list:
    """A seed of any size (seeds may exceed 32 bits) as the word list
    numpy's SeedSequence takes; negative seeds are folded in as well."""
    seed = int(seed)
    words = [1 if seed < 0 else 0]
    seed = abs(seed)
    while True:
        words.append(seed & 0xFFFFFFFF)
        seed >>= 32
        if not seed:
            return words


def rng(seed: int, stream: int) -> np.random.Generator:
    """The run's generator for one purpose (`stream`), from the seed."""
    return np.random.default_rng(seed_words(seed) + [stream])


def assoc_data(seed: int, num_inds, m_block: int, nblocks: int, ncov: int = 5):
    """Per data party (1, 2, ...; num_inds[pid] individuals each): genotypes
    [n, nblocks * m_block] in {0, 1, 2} with about 1% missing (-1), each
    SNP's minor allele frequency uniform in [0.02, 0.5]; ncov covariates at
    COV_SCALES; a phenotype with 5 planted effects on the dosages (missing
    read as 0)."""
    r = rng(seed, 4)
    m = nblocks * m_block
    maf = r.uniform(0.02, 0.5, size=m)
    planted = r.choice(m, 5, replace=False)
    out = {}
    for pid in range(1, len(num_inds)):
        n_loc = num_inds[pid]
        g = r.binomial(2, maf[None, :], size=(n_loc, m)).astype(np.int8)
        g[r.uniform(size=(n_loc, m)) < 0.01] = -1
        cov = r.normal(size=(n_loc, ncov)) * np.array(COV_SCALES)[:ncov]
        pheno = r.normal(size=n_loc) + 0.3 * np.maximum(g[:, planted], 0).sum(1)
        out[pid] = (g, pheno, cov)
    return out


def pc_scores(seed: int, num_inds, npc: int) -> dict:
    """Per data party, its rows of npc principal-component scores as the PCA
    phase hands them to the association: columns orthonormal over the
    pooled individuals ({pid: [num_inds[pid], npc]})."""
    q, _ = np.linalg.qr(rng(seed, 5).normal(size=(sum(num_inds), npc)))
    bounds = np.cumsum(num_inds)
    return {pid: q[bounds[pid - 1] : bounds[pid]] for pid in range(1, len(num_inds))}


def count_file(g: np.ndarray, path: str):
    """plink2's --geno-counts layout as the port reads it
    (read_geno_stats_file): 6 x m little-endian uint32 rows of hom-ref, het
    and hom-alt counts, two rows the reader derives itself (zeros here),
    and the missing count."""
    raw = np.zeros((6, g.shape[1]), "<u4")
    for k in range(3):
        raw[k] = (g == k).sum(0)
    raw[5] = (g < 0).sum(0)
    raw.tofile(path)


def write_assoc_inputs(d: str, data, pcs, m_block: int, nblocks: int) -> None:
    """Each data party's genotype blocks (int8, row-major [n_loc, m_block]),
    count file, phenotype, covariates and PC scores under directory d."""
    for pid, (g, pheno, cov) in data.items():
        for b in range(nblocks):
            np.ascontiguousarray(g[:, b * m_block : (b + 1) * m_block]).tofile(
                geno_path(d, pid, b))
        count_file(g, os.path.join(d, f"p{pid}_gcount.bin"))
        np.save(os.path.join(d, f"p{pid}_pheno.npy"), pheno)
        np.save(os.path.join(d, f"p{pid}_cov.npy"), cov)
        np.save(os.path.join(d, f"p{pid}_pcs.npy"), pcs[pid])


def geno_path(d: str, pid: int, block: int) -> str:
    return os.path.join(d, f"p{pid}_geno.{block}.bin")


def variances(seed: int, n: int, n_ind: int) -> np.ndarray:
    """n - 1 SNP variances and the phenotype's last, in the range the
    example's dosages give: a SNP's residual sum of squares over n_ind
    individuals is about n_ind * 2p(1 - p) with p uniform in [0.02, 0.5];
    the phenotype's about n_ind times its variance, 1 to 1.5."""
    r = rng(seed, 2)
    p = r.uniform(0.02, 0.5, size=n - 1)
    x = n_ind * 2 * p * (1 - p) * r.uniform(0.9, 1.1, size=n - 1)
    y = n_ind * r.uniform(1.0, 1.5)
    return np.concatenate([x, [y]])


def free_port_bases(n: int, width: int = 1) -> list:
    """n ports free on 127.0.0.1 right now, each the first of `width`
    consecutive free ports, no two runs within `width` of each other."""
    socks, bases = [], []
    try:
        while len(bases) < n:
            s = socket.socket()
            socks.append(s)
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
            ok = base + width <= 65536 and all(abs(base - b) >= width for b in bases)
            for k in range(1, width if ok else 0):
                t = socket.socket()
                socks.append(t)
                try:
                    t.bind(("127.0.0.1", base + k))
                except OSError:
                    ok = False
                    break
            if ok:
                bases.append(base)
        return bases
    finally:
        for s in socks:
            s.close()


def tcp_servers(nparty: int, bases) -> dict:
    """The parties' TCP mesh on 127.0.0.1: the lower pid of each pair
    listens on the pair's base port, the pairs taken in order (0, 1), (0,
    2), ..., (1, 2), ... ({pid: {"ip", "ports": {higher pid: port}}})."""
    ip = "127.0.0.1"
    out = {p: {"ip": ip, "ports": {}} for p in range(nparty)}
    pairs = [(a, b) for a in range(nparty) for b in range(a + 1, nparty)]
    for (a, b), port in zip(pairs, bases, strict=True):
        out[a]["ports"][b] = port
    return out
