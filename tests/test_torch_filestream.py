"""Port parity: the host IO of sfgwas_tpu_torch (gwas/filestream.py,
gwas/utilities.py, gwas/pgen.py, gwas/params.py) against sfgwas_tpu's on
seeded files: the genotype stream's filters and missing replacement, the
plink2 count file, the matrix-file helpers, the ciphertext cache across
packages (uint32 residues in the .npz, either package's file loading in the
other bit for bit) and the PGEN reader on a synthetic file."""

import struct

import numpy as np
import pytest
import torch

from sfgwas_tpu.crypto import basics as RB
from sfgwas_tpu.crypto import ckks as RC
from sfgwas_tpu.crypto.params import get_params as ref_get_params
from sfgwas_tpu.gwas import filestream as RF
from sfgwas_tpu.gwas import pgen as RP
from sfgwas_tpu.gwas import utilities as RU
from sfgwas_tpu.gwas.params import FilterParams as RefFilterParams
from sfgwas_tpu.gwas.params import GWASParams as RefGWASParams
from sfgwas_tpu.mpc.mhe import CryptoParams as RefCryptoParams
from sfgwas_tpu_torch import interop
from sfgwas_tpu_torch.crypto import ckks as PC
from sfgwas_tpu_torch.crypto.params import get_params as port_get_params
from sfgwas_tpu_torch.gwas import filestream as PF
from sfgwas_tpu_torch.gwas import pgen as PP
from sfgwas_tpu_torch.gwas import utilities as PU
from sfgwas_tpu_torch.gwas.params import FilterParams, GWASParams
from sfgwas_tpu_torch.mpc.mhe import CryptoParams
from sfgwas_tpu_torch.ops import rns

N, M = 37, 29


@pytest.fixture
def geno_file(tmp_path):
    """A seeded int8 genotype file with about 10% missing (-1) entries."""
    rng = np.random.default_rng(5)
    g = rng.integers(0, 3, size=(N, M)).astype(np.int8)
    g[rng.uniform(size=(N, M)) < 0.1] = -1
    path = str(tmp_path / "geno.bin")
    PF.write_geno_file(path, g)
    return path, g


def _streams(path, replace_missing):
    return (RF.GenoFileStream(path, N, M, replace_missing=replace_missing),
            PF.GenoFileStream(path, N, M, replace_missing=replace_missing))


@pytest.mark.parametrize("replace_missing", [True, False])
def test_geno_stream_filters_and_read_all(geno_file, replace_missing):
    path, g = geno_file
    rng = np.random.default_rng(6)
    r, p = _streams(path, replace_missing)
    want = np.where(g < 0, 0, g) if replace_missing else g
    assert np.array_equal(p.read_all(), want)
    # two rounds of row and column filters, the second on the kept entries
    rows1, cols1 = rng.uniform(size=N) < 0.8, rng.uniform(size=M) < 0.7
    rows2 = rng.uniform(size=int(rows1.sum())) < 0.8
    cols2 = rng.uniform(size=int(cols1.sum())) < 0.9
    for s in (r, p):
        s.update_row_filt(rows1)
        s.update_col_filt(cols1)
        s.update_row_filt(rows2)
        s.update_col_filt(cols2)
    assert np.array_equal(p.row_filt, r.row_filt) and np.array_equal(p.col_filt, r.col_filt)
    assert (p.num_rows_to_keep(), p.num_cols_to_keep()) == (r.num_rows_to_keep(),
                                                            r.num_cols_to_keep())
    got = p.read_all()
    assert got.dtype == np.int8 and np.array_equal(got, r.read_all())
    assert np.array_equal(got, want[p.row_filt][:, p.col_filt])
    assert (got < 0).any() != replace_missing
    for (bi, a), (bj, b) in zip(p.iter_row_blocks(8), r.iter_row_blocks(8)):
        assert bi == bj and np.array_equal(a, b)
    for a, b in zip(p.missing_counts(), r.missing_counts()):
        assert np.array_equal(a, b)
    pheno = rng.normal(size=p.num_rows_to_keep())
    ps, rs = p.column_stats(pheno > 0), r.column_stats(pheno > 0)
    assert ps.keys() == rs.keys() and all(np.array_equal(ps[k], rs[k]) for k in ps)
    lazy = PF.LazyBlock(p)
    assert lazy.shape == got.shape
    assert np.array_equal(PF.load_block(lazy), got)
    assert np.array_equal(PF.load_block(got), got)


def test_geno_stream_rejects_short_file(geno_file):
    path, _ = geno_file
    with pytest.raises(AssertionError, match="bytes"):
        PF.GenoFileStream(path, N + 1, M)


def test_read_geno_stats_file(tmp_path):
    rng = np.random.default_rng(8)
    raw = rng.integers(0, 1000, size=(6, M)).astype("<u4")
    path = str(tmp_path / "gcount.bin")
    raw.tofile(path)
    got, want = PF.read_geno_stats_file(path, M), RF.read_geno_stats_file(path, M)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ac, gc, miss = got
    assert np.array_equal(ac[0], raw[1] + 2 * raw[0]) and np.array_equal(miss, raw[5])


def test_filter_transpose_merge_files(tmp_path, geno_file):
    path, g = geno_file
    rng = np.random.default_rng(9)
    rk, ck = rng.uniform(size=N) < 0.7, rng.uniform(size=M) < 0.6
    outs = {}
    for tag, mod in (("ref", RF), ("port", PF)):
        d = tmp_path / tag
        d.mkdir()
        shape = mod.filter_matrix_file(path, N, M, rk, ck, str(d / "filt.bin"))
        mod.transpose_matrix_file(path, N, M, str(d / "t.bin"))
        sizes = [10, 0, M - 10]
        for i, (a, b) in enumerate(((0, 10), (10, 10), (10, M))):
            np.ascontiguousarray(g[:, a:b]).tofile(str(d / f"blk.{i}.bin"))
        mod.merge_block_files(str(d / "blk"), N, sizes, str(d / "merged.bin"))
        outs[tag] = (shape, *((d / f).read_bytes() for f in ("filt.bin", "t.bin", "merged.bin")))
    assert outs["port"] == outs["ref"]
    shape, filt, t, merged = outs["port"]
    assert shape == (int(rk.sum()), int(ck.sum()))
    assert np.array_equal(np.frombuffer(filt, np.int8).reshape(shape), g[rk][:, ck])
    assert np.array_equal(np.frombuffer(t, np.int8).reshape(M, N), g.T)
    assert merged == g.tobytes()


def test_filter_files_and_params(tmp_path):
    filt = np.random.default_rng(10).uniform(size=M) < 0.5
    PU.write_filter(str(tmp_path / "p.txt"), filt)
    RU.write_filter(str(tmp_path / "r.txt"), filt)
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "r.txt").read_bytes()
    assert np.array_equal(PU.read_filter(str(tmp_path / "r.txt"), M), filt)
    with pytest.raises(ValueError, match="filter entries"):
        PU.read_filter(str(tmp_path / "r.txt"), M + 1)
    mat = np.random.default_rng(11).normal(size=(3, 4))
    np.savetxt(str(tmp_path / "m.txt"), mat, delimiter=",")
    assert np.array_equal(PU.load_matrix_float(str(tmp_path / "m.txt")),
                          RU.load_matrix_float(str(tmp_path / "m.txt")))
    fp, rfp = FilterParams(0.1, 28.374, 0.1, 0.05, 0.2, 0.5), RefFilterParams(
        0.1, 28.374, 0.1, 0.05, 0.2, 0.5)
    assert vars(fp) == vars(rfp)
    gp, rgp = GWASParams([0, 5, 6], 40, 2, 0, 1), RefGWASParams([0, 5, 6], 40, 2, 0, 1)
    for p in (gp, rgp):
        p.set_filt_counts([0, 4, 6], 30)
        p.set_snp_filt(filt)
        p.set_num_pc(3)
        p.set_num_snps_pca(12)
    assert {k: v for k, v in vars(gp).items() if k != "snp_filt"} == {
        k: v for k, v in vars(rgp).items() if k != "snp_filt"}
    assert np.array_equal(gp.snp_filt, rgp.snp_filt)


@pytest.fixture(scope="module")
def cipher_pair():
    """A reference TEST8 key bundle and cipher matrix (2 columns of 2
    ciphertexts, at two levels), and the port's CPU context."""
    rctx = RC.CkksContext(ref_get_params("TEST8"))
    rng = np.random.default_rng(3)
    sk = rctx.gen_secret_key(rng)
    pk = rctx.gen_public_key(sk, rng)
    rcps = RefCryptoParams(rctx, sk, pk, None, {}, rng)
    vals = np.random.default_rng(4).normal(size=(2, 200))
    cm = [RB.encrypt_float_vector(rcps, v) for v in vals]
    cm[1] = [rctx.drop_to(ct, rctx.nq - 2) for ct in cm[1]]
    pctx = PC.CkksContext(port_get_params("TEST8"), device="cpu")
    return rcps, cm, pctx, vals


def test_cipher_cache_crosses_packages(tmp_path, cipher_pair):
    rcps, rcm, pctx, vals = cipher_pair
    pcps = CryptoParams(pctx, None, None, None, {}, None)
    arrays = interop.cipher_matrix_arrays(rcm)
    extra = {"dsum": vals[0], "dsq": vals[1] ** 2}

    # the reference's file in the port
    RU.save_cipher_matrix(rcps, rcm, str(tmp_path / "ref.npz"), extra=extra)
    got = PU.load_cipher_matrix(pcps, str(tmp_path / "ref.npz"))
    for gcol, rcol in zip(got, arrays):
        for ct, (c0, c1, nmod, scale) in zip(gcol, rcol):
            assert ct.c0.dtype == torch.int32 and ct.c0.device == pctx.device
            assert np.array_equal(rns.to_u32(ct.c0), c0)
            assert np.array_equal(rns.to_u32(ct.c1), c1)
            assert (ct.nmod, ct.scale) == (nmod, scale)

    # the port's file, from the port's ciphertexts, in the reference
    pcm = interop.cipher_matrix(pctx, arrays)
    PU.save_cipher_matrix(pcps, pcm, str(tmp_path / "port.npz"), extra=extra)
    with np.load(str(tmp_path / "port.npz")) as zp, np.load(str(tmp_path / "ref.npz")) as zr:
        assert sorted(zp.files) == sorted(zr.files)
        for k in zr.files:
            assert zp[k].dtype == zr[k].dtype, k
            assert np.array_equal(zp[k], zr[k]), k
        assert zp["c0_0_0"].dtype == np.uint32
    back = interop.cipher_matrix_arrays(RU.load_cipher_matrix(rcps, str(tmp_path / "port.npz")))
    for bcol, acol in zip(back, arrays):
        for (b0, b1, bn, bs), (a0, a1, an, as_) in zip(bcol, acol):
            assert b0.dtype == np.uint32
            assert np.array_equal(b0, a0) and np.array_equal(b1, a1) and (bn, bs) == (an, as_)
    # and the port's loaded ciphertexts decrypt as the reference's do
    rdec = [rcps.ctx.decode(rcps.ctx.decrypt(ct, rcps.sk)) for ct in rcm[0]]
    psk = PC.SecretKey(pctx.to_dev(np.asarray(rcps.sk.s)))
    pdec = [pctx.decode(pctx.decrypt(ct, psk)) for ct in got[0]]
    for a, b in zip(pdec, rdec):
        np.testing.assert_allclose(a, b, atol=1e-6)


# --- PGEN: a synthetic mode-0x10 file with every hardcall record type the
# reader takes (the encoder of tests/test_pgen.py, copied)


def _varint(v):
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _encode_difflist(ids, vals, sid_bytes):
    L = len(ids)
    out = bytearray(_varint(L))
    if L == 0:
        return bytes(out)
    G = (L + 63) // 64
    groups = [ids[g * 64 : (g + 1) * 64] for g in range(G)]
    delta_streams = []
    for grp in groups:
        s = bytearray()
        for a, b in zip(grp[:-1], grp[1:]):
            s += _varint(b - a)
        delta_streams.append(bytes(s))
    for grp in groups:
        out += int(grp[0]).to_bytes(sid_bytes, "little")
    for s in delta_streams[:-1]:
        out.append(len(s))
    vb = np.zeros((L + 3) // 4, np.uint8)
    for k, v in enumerate(vals):
        vb[k // 4] |= (v & 3) << (2 * (k % 4))
    out += vb.tobytes()
    for s in delta_streams:
        out += s
    return bytes(out)


def _write_pgen(path, rows, vrtypes, sid_bytes=2):
    rows = np.asarray(rows, np.uint8)
    vct, sct = rows.shape
    recs = []
    ld_base = None
    for i, vt in enumerate(vrtypes):
        g = rows[i]
        if vt == 0:
            packed = np.zeros((sct + 3) // 4, np.uint8)
            for k in range(sct):
                packed[k // 4] |= (int(g[k]) & 3) << (2 * (k % 4))
            rec = bytearray(packed.tobytes())
            ld_base = g
        elif vt == 1:
            cnt = np.bincount(g, minlength=4)
            val0, val1 = np.argsort(cnt)[::-1][:2]
            bits = (g == val1).astype(np.uint8)
            rare = np.where((g != val0) & (g != val1))[0]
            rec = bytearray([((int(val0) & 3) << 2) | (int(val1) & 3)])
            rec += np.packbits(bits, bitorder="little")[: (sct + 7) // 8].tobytes()
            rec += _encode_difflist(rare, g[rare], sid_bytes)
            ld_base = g
        elif vt in (2, 3):
            b = ld_base.copy()
            if vt == 3:
                b = np.where(b == 0, 2, np.where(b == 2, 0, b)).astype(np.uint8)
            diff = np.where(g != b)[0]
            rec = bytearray(_encode_difflist(diff, g[diff], sid_bytes))
        else:  # 4/6/7
            diff = np.where(g != vt - 4)[0]
            rec = bytearray(_encode_difflist(diff, g[diff], sid_bytes))
            ld_base = g
        recs.append(bytes(rec))
    hdr = bytearray(b"\x6c\x1b\x10")
    hdr += struct.pack("<I", vct) + struct.pack("<I", sct) + bytes([0])
    body_off_pos = len(hdr)
    hdr += b"\x00" * 8
    nib = np.zeros((vct + 1) // 2, np.uint8)
    for i, vt in enumerate(vrtypes):
        nib[i // 2] |= (vt & 0xF) << (4 * (i % 2))
    hdr += nib.tobytes()
    hdr += bytes(len(r) for r in recs)
    struct.pack_into("<Q", hdr, body_off_pos, len(hdr))
    with open(path, "wb") as f:
        f.write(bytes(hdr) + b"".join(recs))


def _synthetic_rows(rng, sct):
    """Rows (2-bit codes, 3 = missing) and vrtypes 0, 2, 3, 4, 6, 7, 2, 1."""
    g0 = rng.integers(0, 4, size=sct).astype(np.uint8)
    rows, vrtypes = [g0], [0]
    g2 = g0.copy()
    g2[rng.choice(sct, 17, replace=False)] = rng.integers(0, 4, size=17)
    rows.append(g2)
    vrtypes.append(2)
    g3 = np.where(g0 == 0, 2, np.where(g0 == 2, 0, g0)).astype(np.uint8)
    g3[rng.choice(sct, 90, replace=False)] = rng.integers(0, 4, size=90)
    rows.append(g3)
    vrtypes.append(3)
    for vt in (4, 6, 7):
        g = np.full(sct, vt - 4, np.uint8)
        g[rng.choice(sct, 70, replace=False)] = rng.integers(0, 4, size=70)
        rows.append(g)
        vrtypes.append(vt)
    g2b = rows[-1].copy()
    g2b[rng.choice(sct, 5, replace=False)] = rng.integers(0, 4, size=5)
    rows.append(g2b)
    vrtypes.append(2)
    g1 = np.where(rng.random(sct) < 0.9, 0, 1).astype(np.uint8)
    g1[rng.choice(sct, 6, replace=False)] = rng.integers(2, 4, size=6)
    rows.append(g1)
    vrtypes.append(1)
    return np.stack(rows), vrtypes


def test_pgen_reader_matches_reference(tmp_path):
    rng = np.random.default_rng(7)
    sct = 300
    for c in (1, 2):
        rows, vrtypes = _synthetic_rows(rng, sct)
        _write_pgen(str(tmp_path / f"chr{c}.pgen"), rows, vrtypes)
    r = PP.PgenReader(str(tmp_path / "chr1.pgen"))
    assert (r.variant_ct, r.sample_ct) == (len(vrtypes), sct)
    assert list(r.vrtypes) == vrtypes
    got = r.read_all()
    ref = RP.PgenReader(str(tmp_path / "chr1.pgen"))
    assert np.array_equal(got, ref.read_all())
    # a window that starts on an LD record resolves its chain backward
    assert np.array_equal(r.read_range(1, 3), got[:, 1:3])
    assert np.array_equal(r.read_range(6, 8), ref.read_range(6, 8))
    both = PP.read_pgen_blocks(str(tmp_path), [1, 2])
    assert np.array_equal(both, RP.read_pgen_blocks(str(tmp_path), [1, 2]))
    # chr2's rows, as written
    assert np.array_equal(both[:, len(vrtypes):], np.where(rows.T == 3, -1, rows.T).astype(np.int8))


def test_pgen_rejects_type5_and_other_files(tmp_path):
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 4, size=(2, 64)).astype(np.uint8)
    path = str(tmp_path / "bad.pgen")
    _write_pgen(path, rows, [0, 4])
    data = bytearray(open(path, "rb").read())
    data[20] = (data[20] & 0x0F) | (5 << 4)
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="vrtype"):
        PP.PgenReader(path).read_all()
    open(path, "wb").write(b"\x00" * 32)
    with pytest.raises(AssertionError, match="not a PGEN"):
        PP.PgenReader(path)
