"""Native PGEN (plink2 genotype) reader (counterpart of
sfgwas_tpu/gwas/pgen.py).

The reference shells out to plink2 at runtime for .pgen extraction
(gwas/utilities.go:141-200, scripts/filterMatrixPgen.sh); this module reads
the format directly so the runtime stays pure Python/numpy.

Supported: storage mode 0x10 (standard variable-record) with the 4-bit
vrtype / 1-byte record-length header layout, hardcall record types

  * 0 — direct 2-bit hardcalls;
  * 1 — "onebit": two common genotype values selected by a 1-bit matrix
        (byte0: bits 0-1 = value for bit 1, bits 2-3 = value for bit 0),
        plus a difflist of rare overrides;
  * 2 — LD-compressed: copy of the most recent non-LD variant, plus a
        difflist of overrides;
  * 3 — LD-compressed + inverted: as 2 but the copied base is allele-
        flipped (0<->2, 1 and missing unchanged) before the difflist;
  * 4 / 6 / 7 — constant-base difflist: every sample is (vrtype&7)-4
        (0 = hom-ref, 2 = hom-alt, 3 = missing) except the difflist
        entries ((vrtype&7)==5 is disallowed by the format);

and the difflist encoding: varint length, raw group-start sample IDs
(groups of 64), one extra byte per non-first group, packed 2-bit values,
then per-group varint sample-ID deltas.  The reference package checked
types 0/1 against plink2's own --geno-counts output on the Go sfgwas's
example data; types 2-7 are covered by synthetic round-trip fixtures built
to the published pgen spec (tests/test_pgen.py, tests/test_torch_filestream.py).
Phase/dosage tracks (vrtype bits 3-6) are not decoded: hardcalls are read
and the trailing track bytes are ignored, which matches the reference's
use of plink2 --make-bed style hardcall extraction
(gwas/utilities.go:141-200).

Genotype codes: 0/1/2 dosage, 3 = missing (mapped to -1 in the int8
output, matching scripts/plinkBedToBinary.py:26).
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np


def _parse_varint(buf: np.ndarray, pos: int) -> Tuple[int, int]:
    v = 0
    shift = 0
    while True:
        b = int(buf[pos])
        pos += 1
        v |= (b & 0x7F) << shift
        if not (b & 0x80):
            return v, pos
        shift += 7


class PgenReader:
    """Reader for one .pgen file (one chromosome in the reference layout)."""

    def __init__(self, path: str):
        self.path = path
        d = np.fromfile(path, dtype=np.uint8)
        assert d[0] == 0x6C and d[1] == 0x1B, "not a PGEN file"
        mode = int(d[2])
        assert mode == 0x10, f"unsupported PGEN storage mode {mode:#x}"
        self.variant_ct = struct.unpack("<I", d[3:7].tobytes())[0]
        self.sample_ct = struct.unpack("<I", d[7:11].tobytes())[0]
        fmt = int(d[11])
        # observed layouts: low nibble 0 -> 4-bit vrtypes + 1-byte lengths
        assert (fmt & 0x0F) == 0, f"unsupported PGEN header format {fmt:#x}"
        n_blocks = (self.variant_ct + 65535) // 65536
        p = 12
        self._block_offs = [
            struct.unpack("<Q", d[p + 8 * i : p + 8 * i + 8].tobytes())[0]
            for i in range(n_blocks)
        ]
        p += 8 * n_blocks
        vct = self.variant_ct
        nib = d[p : p + (vct + 1) // 2]
        p += (vct + 1) // 2
        vr = np.zeros(vct, np.uint8)
        vr[0::2] = nib & 0xF
        vr[1::2] = (nib[: vct // 2] >> 4) & 0xF
        self.vrtypes = vr
        lens = d[p : p + vct].astype(np.int64)
        self.rec_lens = lens
        offs = np.empty(vct + 1, np.int64)
        offs[0] = self._block_offs[0]
        np.cumsum(lens, out=offs[1:])
        offs[1:] += self._block_offs[0]
        self.rec_offs = offs
        self._data = d
        self._sid_bytes = 1 if self.sample_ct <= 256 else (
            2 if self.sample_ct <= 65536 else 3
        )

    # ------------------------------------------------------------------
    def _decode_difflist(self, rec, pos):
        L, pos = _parse_varint(rec, pos)
        if L == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.uint8), pos
        G = (L + 63) // 64
        sb = self._sid_bytes
        starts = np.zeros(G, np.int64)
        for g in range(G):
            starts[g] = int.from_bytes(rec[pos : pos + sb].tobytes(), "little")
            pos += sb
        pos += max(0, G - 1)  # per-group byte-length hints (unused)
        nvb = (L + 3) // 4
        vb = rec[pos : pos + nvb]
        pos += nvb
        k = np.arange(L)
        vals = (vb[k // 4] >> (2 * (k % 4)).astype(np.uint8)) & 3
        ids = np.zeros(L, np.int64)
        w = 0
        for g in range(G):
            n_in_g = min(64, L - g * 64)
            seg_lo = pos
            # fast path: all deltas single-byte
            seg = rec[pos : pos + n_in_g - 1]
            if n_in_g > 1 and seg.size == n_in_g - 1 and not (seg & 0x80).any():
                ids[w : w + n_in_g] = starts[g] + np.concatenate(
                    [[0], np.cumsum(seg.astype(np.int64))]
                )
                pos += n_in_g - 1
                w += n_in_g
            else:
                cur = int(starts[g])
                ids[w] = cur
                w += 1
                for _ in range(n_in_g - 1):
                    dlt, pos = _parse_varint(rec, pos)
                    cur += dlt
                    ids[w] = cur
                    w += 1
        return ids, vals.astype(np.uint8), pos

    def read_all(self) -> np.ndarray:
        """Decode every variant -> int8 [sample_ct, variant_ct]
        (0/1/2 dosage, -1 missing)."""
        return self.read_range(0, self.variant_ct)

    def read_range(self, v0: int, v1: int) -> np.ndarray:
        """Decode variants [v0, v1) -> int8 [sample_ct, v1-v0].  The window
        extends backward internally to the nearest non-LD record so LD
        chains resolve; callers stream batches (config pgen_batch_nsnp,
        reference gwas/assoc.go:354-419) with bounded memory."""
        d = self._data
        sct = self.sample_ct
        base_all = self.vrtypes & 7
        lo = v0
        while lo > 0 and base_all[lo] in (2, 3):
            lo -= 1
        vct = v1 - lo
        out = np.zeros((vct, sct), np.int8)
        base = base_all[lo:v1]
        has_tracks = self.vrtypes[lo:v1] >= 8  # phase/dosage tracks follow

        # type 0: batch-decode all direct records at once
        t0 = np.where(base == 0)[0]
        if t0.size:
            nb = (sct + 3) // 4
            recs = np.zeros((t0.size, nb), np.uint8)
            for j, i in enumerate(t0 + lo):
                recs[j] = d[self.rec_offs[i] : self.rec_offs[i] + nb]
            k = np.arange(sct)
            codes = (recs[:, k // 4] >> (2 * (k % 4)).astype(np.uint8)) & 3
            out[t0] = codes

        bb = (sct + 7) // 8
        bad = np.where(base == 5)[0]
        if bad.size:
            raise ValueError(f"invalid PGEN vrtype&7 == 5 at {bad[:4].tolist()}")
        # LD chain state: most recent non-LD-compressed hardcall row, in raw
        # 2-bit codes.  Sequential pass over the non-type-0 records (LD
        # records reference decode order, so order matters).
        ld_base = None
        for i in range(vct):
            bt = int(base[i])
            if bt == 0:
                ld_base = out[i]
                continue
            rec = d[self.rec_offs[lo + i] : self.rec_offs[lo + i + 1]]
            if bt == 1:
                b0 = int(rec[0])
                val1, val0 = b0 & 3, (b0 >> 2) & 3
                bits = np.unpackbits(rec[1 : 1 + bb], bitorder="little")[:sct]
                g = np.where(bits, val1, val0).astype(np.uint8)
                ids, vals, pos = self._decode_difflist(rec, 1 + bb)
            elif bt in (2, 3):
                if ld_base is None:
                    raise ValueError(
                        f"LD-compressed record {i} with no prior base variant"
                    )
                g = np.asarray(ld_base, np.uint8).copy()
                if bt == 3:
                    # allele flip: 0<->2; 1 (het) and 3 (missing) unchanged
                    g = np.where(g == 0, 2, np.where(g == 2, 0, g)).astype(
                        np.uint8
                    )
                ids, vals, pos = self._decode_difflist(rec, 0)
            else:  # 4 / 6 / 7: constant base (vrtype&7)-4
                g = np.full(sct, bt - 4, np.uint8)
                ids, vals, pos = self._decode_difflist(rec, 0)
            if not has_tracks[i]:
                assert pos == len(rec), (self.path, int(lo + i), pos, len(rec))
            if ids.size:
                g[ids] = vals
            out[i] = g
            if bt not in (2, 3):
                ld_base = out[i]
        res = out[v0 - lo :].T.astype(np.int8)
        return np.where(res == 3, np.int8(-1), res)


def read_pgen_blocks(prefix: str, chroms: List[int]) -> np.ndarray:
    """Concatenate per-chromosome pgen files (reference example_data layout:
    <prefix>/chr{c}.pgen) into one int8 [samples, snps] matrix."""
    mats = [PgenReader(f"{prefix}/chr{c}.pgen").read_all() for c in chroms]
    return np.concatenate(mats, axis=1)
