"""Genotype block IO (counterpart of sfgwas_tpu/gwas/filestream.py; the Go
sfgwas's GenoFileStream, gwas/filestream.go:284-494): row-major int8 binary
matrices with lazy row and column boolean filters and the missing-value
(-1 -> 0) replacement.  A reader returns whole filtered blocks; LazyBlock
defers the read to the block loop that consumes it, so the association
phase holds one block in host memory at a time.  Pure numpy.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np


class GenoFileStream:
    def __init__(
        self,
        filename: str,
        num_rows: int,
        num_cols: int,
        replace_missing: bool = True,
    ):
        self.filename = filename
        self.num_rows = int(num_rows)
        self.num_cols = int(num_cols)
        self.replace_missing = replace_missing
        self.row_filt: Optional[np.ndarray] = None
        self.col_filt: Optional[np.ndarray] = None
        size = os.path.getsize(filename)
        assert size >= self.num_rows * self.num_cols, (
            f"{filename}: {size} bytes < {num_rows}x{num_cols}"
        )

    # -- filters (gwas/filestream.go UpdateRowFilt/UpdateColFilt) -----------

    def update_row_filt(self, keep: np.ndarray):
        keep = np.asarray(keep, dtype=bool)
        if self.row_filt is None:
            assert len(keep) == self.num_rows
            self.row_filt = keep.copy()
        else:
            idx = np.where(self.row_filt)[0]
            assert len(keep) == len(idx)
            self.row_filt[idx[~keep]] = False

    def update_col_filt(self, keep: np.ndarray):
        keep = np.asarray(keep, dtype=bool)
        if self.col_filt is None:
            assert len(keep) == self.num_cols
            self.col_filt = keep.copy()
        else:
            idx = np.where(self.col_filt)[0]
            assert len(keep) == len(idx)
            self.col_filt[idx[~keep]] = False

    def num_rows_to_keep(self) -> int:
        return int(self.row_filt.sum()) if self.row_filt is not None else self.num_rows

    def num_cols_to_keep(self) -> int:
        return int(self.col_filt.sum()) if self.col_filt is not None else self.num_cols

    # -- block access -------------------------------------------------------

    def read_all(self) -> np.ndarray:
        """Full (filtered) matrix as int8."""
        m = np.memmap(self.filename, dtype=np.int8, mode="r")[
            : self.num_rows * self.num_cols
        ].reshape(self.num_rows, self.num_cols)
        if self.row_filt is not None:
            m = m[self.row_filt]
        if self.col_filt is not None:
            m = m[:, self.col_filt]
        m = np.asarray(m)
        if self.replace_missing:
            m = np.where(m < 0, 0, m)
        return m

    def iter_row_blocks(self, block_rows: int) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield (block_index, filtered block of <= block_rows rows)."""
        mat = self.read_all()
        for bi, start in enumerate(range(0, mat.shape[0], block_rows)):
            yield bi, mat[start : start + block_rows]

    def missing_counts(self) -> Tuple[np.ndarray, np.ndarray]:
        """(per-row missing count, per-row het count) on the filtered view,
        without missing replacement (used by the individual QC filters,
        gwas/qualcontrol.go:36-81)."""
        m = np.memmap(self.filename, dtype=np.int8, mode="r")[
            : self.num_rows * self.num_cols
        ].reshape(self.num_rows, self.num_cols)
        if self.row_filt is not None:
            m = m[self.row_filt]
        if self.col_filt is not None:
            m = m[:, self.col_filt]
        miss = (m < 0).sum(axis=1)
        het = (m == 1).sum(axis=1)
        return np.asarray(miss), np.asarray(het)

    def column_stats(self, pheno: Optional[np.ndarray] = None):
        """Per-column stats pass (dosage sums, genotype counts, missing
        counts) mirroring gwas/qualcontrol.go:427-465.  Returns a dict."""
        m = np.memmap(self.filename, dtype=np.int8, mode="r")[
            : self.num_rows * self.num_cols
        ].reshape(self.num_rows, self.num_cols)
        if self.row_filt is not None:
            m = m[self.row_filt]
        if self.col_filt is not None:
            m = m[:, self.col_filt]
        m = np.asarray(m)
        obs = m >= 0
        x = np.where(obs, m, 0).astype(np.int64)
        out = {
            "xsum": x.sum(axis=0),
            "xcount": 2 * obs.sum(axis=0),
            "miss": (~obs).sum(axis=0),
        }
        if pheno is not None:
            ctrl = np.asarray(pheno).reshape(-1) < 1
            mc = m[ctrl]
            obs_c = mc >= 0
            xc = np.where(obs_c, mc, 0).astype(np.int64)
            out["xsum_ctrl"] = xc.sum(axis=0)
            out["xcount_ctrl"] = 2 * obs_c.sum(axis=0)
            gobs = np.zeros((3, m.shape[1]), dtype=np.int64)
            for g in range(3):
                gobs[g] = ((mc == g)).sum(axis=0)
            out["geno_obs_ctrl"] = gobs
        return out


class LazyBlock:
    """Deferred filtered view of one genotype block: the shape is known up
    front, but the int8 matrix is read (and row/col-filtered) only inside
    the block loop that consumes it — phase 3 never holds more than one
    block in host memory at a time (the reference's block-row streaming,
    gwas/matmult.go:1238-1316 / gwas/filestream.go:284-494)."""

    def __init__(self, stream: GenoFileStream):
        self.stream = stream

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.stream.num_rows_to_keep(), self.stream.num_cols_to_keep())

    def load(self) -> np.ndarray:
        return self.stream.read_all()


def load_block(blk) -> np.ndarray:
    """Materialize a block that may be lazy (LazyBlock) or an ndarray."""
    return blk.load() if hasattr(blk, "load") else np.asarray(blk)


def write_geno_file(path: str, mat: np.ndarray):
    np.asarray(mat, dtype=np.int8).tofile(path)


def filter_matrix_file(src: str, n: int, m: int, row_keep, col_keep, dst: str):
    """Materialize a filtered copy (FilterMatrixFile, gwas/utilities.go)."""
    a = np.fromfile(src, dtype=np.int8, count=n * m).reshape(n, m)
    a = a[np.asarray(row_keep, bool)][:, np.asarray(col_keep, bool)]
    a.tofile(dst)
    return a.shape


def transpose_matrix_file(src: str, n: int, m: int, dst: str):
    a = np.fromfile(src, dtype=np.int8, count=n * m).reshape(n, m)
    np.ascontiguousarray(a.T).tofile(dst)


def merge_block_files(prefix: str, n: int, block_sizes, dst: str):
    """Column-concatenate per-block files (MergeBlockFiles)."""
    mats = []
    for i, bs in enumerate(block_sizes):
        if bs == 0:
            continue
        mats.append(
            np.fromfile(f"{prefix}.{i}.bin", dtype=np.int8, count=n * bs).reshape(n, bs)
        )
    np.concatenate(mats, axis=1).tofile(dst)


def read_geno_stats_file(path: str, m: int):
    """6 x m uint32 little-endian stats file (ReadGenoStatsFromFile,
    gwas/utilities.go:32-69): hom-ref GC, het GC, hom-alt GC, (2 derived AC
    slots), missing count."""
    raw = np.fromfile(path, dtype="<u4", count=6 * m).reshape(6, m)
    gc = raw[:3]
    ac = np.stack([raw[1] + 2 * raw[0], raw[1] + 2 * raw[2]])
    miss = raw[5]
    return ac, gc, miss
