"""Grouped and global HyperLogLog builds, merges and estimates over Series
(the port's copy of daft_tpu/sketch/hll.py).

A build hashes the rows with the host hash (kernels/host_hash, the hashes
every shuffle uses, so every dtype that groups can be sketched) and reduces
(group, register) pairs to their largest rank; a merge is the same
reduction over decoded entries.

Each sketch serializes in the smaller of two forms, so one group a row
never costs 16 KiB on the exchange:

- dense: HLL_M bytes, one uint8 register each;
- sparse: ``<u4 count, <u4 reserved, count x <u4 (idx << 8 | rank)``, for a
  sketch with at most SPARSE_LIMIT occupied registers.

The length tells them apart (a sparse payload is at most
8 + 4 x SPARSE_LIMIT < HLL_M bytes). Inside, everything is COO entries
(rows, idxs, ranks): no [num_groups, HLL_M] matrix is ever made, except by
``build_grouped_registers`` and ``binary_to_registers`` for the few-row
cases (a global estimate, the device check, the mesh merge).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ..errors import DaftValueError
from ..kernels.host_hash import hash_array
from ..kernels.sketches import (
    HLL_M,
    HLL_P,
    estimate_from_histogram,
    estimate_from_registers,
    register_ranks,
)

MAX_RANK = 64 - HLL_P + 1
#: occupied-register count above which dense (16 KiB) is the smaller form
SPARSE_LIMIT = 2048


def _reduce_max(seg: np.ndarray, rank: np.ndarray):
    """Unique segment ids with their max rank (sorted by segment)."""
    if len(seg) == 0:
        return seg, rank
    order = np.lexsort((rank, seg))
    seg_s, rank_s = seg[order], rank[order]
    last = np.concatenate([seg_s[1:] != seg_s[:-1], [True]])
    return seg_s[last], rank_s[last]


def _write_u32_le(buf: np.ndarray, pos: np.ndarray, vals: np.ndarray) -> None:
    """Scatter little-endian uint32 values at arbitrary byte positions
    (no alignment assumption — arrow value offsets carry no guarantee)."""
    v = vals.astype(np.uint32)
    for k in range(4):
        buf[pos + k] = ((v >> np.uint32(8 * k)) & np.uint32(0xFF)).astype(np.uint8)


def _read_u32_le(data: np.ndarray, pos: np.ndarray) -> np.ndarray:
    out = data[pos].astype(np.uint32)
    for k in range(1, 4):
        out |= data[pos + k].astype(np.uint32) << np.uint32(8 * k)
    return out


def _encode_rows(groups: np.ndarray, idxs: np.ndarray, ranks: np.ndarray,
                 num_rows: int) -> pa.Array:
    """COO entries (sorted by group) -> large_binary array of num_rows
    sketches, each dense or sparse by its own occupancy. Fully vectorized:
    one output buffer, entries scattered by computed byte positions."""
    counts = np.bincount(groups, minlength=num_rows) if len(groups) else \
        np.zeros(num_rows, dtype=np.int64)
    coo_offs = np.concatenate([[0], np.cumsum(counts)])
    dense = counts > SPARSE_LIMIT
    lengths = np.where(dense, HLL_M, 8 + 4 * counts)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    buf = np.zeros(int(offsets[-1]), dtype=np.uint8)
    if len(groups):
        entry_dense = dense[groups]
        # dense rows: registers scattered straight into the payload
        if entry_dense.any():
            g = groups[entry_dense]
            buf[offsets[g] + idxs[entry_dense]] = ranks[entry_dense]
        # sparse rows: <u4 header (count), zero reserved word, packed entries
        sp_rows = np.nonzero(~dense)[0]
        _write_u32_le(buf, offsets[sp_rows], counts[sp_rows])
        sp = ~entry_dense
        if sp.any():
            g = groups[sp]
            j = (np.arange(len(groups)) - coo_offs[groups])[sp]
            pos = offsets[g] + 8 + 4 * j
            packed = (idxs[sp].astype(np.uint32) << np.uint32(8)) | ranks[sp]
            _write_u32_le(buf, pos, packed)
    else:
        sp_rows = np.arange(num_rows)
        _write_u32_le(buf, offsets[sp_rows], np.zeros(num_rows, np.int64))
    return pa.Array.from_buffers(
        pa.large_binary(), num_rows,
        [None, pa.py_buffer(offsets.astype(np.int64).tobytes()),
         pa.py_buffer(buf.tobytes())])


def _decode_rows(arr) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Binary sketch column -> COO (row, idx, rank), validated. Null rows
    contribute no entries. Raises DaftValueError on any corrupt payload."""
    if hasattr(arr, "to_arrow"):
        arr = arr.to_arrow()
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    arr = arr.cast(pa.large_binary())
    n = len(arr)
    empty = (np.empty(0, np.int64), np.empty(0, np.int64),
             np.empty(0, np.uint8))
    if n == 0:
        return empty
    bufs = arr.buffers()
    offs = np.frombuffer(bufs[1], dtype=np.int64)[arr.offset:arr.offset + n + 1]
    data = np.frombuffer(bufs[2], dtype=np.uint8) if bufs[2] is not None else \
        np.empty(0, np.uint8)
    lengths = np.diff(offs)
    valid = np.asarray(pc.is_valid(arr))
    lengths = np.where(valid, lengths, 0)
    dense = valid & (lengths == HLL_M)
    sparse = valid & (lengths != HLL_M) & (lengths > 0)
    if ((lengths[sparse] < 8) | ((lengths[sparse] - 8) % 4 != 0)).any():
        raise DaftValueError("corrupt HLL sketch: bad payload length")
    rows_out, idx_out, rank_out = [], [], []
    d_rows = np.nonzero(dense)[0]
    if len(d_rows):
        block = data[offs[d_rows][:, None] + np.arange(HLL_M)]
        if int(block.max(initial=0)) > MAX_RANK:
            raise DaftValueError(
                f"corrupt HLL sketch: register value exceeds max rank {MAX_RANK}")
        r, i = np.nonzero(block)
        rows_out.append(d_rows[r])
        idx_out.append(i.astype(np.int64))
        rank_out.append(block[r, i])
    s_rows = np.nonzero(sparse)[0]
    if len(s_rows):
        counts = _read_u32_le(data, offs[s_rows]).astype(np.int64)
        if (counts != (lengths[s_rows] - 8) // 4).any() or \
                (counts > SPARSE_LIMIT).any():
            raise DaftValueError("corrupt HLL sketch: bad sparse entry count")
        total = int(counts.sum())
        if total:
            row_rep = np.repeat(s_rows, counts)
            starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
            j = np.arange(total) - np.repeat(starts, counts)
            pos = np.repeat(offs[s_rows] + 8, counts) + 4 * j
            packed = _read_u32_le(data, pos)
            idx = (packed >> np.uint32(8)).astype(np.int64)
            rank = (packed & np.uint32(0xFF)).astype(np.uint8)
            if int(idx.max(initial=0)) >= HLL_M or \
                    int(rank.max(initial=0)) > MAX_RANK or (rank == 0).any():
                raise DaftValueError("corrupt HLL sketch: bad sparse entry")
            rows_out.append(row_rep)
            idx_out.append(idx)
            rank_out.append(rank)
    if not rows_out:
        return empty
    return (np.concatenate(rows_out), np.concatenate(idx_out),
            np.concatenate(rank_out).astype(np.uint8))


def registers_to_binary(regs: np.ndarray) -> pa.Array:
    """[G, HLL_M] uint8 register rows -> binary sketches (adaptive
    encoding, identical bytes to the COO build of the same registers)."""
    g, i = np.nonzero(regs)
    return _encode_rows(g.astype(np.int64), i.astype(np.int64),
                        np.asarray(regs)[g, i], regs.shape[0])


def binary_to_registers(arr) -> np.ndarray:
    """Binary sketch column -> DENSE [n, HLL_M] uint8 registers. For the
    few-row cases only (the mesh collective merges one row per partition);
    group-cardinality-scaled paths stay in COO form."""
    if hasattr(arr, "to_arrow"):
        arr = arr.to_arrow()
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    rows, idxs, ranks = _decode_rows(arr)
    out = np.zeros((len(arr), HLL_M), dtype=np.uint8)
    out[rows, idxs] = ranks
    return out


def scatter_operands(arr: pa.Array, codes: Optional[np.ndarray] = None):
    """(codes, idx, rank) for the valid rows of `arr` — the register-scatter
    operands shared by the host build below and the device build
    (sketch/device.py). `codes` None means one global group (zeros)."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if codes is None:
        codes = np.zeros(len(arr), dtype=np.int64)
    if arr.null_count:
        valid = np.asarray(pc.is_valid(arr))
        arr = arr.drop_null()
        codes = codes[valid]
    if len(arr) == 0:
        return codes[:0], np.empty(0, np.int64), np.empty(0, np.uint8)
    idx, rank = register_ranks(hash_array(arr))
    return codes, idx, rank


def build_grouped_registers(arr: pa.Array,
                            codes: Optional[np.ndarray],
                            num_groups: int) -> np.ndarray:
    """[num_groups, HLL_M] DENSE register rows from one column + group
    codes (global estimates, tests, and the device-parity check; the
    grouped Series path uses the COO build below)."""
    regs = np.zeros((num_groups, HLL_M), dtype=np.uint8)
    gcodes, idx, rank = scatter_operands(arr, codes)
    if len(idx):
        np.maximum.at(regs, (gcodes, idx), rank)
    return regs


def build_grouped(series, codes: Optional[np.ndarray], num_groups: int):
    """One serialized HLL sketch per group (Binary Series) — the stage-1
    kernel behind the `sketch_hll` AggExpr kind. COO end to end: memory and
    payload scale with occupied registers, not num_groups x 16 KiB."""
    from ..datatypes import DataType
    from ..series import Series

    if series.is_python():
        series = series.cast(DataType.string())
    gcodes, idx, rank = scatter_operands(series.to_arrow(), codes)
    seg = gcodes.astype(np.int64) * HLL_M + idx
    useg, urank = _reduce_max(seg, rank)
    out = _encode_rows(useg // HLL_M, useg % HLL_M, urank, num_groups)
    return Series.from_arrow(out, series.name, DataType.binary())


def merge_grouped(series, codes: Optional[np.ndarray], num_groups: int):
    """Merge serialized sketches per group (register max over decoded
    entries) — the stage-2 kernel behind `merge_sketch_hll`. This is the
    subsystem's merge fault boundary (site `sketch.merge`)."""
    from .. import faults
    from ..datatypes import DataType
    from ..series import Series

    faults.check("sketch.merge")
    rows, idxs, ranks = _decode_rows(series)
    if codes is None:
        groups = np.zeros(len(rows), dtype=np.int64)
    else:
        groups = np.asarray(codes, dtype=np.int64)[rows]
    seg = groups * HLL_M + idxs
    useg, urank = _reduce_max(seg, ranks)
    out = _encode_rows(useg // HLL_M, useg % HLL_M, urank, num_groups)
    return Series.from_arrow(out, series.name, DataType.binary())


def estimate_series(series):
    """Per-row cardinality estimates of a Binary sketch column (the final
    projection's `sketch.hll_estimate` function) — histograms built
    straight from COO entries, no densification. Null sketches -> null."""
    from ..datatypes import DataType
    from ..series import Series

    arr = series.to_arrow()
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    n = len(arr)
    rows, _idxs, ranks = _decode_rows(arr)
    hist = np.zeros((n, MAX_RANK + 1), dtype=np.float64)
    if len(rows):
        np.add.at(hist, (rows, ranks.astype(np.int64)), 1.0)
    nnz = hist[:, 1:].sum(axis=1)
    hist[:, 0] = HLL_M - nnz
    est = estimate_from_histogram(hist, HLL_M)
    mask = np.asarray(pc.is_null(arr)) if arr.null_count else None
    out = pa.array(est, type=pa.uint64(), mask=mask)
    return Series.from_arrow(out, series.name, DataType.uint64())


def grouped_estimates(series, codes: Optional[np.ndarray],
                      num_groups: int) -> np.ndarray:
    """Per-group cardinality estimates in one COO pass (build + histogram
    + estimate, no per-group 16 KiB materialization) — the grouped
    approx_count_distinct kernel for single-partition execution."""
    from ..datatypes import DataType

    if series.is_python():
        series = series.cast(DataType.string())
    gcodes, idx, rank = scatter_operands(series.to_arrow(), codes)
    seg = gcodes.astype(np.int64) * HLL_M + idx
    useg, urank = _reduce_max(seg, rank)
    hist = np.zeros((num_groups, MAX_RANK + 1), dtype=np.float64)
    if len(useg):
        np.add.at(hist, (useg // HLL_M, urank.astype(np.int64)), 1.0)
    hist[:, 0] = HLL_M - hist[:, 1:].sum(axis=1)
    return estimate_from_histogram(hist, HLL_M)


def count_distinct_estimate(series) -> int:
    """Global approx_count_distinct of one Series via a single HLL build."""
    from ..datatypes import DataType

    if series.is_python():
        series = series.cast(DataType.string())
    regs = build_grouped_registers(series.to_arrow(), None, 1)
    return int(estimate_from_registers(regs)[0])
