"""Grouped and global quantile-sketch builds, merges and estimates over
Series (the port's copy of daft_tpu/sketch/quantile.py).

Stage 1 keeps each group's numeric values as a bounded weighted sample
(kernels/sketches.quantile_compress, deterministic); stage 2 concatenates
the samples of a group and compresses them again; the final projection
interpolates the percentiles. A sketch serializes as
kernels/sketches.quantile_state_to_bytes lays it out
(``<u4 cap, <u4 count, count x <f8 values, count x <f8 weights``), in a
binary column.

Inside, everything is flat entries decoded from and encoded into the arrow
offset and data buffers; python loops only over the groups that pass their
cap (at most total entries / cap of them), so many groups cost O(entries).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ..errors import DaftValueError
from ..kernels.sketches import (
    QUANTILE_CAP,
    quantile_compress,
    weighted_quantiles,
)
from .hll import _read_u32_le, _write_u32_le


def _require_numeric(series) -> None:
    dt = series.dtype
    if not (dt.is_numeric() or dt.is_boolean() or dt.is_null()):
        raise DaftValueError(
            f"approx_percentiles needs a numeric input, got {dt}")


def _read_f8_le(data: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Gather little-endian float64 at arbitrary byte positions."""
    b = data[pos[:, None] + np.arange(8)]
    return np.ascontiguousarray(b).view("<f8")[:, 0]


def _write_f8_le(buf: np.ndarray, pos: np.ndarray, vals: np.ndarray) -> None:
    v8 = np.ascontiguousarray(vals, dtype="<f8").view(np.uint8).reshape(-1, 8)
    for k in range(8):
        buf[pos + k] = v8[:, k]


def _decode_states(arr) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
    """Binary quantile-sketch column -> flat entries (rows, values,
    weights) sorted by row, plus per-ROW caps (0 for null rows). Raises
    DaftValueError on corrupt payloads."""
    if hasattr(arr, "to_arrow"):
        arr = arr.to_arrow()
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    arr = arr.cast(pa.large_binary())
    n = len(arr)
    caps_out = np.zeros(n, dtype=np.int64)
    empty = (np.empty(0, np.int64), np.empty(0, np.float64),
             np.empty(0, np.float64), caps_out)
    if n == 0:
        return empty
    bufs = arr.buffers()
    offs = np.frombuffer(bufs[1], dtype=np.int64)[arr.offset:arr.offset + n + 1]
    data = np.frombuffer(bufs[2], dtype=np.uint8) if bufs[2] is not None else \
        np.empty(0, np.uint8)
    lengths = np.diff(offs)
    valid = np.asarray(pc.is_valid(arr))
    lengths = np.where(valid, lengths, 0)
    rows = np.nonzero(lengths > 0)[0]
    if len(rows) == 0:
        return empty
    if (lengths[rows] < 8).any():
        raise DaftValueError("corrupt quantile sketch: bad payload length")
    caps = _read_u32_le(data, offs[rows]).astype(np.int64)
    counts = _read_u32_le(data, offs[rows] + 4).astype(np.int64)
    if (lengths[rows] != 8 + 16 * counts).any():
        raise DaftValueError("corrupt quantile sketch: bad entry count")
    caps_out[rows] = caps
    total = int(counts.sum())
    if total == 0:
        return (np.empty(0, np.int64), np.empty(0, np.float64),
                np.empty(0, np.float64), caps_out)
    row_rep = np.repeat(rows, counts)
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    j = np.arange(total) - np.repeat(starts, counts)
    vpos = np.repeat(offs[rows] + 8, counts) + 8 * j
    wpos = np.repeat(offs[rows] + 8 + 8 * counts, counts) + 8 * j
    return (row_rep, _read_f8_le(data, vpos), _read_f8_le(data, wpos),
            caps_out)


def _encode_states(groups: np.ndarray, values: np.ndarray,
                   weights: np.ndarray, caps: np.ndarray,
                   num_rows: int) -> pa.Array:
    """Flat entries (sorted by group) + per-row caps -> large_binary array
    of num_rows sketches, one vectorized buffer fill."""
    counts = np.bincount(groups, minlength=num_rows) if len(groups) else \
        np.zeros(num_rows, dtype=np.int64)
    coo_offs = np.concatenate([[0], np.cumsum(counts)])
    lengths = 8 + 16 * counts
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    buf = np.zeros(int(offsets[-1]), dtype=np.uint8)
    _write_u32_le(buf, offsets[:-1], caps)
    _write_u32_le(buf, offsets[:-1] + 4, counts)
    if len(groups):
        j = np.arange(len(groups)) - coo_offs[groups]
        vpos = offsets[groups] + 8 + 8 * j
        wpos = offsets[groups] + 8 + 8 * counts[groups] + 8 * j
        _write_f8_le(buf, vpos, values)
        _write_f8_le(buf, wpos, weights)
    return pa.Array.from_buffers(
        pa.large_binary(), num_rows,
        [None, pa.py_buffer(offsets.astype(np.int64).tobytes()),
         pa.py_buffer(buf.tobytes())])


def _compress_groups(groups: np.ndarray, values: np.ndarray,
                     weights: np.ndarray, caps: np.ndarray,
                     num_groups: int):
    """Compress only the groups whose entry count exceeds their cap (at
    most total/cap of them); everything else passes through untouched.
    Entries must arrive (and leave) sorted by group."""
    counts = np.bincount(groups, minlength=num_groups) if len(groups) else \
        np.zeros(num_groups, dtype=np.int64)
    over = np.nonzero(counts > caps[:num_groups])[0]
    if len(over) == 0:
        return groups, values, weights
    offs = np.concatenate([[0], np.cumsum(counts)])
    keep = np.ones(len(groups), dtype=bool)
    add_g: List[np.ndarray] = []
    add_v: List[np.ndarray] = []
    add_w: List[np.ndarray] = []
    for g in over:
        s, e = int(offs[g]), int(offs[g + 1])
        cv, cw = quantile_compress(values[s:e], weights[s:e], int(caps[g]))
        keep[s:e] = False
        add_g.append(np.full(len(cv), g, dtype=np.int64))
        add_v.append(cv)
        add_w.append(cw)
    groups = np.concatenate([groups[keep]] + add_g)
    values = np.concatenate([values[keep]] + add_v)
    weights = np.concatenate([weights[keep]] + add_w)
    order = np.argsort(groups, kind="stable")
    return groups[order], values[order], weights[order]


def build_grouped(series, codes: Optional[np.ndarray], num_groups: int):
    """One serialized quantile sketch per group (Binary Series) — the
    stage-1 kernel behind the `sketch_quantile` AggExpr kind."""
    from ..datatypes import DataType
    from ..series import Series

    _require_numeric(series)
    vals = series.cast(DataType.float64()).to_arrow()
    if isinstance(vals, pa.ChunkedArray):
        vals = vals.combine_chunks()
    v = np.asarray(pc.fill_null(vals, np.nan), dtype=np.float64)
    if codes is None:
        codes = np.zeros(len(v), dtype=np.int64)
    good = ~np.isnan(v)
    groups = np.asarray(codes, dtype=np.int64)[good]
    v = v[good]
    order = np.argsort(groups, kind="stable")
    groups, v = groups[order], v[order]
    caps = np.full(num_groups, QUANTILE_CAP, dtype=np.int64)
    groups, v, w = _compress_groups(groups, v, np.ones(len(v)), caps,
                                    num_groups)
    out = _encode_states(groups, v, w, caps, num_groups)
    return Series.from_arrow(out, series.name, DataType.binary())


def merge_grouped(series, codes: Optional[np.ndarray], num_groups: int):
    """Merge serialized quantile sketches per group (weighted-sample concat
    + deterministic re-compression) — the stage-2 kernel behind
    `merge_sketch_quantile` (fault site `sketch.merge`). A merge never
    LOWERS precision: each group keeps the max cap of its inputs."""
    from .. import faults
    from ..datatypes import DataType
    from ..series import Series

    faults.check("sketch.merge")
    rows, v, w, row_caps = _decode_states(series)
    if codes is None:
        groups = np.zeros(len(rows), dtype=np.int64)
        row_groups = np.zeros(len(row_caps), dtype=np.int64)
    else:
        codes = np.asarray(codes, dtype=np.int64)
        groups = codes[rows]
        row_groups = codes
    caps = np.full(num_groups, 0, dtype=np.int64)
    if len(row_caps):
        np.maximum.at(caps, row_groups[:len(row_caps)], row_caps)
    caps[caps == 0] = QUANTILE_CAP
    order = np.argsort(groups, kind="stable")
    groups, v, w = groups[order], v[order], w[order]
    groups, v, w = _compress_groups(groups, v, w, caps, num_groups)
    out = _encode_states(groups, v, w, caps, num_groups)
    return Series.from_arrow(out, series.name, DataType.binary())


def estimate_series(series, percentiles):
    """Per-row percentile estimates of a Binary sketch column (the final
    projection's `sketch.quantile_estimate` function). Scalar percentile ->
    float64 column; list -> list<float64> column. Empty sketches -> null."""
    from ..datatypes import DataType
    from ..series import Series

    single = isinstance(percentiles, float)
    qs = [percentiles] if single else list(percentiles)
    if not qs:
        raise DaftValueError("approx_percentiles needs at least one percentile")
    arr = series.to_arrow()
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    n = len(arr)
    rows, v, w, _caps = _decode_states(arr)
    counts = np.bincount(rows, minlength=n) if len(rows) else \
        np.zeros(n, dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(counts)])
    out_rows: List = []
    null_rows = np.asarray(pc.is_null(arr)) if arr.null_count else \
        np.zeros(n, dtype=bool)
    for i in range(n):
        if null_rows[i] or counts[i] == 0:
            out_rows.append(None)
            continue
        s, e = int(offs[i]), int(offs[i + 1])
        ests = weighted_quantiles(v[s:e], w[s:e], qs)
        out_rows.append(ests[0] if single else ests)
    if single:
        return Series.from_arrow(pa.array(out_rows, type=pa.float64()),
                                 series.name, DataType.float64())
    out = pa.array(out_rows, type=pa.large_list(pa.float64()))
    return Series.from_arrow(out, series.name,
                             DataType.list(DataType.float64()))


def percentile_estimate(series, percentiles):
    """Global approx_percentiles of one numeric Series via a single sketch:
    (value | list | None) matching the engine's approx_percentiles output."""
    from ..datatypes import DataType

    single = isinstance(percentiles, float)
    qs = [percentiles] if single else list(percentiles)
    _require_numeric(series)
    vals = series.cast(DataType.float64()).to_arrow()
    if isinstance(vals, pa.ChunkedArray):
        vals = vals.combine_chunks()
    v = np.asarray(pc.fill_null(vals, np.nan), dtype=np.float64)
    v = v[~np.isnan(v)]
    cv, cw = quantile_compress(v, np.ones(len(v)))
    ests = weighted_quantiles(cv, cw, qs)
    if single:
        return ests[0]
    return None if ests[0] is None else ests
