"""Vectorized 64-bit hashing of Arrow arrays on the host (the port's copy of
daft_tpu/kernels/host_hash.py, numpy route only).

Fixed-width columns hash via a splitmix64-style finalizer over the raw value
buffer; var-len (string/binary) columns use a vectorized 64-bit polynomial
rolling hash over the flattened byte buffer with `np.add.reduceat` segment
reduction, then the same finalizer. Multi-column hashes chain the seed across
columns (h = hash(col, seed=h_prev)). The bits equal the reference's, so a
hash shuffle puts every row in the reference's bucket.

Used here for hash partitioning (ShuffleOp). The reference also calls its
compiled `native` module when that is built; the port has no native module
yet, so every path takes numpy, which gives the same bits.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)
_NULL_HASH = np.uint64(0x7FB5D329728EA185)
_POLY_P = np.uint64(0x100000001B3)  # FNV prime reused as polynomial base


def _splitmix64(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        x = (x + _GOLDEN).astype(np.uint64)
        x = (x ^ (x >> np.uint64(30))) * _MIX1
        x = (x ^ (x >> np.uint64(27))) * _MIX2
        x = x ^ (x >> np.uint64(31))
    return x


def hash_array(arr: pa.Array, seed: np.ndarray | int | None = None) -> np.ndarray:
    """Hash an arrow array to uint64 per row. `seed` may be a scalar or per-row array
    (used to combine hashes across columns: h = hash(col, seed=h_prev))."""
    n = len(arr)
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if seed is None:
        seeds = np.zeros(n, dtype=np.uint64)
    elif np.isscalar(seed):
        seeds = np.full(n, np.uint64(seed), dtype=np.uint64)
    else:
        seeds = seed.astype(np.uint64, copy=False)

    t = arr.type
    if pa.types.is_null(t):
        base = np.full(n, _NULL_HASH, dtype=np.uint64)
        return _splitmix64(base ^ seeds)
    if pa.types.is_dictionary(t):
        arr = arr.cast(t.value_type)
        t = arr.type

    if pa.types.is_boolean(t):
        vals = arr.cast(pa.uint8())
        return _hash_fixed(vals, seeds)
    if pa.types.is_decimal(t):
        return _hash_decimal128(arr, seeds)
    if (
        pa.types.is_integer(t) or pa.types.is_floating(t)
        or pa.types.is_date(t) or pa.types.is_timestamp(t)
        or pa.types.is_time(t) or pa.types.is_duration(t)
    ):
        return _hash_fixed(arr, seeds)
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        arr = arr.cast(pa.large_binary())
        t = arr.type
    if pa.types.is_binary(t) or pa.types.is_large_binary(t):
        return _hash_varlen(arr, seeds)
    if pa.types.is_fixed_size_binary(t):
        arr = arr.cast(pa.large_binary())
        return _hash_varlen(arr, seeds)
    if pa.types.is_list(t) or pa.types.is_large_list(t) or pa.types.is_fixed_size_list(t):
        # NB: use .values (keeps slots behind null rows), never .flatten() (drops them,
        # which would desync offsets for every row after a null).
        if pa.types.is_fixed_size_list(t):
            size = t.list_size
            offs = (np.arange(n + 1, dtype=np.int64) + arr.offset) * size
            child = arr.values
        else:
            offs = np.asarray(arr.offsets).astype(np.int64)
            child = arr.values
        lo, hi = int(offs[0]), int(offs[-1])
        inner = hash_array(child.slice(lo, hi - lo)) if hi > lo else np.empty(0, np.uint64)
        return _hash_segments_from_offsets(arr, offs - lo, inner, seeds, n)
    if pa.types.is_struct(t):
        h = seeds
        for i in range(t.num_fields):
            h = hash_array(arr.field(i), seed=h)
        return _apply_null_mask(arr, h, seeds)
    raise ValueError(f"cannot hash arrow type {t}")


def _valid_mask(arr: pa.Array) -> np.ndarray | None:
    if arr.null_count == 0:
        return None
    return np.asarray(pc.is_valid(arr), dtype=bool)


def _apply_null_mask(arr: pa.Array, h: np.ndarray, seeds: np.ndarray) -> np.ndarray:
    m = _valid_mask(arr)
    if m is not None:
        h = np.where(m, h, _splitmix64(_NULL_HASH ^ seeds))
    return h


def _hash_fixed(arr: pa.Array, seeds: np.ndarray) -> np.ndarray:
    t = arr.type
    if pa.types.is_floating(t):
        vals = np.nan_to_num(_values_np(arr).astype(np.float64), nan=0.0)
        # normalize -0.0 == 0.0
        vals = vals + 0.0
        bits = vals.view(np.uint64)
    else:
        bits = _values_np(arr).astype(np.int64, copy=False).view(np.uint64)
    h = _splitmix64(bits ^ seeds)
    return _apply_null_mask(arr, h, seeds)


def _values_np(arr: pa.Array) -> np.ndarray:
    """Physical values of a primitive arrow array as numpy (nulls filled
    arbitrarily). Temporal storage casts to its integer physical type
    BEFORE the null fill: pyarrow has no int->date32 scalar cast, so
    filling a nullable date column first crashed every hash
    shuffle/join/filter keyed on it (caught by the exchange byte-identity
    matrix)."""
    if pa.types.is_date32(arr.type):
        arr = arr.cast(pa.int32())
    elif pa.types.is_date64(arr.type):
        arr = arr.cast(pa.int64())
    elif pa.types.is_timestamp(arr.type) or pa.types.is_duration(arr.type):
        arr = arr.cast(pa.int64())
    elif pa.types.is_time(arr.type):
        arr = arr.cast(pa.int64() if arr.type.bit_width == 64 else pa.int32())
    if arr.null_count:
        arr = pc.fill_null(arr, _zero_scalar(arr.type))
    return np.asarray(arr)


def _zero_scalar(t: pa.DataType):
    if pa.types.is_timestamp(t) or pa.types.is_duration(t) or pa.types.is_time(t) or pa.types.is_date(t):
        return pa.scalar(0, pa.int64()).cast(t)
    return pa.scalar(0, t) if not pa.types.is_boolean(t) else pa.scalar(False, t)


def _offsets_and_bytes(arr: pa.Array):
    t = arr.type
    assert pa.types.is_large_binary(t) or pa.types.is_binary(t)
    if arr.null_count:
        arr = pc.fill_null(arr, b"")
    buffers = arr.buffers()
    off_dtype = np.int64 if pa.types.is_large_binary(t) else np.int32
    offs = np.frombuffer(buffers[1], dtype=off_dtype, count=len(arr) + 1 + arr.offset)[arr.offset:]
    data = np.frombuffer(buffers[2], dtype=np.uint8) if buffers[2] is not None else np.empty(0, np.uint8)
    return offs.astype(np.int64, copy=False), data, arr


def _hash_varlen(orig: pa.Array, seeds: np.ndarray) -> np.ndarray:
    n = len(orig)
    offs, data, filled = _offsets_and_bytes(orig if not isinstance(orig, pa.ChunkedArray) else orig.combine_chunks())
    lengths = offs[1:] - offs[:-1]
    start, end = offs[0], offs[-1]
    seg = data[start:end].astype(np.uint64)
    if len(seg):
        # position of each byte within its row
        row_of_byte = np.repeat(np.arange(n, dtype=np.int64), lengths)
        pos = np.arange(len(seg), dtype=np.int64) - (offs[:-1] - start)[row_of_byte]
        with np.errstate(over="ignore"):
            weights = np.power(_POLY_P, pos.astype(np.uint64))
            terms = (seg + np.uint64(1)) * weights
        sums = _segment_sums(terms, offs[:-1] - start, lengths, n)
    else:
        sums = np.zeros(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        h = _splitmix64(sums ^ (np.uint64(0xC2B2AE3D27D4EB4F) * lengths.astype(np.uint64)) ^ seeds)
    return _apply_null_mask(orig, h, seeds)


def _segment_sums(terms: np.ndarray, starts: np.ndarray, lengths: np.ndarray, n: int) -> np.ndarray:
    """Per-row sums of `terms` segmented by (starts, lengths); empty rows sum to 0.

    `np.add.reduceat` mishandles empty segments (it returns terms[idx] and, when
    clamped, corrupts the previous row), so reduce only over non-empty rows — their
    start offsets are strictly increasing and cover the byte buffer contiguously.
    """
    sums = np.zeros(n, dtype=np.uint64)
    nz = lengths > 0
    if nz.any():
        with np.errstate(over="ignore"):
            sums[nz] = np.add.reduceat(terms, starts[nz])
    return sums


def _hash_decimal128(arr: pa.Array, seeds: np.ndarray) -> np.ndarray:
    """Hash decimals exactly from their little-endian two's-complement representation
    (the reference hashes decimals by value, not via a lossy float cast). Narrow
    decimals are widened to decimal128 so equal values hash equally across widths;
    decimal256 folds its four uint64 lanes."""
    t = arr.type
    if t.byte_width < 16:
        arr = arr.cast(pa.decimal128(t.precision, t.scale))
        t = arr.type
    filled = pc.fill_null(arr, pa.scalar(0, t).cast(t)) if arr.null_count else arr
    n = len(filled)
    lanes_per = t.byte_width // 8
    lanes = np.frombuffer(filled.buffers()[1], dtype=np.uint64, count=lanes_per * (n + filled.offset))
    lanes = lanes[lanes_per * filled.offset:]
    with np.errstate(over="ignore"):
        h = seeds
        for i in range(lanes_per - 1, -1, -1):
            h = _splitmix64(lanes[i::lanes_per] ^ h)
    return _apply_null_mask(arr, h, seeds)


def _hash_segments_from_offsets(
    arr: pa.Array, offs: np.ndarray, inner_hashes: np.ndarray, seeds: np.ndarray, n: int
) -> np.ndarray:
    lengths = offs[1:] - offs[:-1]
    if len(inner_hashes):
        pos = np.arange(len(inner_hashes), dtype=np.int64) - np.repeat(offs[:-1], lengths)
        with np.errstate(over="ignore"):
            terms = inner_hashes * np.power(_POLY_P, pos.astype(np.uint64))
        sums = _segment_sums(terms, offs[:-1], lengths, n)
    else:
        sums = np.zeros(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        h = _splitmix64(sums ^ lengths.astype(np.uint64) ^ seeds)
    return _apply_null_mask(arr, h, seeds)


def hash_table_columns(columns: list, seed: int = 0) -> np.ndarray:
    """Combined row hash across multiple arrow arrays."""
    if not columns:
        raise ValueError("need at least one column to hash")
    h = np.full(len(columns[0]), np.uint64(seed), dtype=np.uint64)
    for c in columns:
        h = hash_array(c, seed=h)
    return h
