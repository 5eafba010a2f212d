"""MurmurHash3 x86 32-bit on the host, for the Iceberg bucket transform (the
port's copy of daft_tpu/kernels/murmur.py).

Matches the Iceberg spec's bucket hashing: integers hash as 8 little-endian
bytes, dates as their int32 day count widened the same way, timestamps and
times as their int64 ticks, strings and binary as their bytes, seed 0. Fixed
widths are vectorized with numpy. Strings and binary take a per-value loop
over python integers (the reference calls its compiled module there when it
is built; the bits are the same).
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

_C1 = np.uint32(0xCC9E2D51)
_C2 = np.uint32(0x1B873593)
_M32 = 0xFFFFFFFF


def _rotl32(x: np.ndarray, r: int) -> np.ndarray:
    r = np.uint32(r)
    with np.errstate(over="ignore"):
        return (x << r) | (x >> (np.uint32(32) - r))


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _mix_k(k: int) -> int:
    k = (k * 0xCC9E2D51) & _M32
    k = _rotl(k, 15)
    return (k * 0x1B873593) & _M32


def _mm3_scalar_bytes(data: bytes) -> int:
    """murmur3_32 of one byte string, seed 0, as a signed int32."""
    h = 0
    n = len(data)
    nblocks = n // 4
    for i in range(nblocks):
        h ^= _mix_k(int.from_bytes(data[i * 4:i * 4 + 4], "little"))
        h = _rotl(h, 13)
        h = (h * 5 + 0xE6546B64) & _M32
    tail = data[nblocks * 4:]
    if tail:
        k = 0
        if len(tail) >= 3:
            k ^= tail[2] << 16
        if len(tail) >= 2:
            k ^= tail[1] << 8
        k ^= tail[0]
        h ^= _mix_k(k)
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    h ^= h >> 16
    return h - (1 << 32) if h & 0x80000000 else h


def _mm3_long_vec(vals: np.ndarray) -> np.ndarray:
    """Vectorized murmur3_32 of int64 values encoded as 8 little-endian bytes."""
    v = vals.astype(np.int64).view(np.uint64)
    k1 = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    k2 = (v >> np.uint64(32)).astype(np.uint32)
    with np.errstate(over="ignore"):
        h = np.zeros(len(vals), dtype=np.uint32)
        for k in (k1, k2):
            k = (k * _C1).astype(np.uint32)
            k = _rotl32(k, 15)
            k = (k * _C2).astype(np.uint32)
            h ^= k
            h = _rotl32(h, 13)
            h = (h * np.uint32(5) + np.uint32(0xE6546B64)).astype(np.uint32)
        h ^= np.uint32(8)
        h ^= h >> np.uint32(16)
        h = (h * np.uint32(0x85EBCA6B)).astype(np.uint32)
        h ^= h >> np.uint32(13)
        h = (h * np.uint32(0xC2B2AE35)).astype(np.uint32)
        h ^= h >> np.uint32(16)
    return h.view(np.int32)


def murmur3_32_arrow(arr: pa.Array) -> pa.Array:
    """int32 murmur3 of every value of ``arr``; nulls stay null."""
    t = arr.type
    if pa.types.is_date32(t):
        return murmur3_32_arrow(arr.cast(pa.int32()))
    if pa.types.is_timestamp(t) or pa.types.is_time(t):
        return murmur3_32_arrow(arr.cast(pa.int64()))
    if (pa.types.is_string(t) or pa.types.is_large_string(t) or pa.types.is_binary(t)
            or pa.types.is_large_binary(t)):
        out = [None if v is None else _mm3_scalar_bytes(v.encode() if isinstance(v, str) else bytes(v))
               for v in arr.to_pylist()]
        return pa.array(out, type=pa.int32())
    if not pa.types.is_integer(t):
        raise ValueError(f"murmur3_32 unsupported for {t}")
    filled = pc.fill_null(arr, 0) if arr.null_count else arr
    res = pa.array(_mm3_long_vec(np.asarray(filled.cast(pa.int64()))), type=pa.int32())
    if arr.null_count:
        res = pc.if_else(pc.is_valid(arr), res, pa.nulls(len(res), pa.int32()))
    return res
