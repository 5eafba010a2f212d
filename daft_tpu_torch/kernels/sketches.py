"""Mergeable approximate sketches on the host: HyperLogLog, MinHash and a
quantile sketch (the port's copy of daft_tpu/kernels/sketches.py).

The HyperLogLog and quantile sketches are the math of the approximate
aggregations (``approx_count_distinct``, ``approx_percentiles``), which
decompose into a per-partition sketch, an exchange of serialized sketches
and a merge (the engine glue is ``daft_tpu_torch/sketch/``):

- ``register_ranks`` turns 64-bit hashes (``kernels/host_hash.hash_array``,
  the reference's hashes) into (register, rank) pairs; the host build, the
  grouped build and the register scatter on the card (``sketch/device.py``)
  all place these, so every path gives the same registers;
- ``estimate_from_histogram`` is Ertl's improved raw estimator over
  register-value histograms, ``estimate_from_registers`` the same over
  dense register rows;
- ``quantile_compress`` keeps a weighted sample at ``QUANTILE_CAP`` evenly
  spaced weighted ranks, deterministically, and ``weighted_quantiles``
  interpolates percentiles from it;
- ``minhash_strings`` gives per-row MinHash signatures of text.

Everything here is numpy on the host, bit for bit the reference's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import pyarrow as pa

from .host_hash import hash_array

# ---------------------------------------------------------------------------
# HyperLogLog (dense, p = 14: 16384 registers)
# ---------------------------------------------------------------------------

HLL_P = 14
HLL_M = 1 << HLL_P  # 16384 registers

#: standard error of a dense HLL with HLL_M registers (1.04/sqrt(m))
HLL_STANDARD_ERROR = 1.04 / float(HLL_M) ** 0.5


def register_ranks(hashes: np.ndarray):
    """(register index int64, rank uint8) per 64-bit hash: the scatter
    operands of a dense HLL build. The index is the top HLL_P bits, the rank
    one more than the leading zeros of the rest (a count-leading-zeros by
    halving steps, vectorized)."""
    h = hashes.astype(np.uint64, copy=False)
    idx = (h >> np.uint64(64 - HLL_P)).astype(np.int64)
    with np.errstate(over="ignore"):
        rest = (h << np.uint64(HLL_P)) | np.uint64((1 << HLL_P) - 1)
    v = rest.copy()
    cnt = np.zeros(len(h), dtype=np.uint8)
    for sbits in (32, 16, 8, 4, 2, 1):
        s = np.uint64(sbits)
        mask = (v >> np.uint64(64 - sbits)) == 0
        cnt = np.where(mask, cnt + np.uint8(sbits), cnt)
        v = np.where(mask, v << s, v)
    rank = (cnt + 1).astype(np.uint8)
    return idx, rank


_ALPHA_INF = 1.0 / (2.0 * np.log(2.0))


def _sigma(x: np.ndarray) -> np.ndarray:
    """Ertl's sigma: sum_{k>=1} x^(2^k) * 2^(k-1) + x, to a fixpoint
    (x in [0, 1); the caller handles x == 1, where it diverges)."""
    x = np.asarray(x, dtype=np.float64).copy()
    y = np.ones_like(x)
    z = x.copy()
    for _ in range(128):
        x = x * x
        z_new = z + x * y
        y = y + y
        if np.array_equal(z_new, z):
            break
        z = z_new
    return z


def _tau(x: np.ndarray) -> np.ndarray:
    """Ertl's tau: (1/3) * (1 - x - sum_{k>=1} (1 - x^(2^-k))^2 * 2^-k), to a
    fixpoint (x in [0, 1]; 0 at both ends). y halves before each term adds,
    as the published algorithm has it."""
    x = np.asarray(x, dtype=np.float64)
    ends = (x == 0.0) | (x == 1.0)
    x = np.where(ends, 0.5, x)  # keeps the square roots defined
    y = np.ones_like(x)
    z = 1.0 - x
    for _ in range(64):
        x = np.sqrt(x)
        y = y / 2.0
        z_new = z - (1.0 - x) ** 2 * y
        if np.array_equal(z_new, z):
            break
        z = z_new
    return np.where(ends, 0.0, z / 3.0)


def estimate_from_histogram(hist: np.ndarray, m: int) -> np.ndarray:
    """Cardinality estimates (uint64) from register-value histograms
    [g, q + 2] (hist[:, k]: the registers holding rank k; hist[:, 0]: the
    zero registers), by Ertl's improved raw estimator ("New cardinality
    estimation algorithms for HyperLogLog sketches", 2017), which keeps the
    relative error within 2 x 1.04/sqrt(m) over the whole range. An empty
    sketch estimates 0; one with every register saturated gives the finite
    ceiling 2^63."""
    hist = np.asarray(hist, dtype=np.float64)
    q = hist.shape[1] - 2
    mf = float(m)
    z = mf * _tau(1.0 - hist[:, q + 1] / mf)
    for k in range(q, 0, -1):
        z = 0.5 * (z + hist[:, k])
    zeros_frac = hist[:, 0] / mf
    empty = zeros_frac == 1.0
    z = z + mf * _sigma(np.where(empty, 0.0, zeros_frac))
    with np.errstate(divide="ignore"):
        est = _ALPHA_INF * mf * mf / z
    est = np.where(empty, 0.0, est)
    est = np.where(np.isfinite(est), est, float(1 << 63))
    return np.round(est).astype(np.uint64)


def estimate_from_registers(regs: np.ndarray) -> np.ndarray:
    """Cardinality estimates from dense register rows [..., HLL_M] (uint8),
    over every leading dimension at once. A register above the largest rank
    raises DaftValueError (a corrupt sketch)."""
    regs = np.asarray(regs, dtype=np.uint8)
    m = regs.shape[-1]
    flat = regs.reshape(-1, m)
    g = flat.shape[0]
    if g == 0:
        return np.zeros(regs.shape[:-1], dtype=np.uint64)
    q = 64 - HLL_P  # the largest rank is q + 1
    if int(flat.max(initial=0)) > q + 1:
        from ..errors import DaftValueError

        raise DaftValueError(
            f"corrupt HLL sketch: register value exceeds max rank {q + 1}")
    hist = np.zeros((g, q + 2), dtype=np.float64)
    np.add.at(hist, (np.repeat(np.arange(g), m),
                     flat.reshape(-1).astype(np.int64)), 1.0)
    return estimate_from_histogram(hist, m).reshape(regs.shape[:-1])


class HllSketch:
    """Dense HyperLogLog over 64-bit hashes, merged by an elementwise max."""

    __slots__ = ("registers",)

    def __init__(self, registers: Optional[np.ndarray] = None):
        self.registers = (
            np.zeros(HLL_M, dtype=np.uint8) if registers is None else registers
        )

    def add_hashes(self, hashes: np.ndarray) -> "HllSketch":
        if len(hashes) == 0:
            return self
        idx, rank = register_ranks(hashes)
        np.maximum.at(self.registers, idx, rank)
        return self

    def add_array(self, arr: pa.Array) -> "HllSketch":
        if arr.null_count:
            arr = arr.drop_null()
        if len(arr) == 0:
            return self
        return self.add_hashes(hash_array(arr))

    def merge(self, other: "HllSketch") -> "HllSketch":
        np.maximum(self.registers, other.registers, out=self.registers)
        return self

    def estimate(self) -> int:
        return int(estimate_from_registers(self.registers[None])[0])

    def to_bytes(self) -> bytes:
        return self.registers.tobytes()

    @staticmethod
    def from_bytes(b: bytes) -> "HllSketch":
        return HllSketch(np.frombuffer(b, dtype=np.uint8).copy())


# ---------------------------------------------------------------------------
# MinHash (the permutations a*x + b mod 2^61-1)
# ---------------------------------------------------------------------------

_MERSENNE = np.uint64((1 << 61) - 1)


def _perm_params(num_hashes: int, seed: int):
    """The (a, b) of the permutations a*x + b mod 2^61-1, a odd."""
    rng = np.random.RandomState(seed)
    a = rng.randint(1, 1 << 31, size=num_hashes).astype(np.uint64) * np.uint64(2) + np.uint64(1)
    b = rng.randint(0, 1 << 31, size=num_hashes).astype(np.uint64)
    return a, b


def minhash_strings(arr: pa.Array, num_hashes: int = 64, ngram_size: int = 1,
                    seed: int = 1) -> pa.Array:
    """Per-row MinHash signatures of space-separated text (word ngrams; a
    row with fewer words than ``ngram_size`` hashes as one gram)."""
    a, b = _perm_params(num_hashes, seed)
    out_sigs: List[Optional[List[int]]] = []
    for v in arr.to_pylist():
        if v is None:
            out_sigs.append(None)
            continue
        words = v.split(" ")
        if len(words) >= ngram_size:
            grams = [" ".join(words[i:i + ngram_size]) for i in range(len(words) - ngram_size + 1)]
        else:
            grams = [v]
        gh = hash_array(pa.array(grams, type=pa.large_string())).astype(np.uint64)
        with np.errstate(over="ignore"):
            sig = (gh[:, None] * a[None, :] + b[None, :]) % _MERSENNE
        out_sigs.append((sig.min(axis=0) & np.uint64(0xFFFFFFFF)).astype(np.uint32).tolist())
    return pa.array(out_sigs, type=pa.list_(pa.uint32(), num_hashes))


# ---------------------------------------------------------------------------
# Quantile sketch: a bounded, mergeable weighted sample
# ---------------------------------------------------------------------------

#: default sample bound; a compressed summary's rank error is about 1/cap
QUANTILE_CAP = 4096


def quantile_compress(values: np.ndarray, weights: np.ndarray,
                      cap: int = QUANTILE_CAP):
    """A weighted sample cut to at most ``cap`` points, deterministically:
    sorted by value, the points at ``cap`` evenly spaced weighted ranks,
    each carrying total/cap of the weight. The same partitions give the same
    estimates on every run."""
    if len(values) <= cap:
        return values, weights
    order = np.argsort(values, kind="stable")
    v = values[order]
    w = weights[order]
    total = w.sum()
    cum = np.cumsum(w) - w / 2.0
    targets = (np.arange(cap) + 0.5) / cap * total
    idx = np.clip(np.searchsorted(cum, targets), 0, len(v) - 1)
    return v[idx], np.full(cap, total / cap)


def weighted_quantiles(values: np.ndarray, weights: np.ndarray,
                       qs: Sequence[float]):
    """Interpolated quantiles of a weighted sample (midpoint rank rule);
    [None] * len(qs) for an empty sample."""
    if len(values) == 0:
        return [None for _ in qs]
    order = np.argsort(values, kind="stable")
    v = values[order]
    w = weights[order]
    cum = np.cumsum(w)
    cum = (cum - w / 2.0) / w.sum()
    return [float(np.interp(q, cum, v)) for q in qs]


def quantile_state_to_bytes(values: np.ndarray, weights: np.ndarray,
                            cap: int = QUANTILE_CAP) -> bytes:
    """The serialized state, little-endian: uint32 cap, uint32 k, k float64
    values, k float64 weights (the binary payload the exchange ships)."""
    k = len(values)
    head = np.array([cap, k], dtype="<u4").tobytes()
    return (head + np.ascontiguousarray(values, dtype="<f8").tobytes()
            + np.ascontiguousarray(weights, dtype="<f8").tobytes())


def quantile_state_from_bytes(b: bytes):
    """(values, weights, cap) of quantile_state_to_bytes's output."""
    cap, k = np.frombuffer(b, dtype="<u4", count=2)
    vals = np.frombuffer(b, dtype="<f8", count=int(k), offset=8).copy()
    wts = np.frombuffer(b, dtype="<f8", count=int(k),
                        offset=8 + 8 * int(k)).copy()
    return vals, wts, int(cap)


class QuantileSketch:
    """A mergeable quantile sketch: a weighted sample of at most ``cap``
    points, accurate to about 1/cap in rank. Its compression is
    deterministic, so an estimate depends on the merge order only within
    that rank error."""

    __slots__ = ("values", "weights", "cap")

    def __init__(self, cap: int = QUANTILE_CAP, values=None, weights=None):
        self.cap = cap
        self.values = np.empty(0, dtype=np.float64) if values is None else values
        self.weights = np.empty(0, dtype=np.float64) if weights is None else weights

    def add(self, vals: np.ndarray) -> "QuantileSketch":
        vals = np.asarray(vals, dtype=np.float64)
        vals = vals[~np.isnan(vals)]
        if len(vals) == 0:
            return self
        self.values = np.concatenate([self.values, vals])
        self.weights = np.concatenate([self.weights, np.ones(len(vals))])
        self._compress()
        return self

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        self.values = np.concatenate([self.values, other.values])
        self.weights = np.concatenate([self.weights, other.weights])
        self._compress()
        return self

    def _compress(self) -> None:
        self.values, self.weights = quantile_compress(
            self.values, self.weights, self.cap)

    def quantiles(self, qs: Sequence[float]):
        return weighted_quantiles(self.values, self.weights, qs)

    def to_bytes(self) -> bytes:
        return quantile_state_to_bytes(self.values, self.weights, self.cap)

    @staticmethod
    def from_bytes(b: bytes) -> "QuantileSketch":
        vals, wts, cap = quantile_state_from_bytes(b)
        return QuantileSketch(cap, vals, wts)
