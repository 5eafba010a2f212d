"""Runtime join filters: sideways information passing across the exchange
(the port's copy of daft_tpu/exchange/joinfilter.py).

A co-partitioned hash join shuffles both sides' rows even when the build
side is selective. This module builds a Bloom + min-max filter from the
build side's join keys while they stream through their own exchange, and
the probe side's ShuffleOp (or the BroadcastJoinOp's probe stream) prunes
rows that cannot match before bucketing.

- The filter only ever keeps extra rows; the join re-checks every row it
  keeps, so results never depend on it. Hashes are computed over key
  columns cast to the dtype the join's key alignment unifies them to, NaN
  float keys bypass the filter, and null keys are pruned only for join
  types where a null probe key never reaches the output.
- Pruning drops whole rows before the row-local bucket split, so the rows
  kept keep their order, and the results equal those with
  ``runtime_join_filters`` off.
- The Bloom probe (K10, ``probe_bits_device``) runs on the card when
  device kernels are on and the partition has at least ``device_min_rows``
  rows: a gather of the k bit positions of each row and a min over them,
  exact in torch, so no hand-written kernel is needed. Otherwise numpy
  probes on the host.
- Fail-open: a failed build feed or seal abandons the filter and a failed
  prune ships its partition unpruned (``join_filter_errors``; the
  ``join.filter`` fault site fires at each feed and each prune), so the
  exchange runs unfiltered and the rows are unchanged. A
  ``DaftKernelError`` or a CUDA error reaches the caller.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .. import faults
from ..errors import PORT_FAILURES, DaftInternalError

# Bloom geometry: bits = next_pow2(rows * BITS_PER_KEY) clamped to
# [MIN_BITS, MAX_BITS]; PROBES probes per key by Kirsch-Mitzenmacher double
# hashing (h1 + i*h2): about a 2.4% false-positive rate
BLOOM_BITS_PER_KEY = 8
BLOOM_PROBES = 4
BLOOM_MIN_BITS = 1 << 13
BLOOM_MAX_BITS = 1 << 23
# a build side past this many rows abandons the filter
MAX_BUILD_ROWS = 1 << 22

# second hash seed, for the probe stride
_H2_SEED = 0x9E3779B97F4A7C15

# join types whose PROBE side may be pruned, by (how, probe_is_right):
# inner/semi either side; left only the right side; right/anti/outer never
# (the probe side's unmatched rows are output)
PRUNABLE = {("inner", True), ("inner", False),
            ("semi", True), ("semi", False),
            ("left", True)}


def prunable(how: str, probe_is_right: bool) -> bool:
    """Whether the probe side of a ``how`` join may be pruned by a filter
    built from the other side's keys (see PRUNABLE)."""
    return (how, probe_is_right) in PRUNABLE


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _unified_key_dtypes(build_on, probe_on, build_schema, probe_schema):
    """The dtypes the join aligns each key pair to, or None when a pair
    cannot unify or is python-typed: both sides must hash one
    representation, or one value could hash to two patterns (a wrong
    prune)."""
    from ..datatypes import try_unify

    out = []
    for be, pe in zip(build_on, probe_on):
        try:
            bdt = be._node.to_field(build_schema).dtype
            pdt = pe._node.to_field(probe_schema).dtype
        except (ValueError, KeyError):
            return None
        u = try_unify(bdt, pdt)
        if u is None or u.is_python():
            return None
        out.append(u)
    return out


def _key_arrays(tbl, key_exprs, dtypes):
    """The key expressions over one table, cast to the unified dtypes, as
    arrow arrays."""
    from ..table import _broadcast_series

    cols = []
    for e, dt in zip(key_exprs, dtypes):
        s = e._node.evaluate(tbl)
        if s.is_python():
            raise DaftInternalError("python-typed join key in the filter path")
        if len(s) != len(tbl):
            s = _broadcast_series(s, len(tbl))  # a literal key
        if s.dtype != dt:
            s = s.cast(dt)
        cols.append(s.to_arrow())
    return cols


def _hash_pair(cols) -> Tuple[np.ndarray, np.ndarray]:
    """(h1, h2) uint64 row hashes over the unified key columns: h1 seeded
    with 0 (the bucket hash's family), h2 with an independent constant."""
    from ..kernels.host_hash import hash_table_columns

    return hash_table_columns(cols, seed=0), hash_table_columns(cols, seed=_H2_SEED)


class RuntimeJoinFilter:
    """A sealed Bloom + min-max filter over build-side keys."""

    __slots__ = ("table", "nbits", "minmax", "dtypes", "build_rows", "_device_bits")

    def __init__(self, table: np.ndarray, minmax: List[Optional[Tuple[Any, Any]]],
                 dtypes, build_rows: int):
        self.table = table  # bool[nbits], nbits a power of two
        self.nbits = len(table)
        self.minmax = minmax  # per key column: (lo, hi) or None
        self.dtypes = dtypes
        self.build_rows = build_rows
        self._device_bits = None  # the bit table on the card, staged once

    def keep_mask(self, tbl, key_exprs, ctx=None) -> np.ndarray:
        """Boolean keep-mask over ``tbl``'s rows: a False row cannot match
        any build-side key (but for the NaN bypass). ``ctx`` (an
        ExecutionContext) routes the Bloom probe to the card when
        eligible."""
        import pyarrow as pa
        import pyarrow.compute as pc

        n = len(tbl)
        if n == 0:
            return np.zeros(0, dtype=bool)
        cols = _key_arrays(tbl, key_exprs, self.dtypes)
        valid = np.ones(n, dtype=bool)
        bypass = np.zeros(n, dtype=bool)
        rng_ok = np.ones(n, dtype=bool)
        for arr, mm in zip(cols, self.minmax):
            if arr.null_count:
                valid &= np.asarray(pc.is_valid(arr), dtype=bool)
            if pa.types.is_floating(arr.type):
                # NaN keys: their bit patterns cannot be trusted to hash alike
                nanmask = pc.is_nan(arr)
                if arr.null_count:
                    nanmask = pc.fill_null(nanmask, False)
                bypass |= np.asarray(nanmask, dtype=bool)
            elif mm is not None:
                lo, hi = mm
                inr = pc.and_kleene(pc.greater_equal(arr, pa.scalar(lo, type=arr.type)),
                                    pc.less_equal(arr, pa.scalar(hi, type=arr.type)))
                rng_ok &= np.asarray(pc.fill_null(inr, False), dtype=bool)
        h1, h2 = _hash_pair(cols)
        hit = self._bloom_hits(h1, h2, ctx)
        # null keys never match for the prunable join types; NaN bypasses
        return valid & (bypass | (hit & rng_ok))

    def _bloom_hits(self, h1: np.ndarray, h2: np.ndarray, ctx) -> np.ndarray:
        mask = np.uint64(self.nbits - 1)
        idx = np.empty((BLOOM_PROBES, len(h1)), dtype=np.int32)
        h = h1.copy()
        for i in range(BLOOM_PROBES):
            idx[i] = (h & mask).astype(np.int32)
            h += h2
        dev = self._bloom_hits_device(idx, ctx)
        if dev is not None:
            return dev
        out = self.table[idx[0]]
        for i in range(1, BLOOM_PROBES):
            out &= self.table[idx[i]]
        return out

    def _bloom_hits_device(self, idx: np.ndarray, ctx) -> Optional[np.ndarray]:
        """The Bloom probe on the card (``probe_bits_device``) as one device
        attempt (``ExecutionContext._device_attempt``), or None when device
        kernels are off, the partition is under ``device_min_rows`` or the
        attempt failed (one of ``execution.DEVICE_FAILURES``, counted
        against the breaker): the host probes then. Any other exception
        reaches ``prune_partition``'s fail-open, which re-raises a
        ``DaftKernelError`` or CUDA error."""
        if ctx is None or not ctx.cfg.use_device_kernels:
            return None
        if idx.shape[1] < ctx.cfg.device_min_rows:
            return None
        from ..kernels.device import resolve_device

        out = ctx._device_attempt(
            lambda: probe_bits_device(self._staged_bits(resolve_device(ctx.cfg)), idx))
        if out is not None:
            ctx.stats.bump("join_filter_device_probes")
        return out

    def _staged_bits(self, device) -> torch.Tensor:
        """The bit table as a uint8 tensor on ``device``, staged once."""
        if self._device_bits is None or self._device_bits.device != device:
            self._device_bits = torch.from_numpy(self.table.astype(np.uint8)).to(device)
        return self._device_bits


def probe_bits_device(bits: torch.Tensor, idx: np.ndarray) -> np.ndarray:
    """K10, the Bloom membership of each row on ``bits``' device: gather
    the k probe positions of every row from the uint8 bit table, take their
    min (the AND of k bits) and fetch the bool mask."""
    ix = torch.from_numpy(idx).to(bits.device).long()
    return bits[ix].amin(dim=0).bool().cpu().numpy()


def prune_partition(part, jf: RuntimeJoinFilter, key_exprs, ctx):
    """One probe-side partition pruned by a sealed filter (the partition
    itself when nothing is pruned). Fail-open: on a failure (the
    ``join.filter`` fault site among them) the input partition itself,
    counted as ``join_filter_errors``; a ``DaftKernelError`` or CUDA error
    from K10 reaches the caller. Counters: ``join_filter_probe_rows`` (rows
    inspected) and ``join_filter_rows_pruned`` (rows dropped)."""
    from ..micropartition import MicroPartition
    from ..series import Series

    try:
        faults.check("join.filter", ctx.stats)
        kept, before, after = [], 0, 0
        for t in part.chunk_tables():
            nt = len(t)
            before += nt
            if nt == 0:
                continue
            mask = jf.keep_mask(t, key_exprs, ctx)
            if mask.all():
                kept.append(t)
                after += nt
                continue
            ft = t.filter_with_mask(Series.from_numpy(mask, "keep"))
            after += len(ft)
            if len(ft):
                kept.append(ft)
    except PORT_FAILURES:
        raise
    except Exception:
        ctx.stats.bump("join_filter_errors")
        return part
    ctx.stats.bump("join_filter_probe_rows", before)
    if before != after:
        ctx.stats.bump("join_filter_rows_pruned", before - after)
    if after == before:
        return part
    out = MicroPartition(part.schema, kept) if kept else MicroPartition.empty(part.schema)
    return out.derived_from(part)


class JoinFilterBuilder:
    """Accumulates build-side key batches; ``seal()`` freezes the filter.
    The hashes are kept per batch and the bit table is sized once the build
    row count is known; past MAX_BUILD_ROWS the builder abandons (``seal``
    returns None)."""

    def __init__(self, key_exprs, dtypes):
        self.key_exprs = list(key_exprs)
        self.dtypes = list(dtypes)
        self._h1: List[np.ndarray] = []
        self._h2: List[np.ndarray] = []
        self._minmax: List[Optional[Tuple[Any, Any]]] = [None] * len(dtypes)
        self._mm_dead: List[bool] = [False] * len(dtypes)
        self._rows = 0
        self._abandoned = False

    def add(self, tbl) -> None:
        """Fold one build-side table's keys into the filter state."""
        import pyarrow as pa
        import pyarrow.compute as pc

        if self._abandoned or len(tbl) == 0:
            return
        self._rows += len(tbl)
        if self._rows > MAX_BUILD_ROWS:
            self._abandoned = True
            self._h1.clear()
            self._h2.clear()
            return
        cols = _key_arrays(tbl, self.key_exprs, self.dtypes)
        h1, h2 = _hash_pair(cols)
        self._h1.append(h1)
        self._h2.append(h2)
        for j, arr in enumerate(cols):
            if self._mm_dead[j] or pa.types.is_floating(arr.type):
                # a float min-max would have to order NaN; the Bloom covers floats
                self._mm_dead[j] = True
                continue
            if arr.null_count == len(arr):
                continue
            try:
                mm = pc.min_max(arr)
            except pa.ArrowNotImplementedError:
                self._mm_dead[j] = True  # a type with no min/max kernel
                continue
            lo, hi = mm["min"].as_py(), mm["max"].as_py()
            cur = self._minmax[j]
            self._minmax[j] = (lo, hi) if cur is None else (min(cur[0], lo), max(cur[1], hi))

    def seal(self) -> Optional[RuntimeJoinFilter]:
        if self._abandoned:
            return None
        nbits = min(_next_pow2(max(self._rows * BLOOM_BITS_PER_KEY, BLOOM_MIN_BITS)),
                    BLOOM_MAX_BITS)
        table = np.zeros(nbits, dtype=bool)
        mask = np.uint64(nbits - 1)
        for h1, h2 in zip(self._h1, self._h2):
            h = h1.copy()
            for _ in range(BLOOM_PROBES):
                table[(h & mask).astype(np.int64)] = True
                h += h2
        minmax = [None if dead else mm for mm, dead in zip(self._minmax, self._mm_dead)]
        return RuntimeJoinFilter(table, minmax, self.dtypes, self._rows)


class JoinFilterSlot:
    """The rendezvous, made at translate time, of the build side's exchange
    and the probe side's: the build-side ShuffleOp feeds every streamed
    partition into a builder and seals once its input ends (the join op
    drains the build side before the probe side's exchange runs); the
    probe-side ShuffleOp asks ``filter()`` and prunes when a sealed filter
    exists. Unsealed or abandoned: None, and the probe runs unfiltered."""

    def __init__(self, build_on, probe_on, build_schema, probe_schema, how: str):
        self.build_on = list(build_on)
        self.probe_on = list(probe_on)
        self.how = how
        self.dtypes = _unified_key_dtypes(build_on, probe_on, build_schema, probe_schema)
        self._builder: Optional[JoinFilterBuilder] = None
        self._filter: Optional[RuntimeJoinFilter] = None
        self._sealed = False

    @property
    def eligible(self) -> bool:
        return self.dtypes is not None

    def begin(self) -> None:
        """Reset for an execution of the build side."""
        self._builder = JoinFilterBuilder(self.build_on, self.dtypes) if self.eligible else None
        self._filter = None
        self._sealed = False

    def feed(self, tbl) -> None:
        if self._builder is not None:
            self._builder.add(tbl)

    def abandon(self) -> None:
        self._builder = None
        self._filter = None
        self._sealed = True

    def seal(self) -> None:
        if self._builder is not None:
            self._filter = self._builder.seal()
            self._builder = None
        self._sealed = True

    def filter(self) -> Optional[RuntimeJoinFilter]:
        return self._filter if self._sealed else None
