"""Executor: runs a physical plan as a tree of partition generators (the
port's copy of the part of daft_tpu/execution.py this slice runs).

The device path has no silent fallback. An exception raised on the card
propagates to the caller. Only the reference's documented declines send a
partition to the host path: for an aggregation, a partition below
``device_min_rows`` (stage 2 of a two-stage aggregate over a few partial
rows takes it) or an ineligible plan or dtype (count_distinct among them),
plain routing that is not counted, as in the reference, and the int32
overflow guard of ``device_agg._finish_agg``, counted as
``device_agg_fallbacks``; for a fused map chain, a device program that
declines the partition (not counted, as in the reference: the chain runs
on the host, ``host_fused_maps``); for a plan segment, a resident attempt
that declines (``segment_fallbacks``, then the staged ops); for a join, an
ineligible pair (a join type other than inner/left/semi/anti, both sides
below ``device_min_rows``, a key that is not an integer or date expression,
an overflowing composite key space), counted as ``host_joins``; for a sort,
a partition below ``device_min_rows`` or an ineligible key, counted as
``host_sorts``; for a single filter, projection or distinct, a partition
below ``device_min_rows`` or an expression, key or dtype the device layer
declines (a missing dictionary, the int64 wrap guard, a nullable multi-key
distinct), counted as ``host_filters``, ``host_projections`` or
``host_distincts``.

Left out of this slice: the DeviceHealth breaker and fault injection (and
with them the reference's catch of a failure in the resolvers of fused
maps, plan segments, single filters and projections and in the join probe,
each of which sends the failed partition to the host), the profiler, spill,
deadlines and cancellation, the worker pool, streaming, the mesh hook
``prepare_broadcast`` and resource accounting.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterator

from .context import ExecutionConfig
from .micropartition import MicroPartition
from .physical import PhysicalOp


class RuntimeStats:
    """Per-query counters plus per-operator rows and wall time."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {}
        self.op_rows: Dict[str, int] = {}
        self.op_wall_ns: Dict[str, int] = {}

    def bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counters[key] = self.counters.get(key, 0) + n

    def bump_max(self, key: str, n: int) -> None:
        """High-water counter: the stored value only ratchets up to ``n``."""
        with self._lock:
            if n > self.counters.get(key, 0):
                self.counters[key] = n

    def record_op(self, name: str, rows: int, wall_ns: int) -> None:
        with self._lock:
            self.op_rows[name] = self.op_rows.get(name, 0) + rows
            self.op_wall_ns[name] = self.op_wall_ns.get(name, 0) + wall_ns

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "op_rows": dict(self.op_rows),
                "op_wall_ns": dict(self.op_wall_ns),
            }


class ExecutionContext:
    def __init__(self, cfg: ExecutionConfig, stats: RuntimeStats):
        self.cfg = cfg
        self.stats = stats

    def _device_eligible(self, part: MicroPartition) -> bool:
        return self.cfg.use_device_kernels and len(part) >= self.cfg.device_min_rows

    def eval_sort(self, part: MicroPartition, sort_by, descending=None,
                  nulls_first=None) -> MicroPartition:
        """A partition's sort through the device argsort when eligible (the
        keys compile and sort on the card, the payload take runs on the
        host), the host pyarrow sort otherwise."""
        if self._device_eligible(part):
            import numpy as np

            from .kernels.device import device_table_argsort, resolve_device
            from .series import Series

            idx = device_table_argsort(part.table(), sort_by, descending, nulls_first,
                                       stage_cache=part.device_stage_cache(),
                                       device=resolve_device(self.cfg))
            if idx is not None:
                self.stats.bump("device_sorts")
                return MicroPartition.from_table(
                    part.table().take(Series.from_numpy(idx.astype(np.uint64), "indices")))
        self.stats.bump("host_sorts")
        return part.sort(sort_by, descending, nulls_first)

    # ------------------------------------------------- single filters and maps
    def _launch_projection(self, part: MicroPartition, exprs):
        """Stage the partition's columns and launch the projection program
        now; a zero-arg resolver that fetches the output Table, or None when
        the partition is not device-eligible or the device layer declines
        it. A failure on the card propagates from the resolver."""
        if not self._device_eligible(part):
            return None
        from .kernels.device import eval_projection_device_async, resolve_device

        return eval_projection_device_async(
            part.table(), list(exprs), stage_cache=part.device_stage_cache(),
            device=resolve_device(self.cfg))

    def eval_projection(self, part: MicroPartition, exprs) -> MicroPartition:
        """A projection on the card when eligible, else on the host."""
        resolve = self._launch_projection(part, exprs)
        if resolve is not None:
            self.stats.bump("device_projections")
            return MicroPartition.from_table(resolve())
        self.stats.bump("host_projections")
        return part.eval_expression_list(exprs)

    def eval_projection_dispatch(self, part: MicroPartition, exprs):
        """Launch a device projection without blocking; returns a zero-arg
        resolver that fetches the output partition, or None when it is
        declined (the caller then projects on the host)."""
        resolve = self._launch_projection(part, exprs)
        if resolve is None:
            return None
        self.stats.bump("device_projections")
        self.stats.bump("device_projection_dispatches")
        return lambda: MicroPartition.from_table(resolve())

    def _compacted(self, part: MicroPartition, resolve) -> MicroPartition:
        """Fetch a launched filter's mask and compact the partition on the
        host."""
        return MicroPartition.from_table(part.table().filter_with_mask(resolve()._columns[0]))

    def eval_filter(self, part: MicroPartition, predicate) -> MicroPartition:
        """A filter whose mask is computed on the card when eligible (the
        compaction runs on the host), else a host filter."""
        resolve = self._launch_projection(part, [predicate])
        if resolve is not None:
            self.stats.bump("device_filters")
            return self._compacted(part, resolve)
        self.stats.bump("host_filters")
        return part.filter([predicate])

    def eval_filter_dispatch(self, part: MicroPartition, predicate):
        """Launch the device filter mask without blocking; the resolver
        fetches the mask and compacts on the host. Same contract as
        ``eval_projection_dispatch``."""
        resolve = self._launch_projection(part, [predicate])
        if resolve is None:
            return None
        self.stats.bump("device_filters")
        self.stats.bump("device_filter_dispatches")
        return lambda: self._compacted(part, resolve)

    def eval_distinct(self, part: MicroPartition, subset) -> MicroPartition:
        """Distinct through the device group-codes kernel when the keys are
        device-eligible (the first row of each key tuple; the take runs on
        the host), the host dictionary encode otherwise."""
        if self._device_eligible(part):
            import numpy as np

            from .expressions import col
            from .kernels.device import resolve_device
            from .kernels.device_agg import device_distinct_indices
            from .series import Series

            keys = list(subset) if subset else [col(n) for n in part.schema.field_names()]
            idx = device_distinct_indices(part.table(), keys, part.device_stage_cache(),
                                          len(part), device=resolve_device(self.cfg))
            if idx is not None:
                self.stats.bump("device_distincts")
                return MicroPartition.from_table(
                    part.table().take(Series.from_numpy(idx.astype(np.uint64), "idx")))
        self.stats.bump("host_distincts")
        return part.distinct(subset)

    # ------------------------------------------------------------------ joins
    def _join_eligible(self, lpart, rpart, left_on, right_on, how) -> bool:
        return (self.cfg.use_device_kernels
                and how in ("inner", "left", "semi", "anti")
                and 1 <= len(left_on) == len(right_on) <= 4
                and max(len(lpart), len(rpart)) >= self.cfg.device_min_rows)

    def _assemble_join(self, res, lpart, rpart, left_on, right_on, how,
                       suffix) -> MicroPartition:
        """(side, hit, bidx) probe result -> the output partition."""
        import numpy as np

        from .series import Series

        side, hit, bidx = res
        ltbl, rtbl = lpart.table(), rpart.table()
        if side == "expanded":
            # N:M range join: (lidx, ridx) pairs expanded on the host
            out = ltbl.join_from_indices(rtbl, hit, bidx, left_on, right_on, suffix)
        elif side == "right_build":
            if how == "semi":
                out = ltbl.filter_with_mask(Series.from_numpy(hit, "m"))
            elif how == "anti":
                out = ltbl.filter_with_mask(Series.from_numpy(~hit, "m"))
            elif how == "inner":
                lidx = np.nonzero(hit)[0]
                out = ltbl.join_from_indices(rtbl, lidx, bidx[hit], left_on, right_on, suffix)
            else:  # left outer: every left row, -1 -> null right
                ridx = np.where(hit, bidx, -1)
                out = ltbl.join_from_indices(rtbl, np.arange(len(ltbl), dtype=np.int64), ridx,
                                             left_on, right_on, suffix)
        else:  # left_build (inner only): re-sort to the host's (lidx, ridx) order
            ridx = np.nonzero(hit)[0]
            lidx = bidx[hit]
            order = np.argsort(lidx, kind="stable")
            out = ltbl.join_from_indices(rtbl, lidx[order], ridx[order], left_on, right_on,
                                         suffix)
        return MicroPartition.from_table(out)

    def eval_join_dispatch(self, lpart: MicroPartition, rpart: MicroPartition,
                           left_on, right_on, how: str, suffix: str):
        """Stage both sides' keys and launch the device probe now; return a
        zero-arg resolver that fetches the probe and assembles the output,
        or None when the pair is not device-eligible (the caller joins on
        the host). A failure on the card propagates: the reference's catch,
        which sends a failed probe to the host join, comes with the
        DeviceHealth breaker, which is not ported yet."""
        if not self._join_eligible(lpart, rpart, left_on, right_on, how):
            return None
        from .kernels.device import resolve_device
        from .kernels.device_join import device_join_launch

        launch = device_join_launch(lpart.table(), rpart.table(), list(left_on),
                                    list(right_on), lpart.device_stage_cache(),
                                    rpart.device_stage_cache(), how,
                                    device=resolve_device(self.cfg))
        if launch is None:
            return None
        self.stats.bump("device_join_dispatches")

        def finish() -> MicroPartition:
            out = self._assemble_join(launch(), lpart, rpart, left_on, right_on, how, suffix)
            self.stats.bump("device_join_probes")
            return out

        return finish

    def eval_join_declined(self, lpart, rpart, left_on, right_on, how,
                           suffix) -> MicroPartition:
        """The host join of a pair the dispatch found device-ineligible."""
        self.stats.bump("host_joins")
        return lpart.hash_join(rpart, left_on, right_on, how, suffix)

    # ------------------------------------------------------------ aggregation
    def _eval_agg_host(self, part: MicroPartition, aggregations, groupby,
                       predicate=None) -> MicroPartition:
        self.stats.bump("host_aggregations")
        if predicate is not None:
            part = part.filter([predicate])
        return part.agg(aggregations, groupby or None)

    def eval_agg(self, part: MicroPartition, aggregations, groupby,
                 predicate=None) -> MicroPartition:
        """The aggregation on the card when eligible, else on the host."""
        fin = self.eval_agg_dispatch(part, aggregations, groupby, predicate)
        if fin is not None:
            return fin()
        return self._eval_agg_host(part, aggregations, groupby, predicate)

    def eval_agg_dispatch(self, part: MicroPartition, aggregations, groupby,
                          predicate=None):
        """Launch the fused device aggregation now and return a zero-arg
        resolver that fetches its result, or None when the partition is not
        device-eligible (the caller then runs the host path)."""
        if not self.cfg.use_device_kernels:
            return None
        if len(part) < self.cfg.device_min_rows:
            return None  # too few rows: plain routing to the host, not a fallback
        from .kernels.device import resolve_device
        from .kernels.device_agg import device_grouped_agg_async

        resolve = device_grouped_agg_async(
            part.table(), list(aggregations), list(groupby or []),
            stage_cache=part.device_stage_cache(), predicate=predicate,
            stats=self.stats, device=resolve_device(self.cfg))
        if resolve is None:
            return None  # a decline before launch: plain routing, as in the reference
        self.stats.bump("device_aggregations")

        def finish() -> MicroPartition:
            out = resolve()
            if out is not None:
                return MicroPartition.from_table(out)
            # the int32 overflow guard declined at materialization: the
            # partition was NOT aggregated on the card
            self.stats.bump("device_aggregations", -1)
            self.stats.bump("device_agg_fallbacks")
            return self._eval_agg_host(part, aggregations, groupby, predicate)

        return finish

    # -------------------------------------------------------- fused map chains
    def _eval_fused_host(self, part: MicroPartition, program) -> MicroPartition:
        """Host single-pass evaluation of a fused chain. The per-op class
        counters advance by the chain's op counts."""
        self.stats.bump("host_fused_maps")
        g = program.graph
        if g.n_project_ops:
            self.stats.bump("host_projections", g.n_project_ops)
        if g.n_filter_ops:
            self.stats.bump("host_filters", g.n_filter_ops)
        return MicroPartition.from_table(program.run_host(part.table()))

    def _bump_fused_device(self, program) -> None:
        g = program.graph
        self.stats.bump("device_fused_maps")
        if g.n_project_ops:
            self.stats.bump("device_projections", g.n_project_ops)
        if g.n_filter_ops:
            self.stats.bump("device_filters", g.n_filter_ops)

    def eval_fused(self, part: MicroPartition, program) -> MicroPartition:
        """A fused map chain as ONE device program when eligible, else the
        segmented host pass."""
        fin = self.eval_fused_dispatch(part, program)
        return fin() if fin is not None else self._eval_fused_host(part, program)

    def eval_fused_dispatch(self, part: MicroPartition, program):
        """Launch the fused chain's device program without blocking; returns
        a zero-arg resolver, or None when the partition is not
        device-eligible or the program declines it (an ineligible expression
        or column, or the int64 wrap guard): the caller then takes the host
        pass (``host_fused_maps``)."""
        if not self._device_eligible(part):
            return None
        from .kernels.device import eval_projection_device_async, resolve_device

        resolve = eval_projection_device_async(
            part.table(), program.device_exprs, stage_cache=part.device_stage_cache(),
            device=resolve_device(self.cfg))
        if resolve is None:
            return None
        self._bump_fused_device(program)
        self.stats.bump("device_fused_map_dispatches")
        return lambda: MicroPartition.from_table(program.assemble_device(resolve()))

    # ------------------------------------------------------------ plan segments
    def eval_segment_dispatch(self, part: MicroPartition, op):
        """Launch a compiled plan segment (fuse/segment.py DeviceSegmentOp)
        through the resident pipeline; returns a zero-arg resolver, or None
        when the partition is not device-eligible. A resident attempt that
        declines (or trips the overflow guard) runs the staged ops and is
        counted as ``segment_fallbacks``. An exception propagates: the
        reference's catch in this resolver comes with the DeviceHealth
        breaker, which is not ported yet."""
        if not self._device_eligible(part):
            return None
        from .fuse.segment import _proc_bump, run_segment_async
        from .kernels.device import resolve_device

        resolve = run_segment_async(part.table(), op.program, part.device_stage_cache(),
                                    stats=self.stats, cfg=self.cfg,
                                    device=resolve_device(self.cfg))
        if resolve is None:
            return lambda: self._eval_segment_staged(part, op, degraded=True)
        self.stats.bump("device_aggregations")
        self.stats.bump("segment_dispatches")

        def finish() -> MicroPartition:
            out = resolve()
            if out is not None:
                # the map -> agg Arrow round trip of the staged plan did not happen
                self.stats.bump("device_handoffs_elided")
                op._record_resident(self)
                _proc_bump("handoffs_elided")
                return MicroPartition.from_table(out)
            # the overflow guard declined: the segment did NOT run resident
            self.stats.bump("device_aggregations", -1)
            return self._eval_segment_staged(part, op, degraded=True)

        return finish

    def _eval_segment_staged(self, part: MicroPartition, op,
                             degraded: bool = True) -> MicroPartition:
        """The segment as its retained staged ops: the fused map chain, Arrow
        materialization, then the (filter-fused) aggregation, exactly the
        plan the segment pass collapsed. ``degraded`` marks a resident
        attempt that declined (counted), against plain routing of an
        ineligible partition (not counted)."""
        if degraded:
            from .fuse.segment import _proc_bump

            self.stats.bump("segment_fallbacks")
            _proc_bump("segment_fallbacks")
        return op.staged_agg(op.staged_map(part, self), self)


def execute_plan(root: PhysicalOp, ctx: ExecutionContext) -> Iterator[MicroPartition]:
    """Wire up the generator tree and return the root partition stream. Every
    op is wrapped with per-partition accounting (rows and wall time)."""

    def build(op: PhysicalOp) -> Iterator[MicroPartition]:
        return _traced(op, op.execute([build(c) for c in op.children], ctx), ctx)

    return build(root)


def _traced(op: PhysicalOp, stream: Iterator[MicroPartition],
            ctx: ExecutionContext) -> Iterator[MicroPartition]:
    name = op.name()
    it = iter(stream)
    while True:
        t0 = time.perf_counter_ns()
        part = next(it, None)
        if part is None:
            return
        ctx.stats.record_op(name, len(part), time.perf_counter_ns() - t0)
        yield part
