"""Executor: runs a physical plan as a tree of partition generators (the
port's copy of the part of daft_tpu/execution.py this slice runs).

The device path has no silent fallback. An exception raised on the card
propagates to the caller. Only the reference's documented declines send a
partition to the host path, and each is counted as ``device_agg_fallbacks``:
an ineligible plan or dtype, a partition below ``device_min_rows``, and the
int32 overflow guard of ``device_agg._finish_agg``.

Left out of this slice: the DeviceHealth breaker and fault injection, the
profiler, spill, deadlines and cancellation, the worker pool, streaming, the
device projection/filter/sort/distinct/join hooks and resource accounting.
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
        if not self.cfg.use_device_kernels:
            return False
        if len(part) < self.cfg.device_min_rows:
            self.stats.bump("device_agg_fallbacks")  # decline: too few rows
            return False
        return True

    def eval_sort(self, part: MicroPartition, sort_by, descending=None,
                  nulls_first=None) -> MicroPartition:
        # the device argsort is not ported yet: sorts run on the host
        self.stats.bump("host_sorts")
        return part.sort(sort_by, descending, nulls_first)

    def _eval_agg_host(self, part: MicroPartition, aggregations, groupby,
                       predicate=None) -> MicroPartition:
        self.stats.bump("host_aggregations")
        if predicate is not None:
            part = part.filter([predicate])
        return part.agg(aggregations, groupby or None)

    def eval_agg_dispatch(self, part: MicroPartition, aggregations, groupby,
                          predicate=None):
        """Launch the fused device aggregation now and return a zero-arg
        resolver that fetches its result, or None when the partition is not
        device-eligible (the caller then runs the host path)."""
        if not self._device_eligible(part):
            return None
        from .kernels.device import resolve_device
        from .kernels.device_agg import device_grouped_agg_async

        resolve = device_grouped_agg_async(
            part.table(), list(aggregations), list(groupby or []),
            stage_cache=part.device_stage_cache(), predicate=predicate,
            stats=self.stats, device=resolve_device(self.cfg))
        if resolve is None:
            self.stats.bump("device_agg_fallbacks")  # decline: ineligible plan
            return None
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
