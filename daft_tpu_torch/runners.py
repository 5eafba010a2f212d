"""Runners: plan a query and execute it (the port's copy of the part of
daft_tpu/runners.py this slice runs).

Planning goes through ``plan_query`` (adapt/plancache.py): a repeated query
shape is served from the plan cache; a cold one is optimized and
translated (which fuses) with feedback-directed planning live. Under
``enable_aqe`` the AdaptivePlanner (adaptive.py) runs the stages under
joins first and plans the rest from their real sizes.

A query runs under one DeviceHealth breaker per kind (the card's and the
mesh collectives') and one absolute deadline (``execution_timeout_s`` from
the start of the run), built once in ``run_iter`` and handed to every
ExecutionContext of the query, each adaptive stage's among them: a dead
card does not pay the failure threshold again per stage, and the stages
share one time budget. The breakers are registered with ``health()``
(obs/health.py).

``MeshRunner`` runs the same plans under a ``MeshExecutionContext``
(parallel/mesh_exec.py): its shuffles ride the slot exchange of its mesh
(``default_mesh()`` unless given one, or ``multihost.global_mesh()`` for a
multi-process cluster).

``plan_cache_key`` is the exact structural key of a plan: the plan
cache's binding and the key of ``DataFrame.collect``'s whole-plan result
cache (``PartitionSetCache``). A scan keys on each task's file, its mtime
and size, format, pushdowns, schema and options (``_scan_task_key``, also
the sub-plan result cache's key), so an overwritten file never serves a
cached plan or result. A task whose path cannot be stat'ed (an
object-store url) and a ``FactoryScanTask`` (io/pyscan.py, a Python
callable, whose identity cannot be fingerprinted) make the plan
uncacheable in all three caches. The distributed runner
(dist/runner.py) is a NativeRunner whose contexts carry the worker pool as
their dispatch backend.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterator, List, Optional

from .context import get_context
from .execution import DeviceHealth, ExecutionContext, RuntimeStats, execute_plan
from .logical import LogicalPlan
from .micropartition import MicroPartition
from .schema import Schema


class PartitionSet:
    """Materialized result: an ordered list of partitions + schema."""

    def __init__(self, schema: Schema, partitions: List[MicroPartition]):
        self.schema = schema
        self.partitions = partitions

    def __len__(self) -> int:
        return sum(len(p) for p in self.partitions)

    def to_micropartition(self) -> MicroPartition:
        if not self.partitions:
            return MicroPartition.empty(self.schema)
        if len(self.partitions) == 1:
            return self.partitions[0]
        return MicroPartition.concat(self.partitions)

    def to_table(self):
        return self.to_micropartition().table().cast_to_schema(self.schema)


class PartitionSetCache:
    """Process-wide cache of materialized results keyed by an entry id, with
    explicit refcounts: it keeps ``collect()`` results alive so that a later
    collect of the same plan reuses them instead of executing again."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, PartitionSet] = {}
        self._refs: Dict[str, int] = {}

    def put(self, key: str, pset: PartitionSet) -> str:
        with self._lock:
            self._entries[key] = pset
            self._refs[key] = self._refs.get(key, 0) + 1
        return key

    def get(self, key: str) -> Optional[PartitionSet]:
        with self._lock:
            return self._entries.get(key)

    def release(self, key: str) -> None:
        with self._lock:
            n = self._refs.get(key, 0) - 1
            if n <= 0:
                self._entries.pop(key, None)
                self._refs.pop(key, None)
            else:
                self._refs[key] = n

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._refs.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


_PARTITION_SET_CACHE = PartitionSetCache()


def partition_set_cache() -> PartitionSetCache:
    return _PARTITION_SET_CACHE


class _Uncacheable(Exception):
    pass


def plan_cache_key(plan: LogicalPlan) -> Optional[str]:
    """The structural key of a plan, or None where caching would be unsound:
    a write (a repeated write must write again), a seedless sample, a UDF (it
    may not be deterministic, and its key holds ``id(fn)``, which can be
    reused), or an attribute this walk cannot prove free of collisions."""
    try:
        return _plan_key(plan)
    except _Uncacheable:
        return None


_SCALARS = (str, int, float, bool, bytes, type(None))


def _file_fingerprint(path: str) -> str:
    """The file's mtime and size, so that an overwritten file never serves a
    cached plan or result; a file that cannot be stat'ed is uncacheable."""
    import os

    try:
        st = os.stat(path)
    except OSError:
        raise _Uncacheable from None
    return f"{st.st_mtime_ns}:{st.st_size}"


def _scan_task_key(t) -> str:
    """The exact key of one scan task: path, mtime and size, format,
    pushdowns, row groups, partition values, reader options and schema (the
    same file read with another delimiter or schema hint is another key)."""
    from .io.pyscan import FactoryScanTask
    from .io.scan import MergedScanTask

    if isinstance(t, FactoryScanTask):
        # two factories sharing a stat-able label must never collide
        raise _Uncacheable
    if isinstance(t, MergedScanTask):
        # every child's file: the merged task's path is its first child's
        return "+".join(_scan_task_key(c) for c in t.children)
    opts = sorted((k, repr(v)) for k, v in t.storage_options.items())
    sch = [(f.name, str(f.dtype)) for f in t.schema]
    return (f"{t.path}|{_file_fingerprint(t.path)}|{t.format}|{t.pushdowns!r}"
            f"|{t.row_group_ids}|{t.partition_values}|{opts}|{sch}")


def _plan_key(p: LogicalPlan) -> str:
    from .expressions import Expression, expr_has_udf
    from .logical import InMemorySource, Sample, ScanSource, Write

    if isinstance(p, Write):
        raise _Uncacheable
    if isinstance(p, Sample) and p.seed is None:
        raise _Uncacheable
    if isinstance(p, InMemorySource):
        # a uuid minted with the source: unlike id(), never reused after the
        # source is collected
        tok = getattr(p, "_cache_token", None)
        if tok is None:
            raise _Uncacheable
        return f"mem#{tok}"
    if isinstance(p, ScanSource):
        return "scan#" + ";".join(_scan_task_key(t) for t in p.tasks)
    items = []
    for k, v in sorted(vars(p).items()):
        # schemas derive from the children and the expressions, covered here
        if k.startswith("_") or isinstance(v, (LogicalPlan, Schema)):
            continue
        if isinstance(v, Expression):
            if expr_has_udf(v):
                raise _Uncacheable
            items.append(f"{k}={v._node._key()!r}")
        elif isinstance(v, (list, tuple)):
            if all(isinstance(e, Expression) for e in v):
                if any(expr_has_udf(e) for e in v):
                    raise _Uncacheable
                items.append(f"{k}=[{','.join(repr(e._node._key()) for e in v)}]")
            elif all(isinstance(e, _SCALARS) for e in v):
                items.append(f"{k}={v!r}")
            else:
                raise _Uncacheable
        elif isinstance(v, _SCALARS):
            items.append(f"{k}={v!r}")
        else:
            raise _Uncacheable  # an attribute of unknown type: refuse, never collide
    kids = ",".join(_plan_key(c) for c in p.children())
    return f"{type(p).__name__}({';'.join(items)})[{kids}]"


class NativeRunner:
    """Single-process runner: plan (through the plan cache), then execute
    sequentially."""

    name = "native"

    def run(self, plan: LogicalPlan, stats: Optional[RuntimeStats] = None) -> PartitionSet:
        return PartitionSet(plan.schema, list(self.run_iter(plan, stats)))

    def run_iter(self, plan: LogicalPlan,
                 stats: Optional[RuntimeStats] = None) -> Iterator[MicroPartition]:
        """Builds the query's breaker and deadline once, then runs the plan,
        stage by stage under ``enable_aqe``."""
        cfg = get_context().execution_config
        stats = stats if stats is not None else RuntimeStats()
        health = DeviceHealth(cfg.device_breaker_threshold, cfg.device_breaker_cooldown_s)
        collective = DeviceHealth(cfg.device_breaker_threshold, cfg.device_breaker_cooldown_s,
                                  kind="collective")
        # health() reads the latest query's breakers (weakly held: a finished
        # query's breaker reads as idle)
        from .obs.health import register_breaker

        register_breaker(health)
        register_breaker(collective)
        deadline = (None if cfg.execution_timeout_s is None
                    else time.monotonic() + cfg.execution_timeout_s)

        def run_plain(p: LogicalPlan, optimized: bool = False) -> Iterator[MicroPartition]:
            _, phys, run_cfg = self.plan_query(p, optimized, stats)
            ctx = self._context(run_cfg, stats, deadline, health, collective)
            return execute_plan(phys, ctx)

        if cfg.enable_aqe:
            from .adaptive import AdaptivePlanner

            # the planner hands over plans it has already optimized
            return AdaptivePlanner(lambda p: run_plain(p, optimized=True), stats,
                                   cfg=cfg).run(plan)
        return run_plain(plan)

    def _context(self, cfg, stats, deadline, health, collective) -> ExecutionContext:
        """One ExecutionContext of the query (one per adaptive stage)."""
        return ExecutionContext(cfg, stats, deadline=deadline, device_health=health,
                                collective_health=collective)

    def plan_query(self, plan: LogicalPlan, optimized: bool = False, stats=None):
        """Feedback-informed planning, served from the process plan cache
        where it can be (adapt/plancache.py): ``(optimized plan, physical
        plan, run config)``. The planning wall time and its compile share
        land in ``stats`` as ``planning_wall_ns`` / ``compile_wall_ns``."""
        from .adapt.plancache import plan_query

        return plan_query(plan, get_context().execution_config, stats=stats,
                          optimized=optimized, runner=self.name)

    def optimize_and_translate(self, plan: LogicalPlan, optimized: bool = False, stats=None):
        opt, phys, _ = self.plan_query(plan, optimized=optimized, stats=stats)
        return opt, phys


class MeshRunner(NativeRunner):
    """The same plans, executed under a MeshExecutionContext: shuffles, the
    sort-merge join's exchange and broadcast replicas ride the mesh
    (parallel/mesh_exec.py). Plans cache under the runner's name, and mesh
    plans decline fan-out resizes (adapt/plancache.py, adapt/fdo.py)."""

    name = "mesh"

    def __init__(self, mesh=None):
        self.mesh = mesh

    def _context(self, cfg, stats, deadline, health, collective) -> ExecutionContext:
        from .parallel.mesh_exec import MeshExecutionContext

        return MeshExecutionContext(cfg, stats, mesh=self.mesh, deadline=deadline,
                                    device_health=health, collective_health=collective)
