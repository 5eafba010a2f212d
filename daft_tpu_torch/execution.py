"""Executor: runs a physical plan as a tree of partition generators (the
port's copy of the part of daft_tpu/execution.py this slice runs).

Routing. The reference's documented declines send a partition to the host
path as plain routing: a partition below ``device_min_rows``, an
ineligible plan, expression, key or dtype (count_distinct among them), a
device program that returns None (a lost dictionary, the int64 wrap guard,
a nullable multi-key distinct, an overflowing composite key space, a join
type other than inner/left/semi/anti), counted as ``host_*``; the int32
overflow guard of an aggregate's resolver (``device_agg_fallbacks``); a
resident plan segment that declines (``segment_fallbacks``, then the
staged ops).

An aggregation list of stage-1 ``sketch_hll`` aggregations alone (an
approx_count_distinct over several partitions) builds its HLL registers
with K9 on the card (``_sketch_build_device``, sketch/device.py;
``device_sketch_builds``); its kind gate runs before the breaker or the
fault site is touched. A failure at the fetch completes the partition on
the host (``device_sketch_fallbacks``).

Failures. Every device attempt runs under the query's ``DeviceHealth``
breaker and the ``device.kernel`` fault site (``_device_attempt``), and
the resolver of a launched attempt fetches under the same catch
(``_resolve``). The catch takes what the reference's breaker exists for,
failures of the device layer and nothing else (``DEVICE_FAILURES``): a
staging decline by exception (``DaftStagingError``, the 32-bit mode's
int32 range guard), an injected fault (``faults.InjectedFault``) and
``torch.cuda.OutOfMemoryError``. Each counts as a breaker failure and as
``device_attempt_failures``, and the partition completes on the host,
with the device counter taken back and a ``*_fallbacks`` counter bumped
where the reference bumps them. After ``device_breaker_threshold``
consecutive failures the breaker opens: every device-eligible partition
of the query goes to the host (``degraded_completions``) until one probe
after the cooldown succeeds. ``device_breaker_trips`` shows a trip.

Every other exception reaches the caller. The reference's breaker takes
any exception of its device layer; in the port that would take a defect
of the port's own code (a KeyError in K2's emitter, a torch op that
rejects its inputs) and finish on the host behind rows that look right.
Above all, ``DaftKernelError`` (a hand-written kernel or the card is
unavailable: nvcc missing or failing, a library that does not load, a
launch error, a config asking for the card where there is none) and
``torch.AcceleratorError`` (a CUDA error) mean the port itself is broken;
the broader catches of the fuse compile and the join filter's fail-open
re-raise them first (``errors.PORT_FAILURES``).

Deadlines. ``execution_timeout_s`` becomes one absolute deadline per query
(``runners.NativeRunner``); ``check_deadline`` raises ``DaftTimeoutError``
with the partial stats on every partition pull (``_traced``) and before a
pipeline breaker buffers its input (the sort, a gather, ``ShuffleOp``, the
join build).

Scheduling. ``execute_plan``'s ``build`` sends each op down one of four
paths, as the reference's does: a streamable chain (a Project/Filter/
FusedMap/BatchedUdf chain, maybe under a Limit, over a scan or in-memory
source) becomes one morsel pipeline (``stream.try_stream``); a
batch-declared UDF op runs its own coalescing ``execute``; a map op whose
UDFs are parallel-safe runs through ``_adaptive_device_map`` when it is
device-pipelinable and requests no resources (the first partition's
dispatch decides: accepted, the double-buffered sequential driver; declined,
``_parallel_map``), and through ``_parallel_map`` otherwise, whose
partitions run as tasks on the query's pool (scheduler.dispatch, results in
order); every other op runs its ``execute`` on the consumer's thread. With
one worker (``executor_threads=1``, or a host of fewer than 4 cores) no map
runs on the pool. Pool threads launch the kernels on the card as the
consumer's thread does, on the default stream of the device.

Cancellation. ``RuntimeStats.cancel()`` (``DataFrame.cancel()``, from any
thread) stops the query at the next partition pull (``_traced``), task
dispatch or stream pull with ``QueryCancelledError``; the query's record
says ``cancelled``. ``reset_cancel()`` re-arms the handle for a new run.

Memory. Each query holds its ledger (``spill.MEMORY_LEDGER``), its byte
budget (``memory_budget_bytes``), a spill directory made on first use and a
lineage log. ``partition_buffer()`` hands a pipeline breaker a spillable
buffer bound to them, after a deadline check, and tracks it. One lazy
pool per query (``pool()``, ``num_workers`` threads and at least two) runs
the map tasks, the shuffle's fan-out, the stream producers and the
background IO: the scan readahead's fetches (io/prefetch.py) and the
unspill readahead (``_bg_submit``). When the root stream ends, is closed
early (a limit, an abandoned join) or raises, ``execute_plan``'s teardown
closes the stream tree, shuts every stream segment still registered
(``close_streams``), shuts the pool (queued work is cancelled, running work
finishes) and ``finish_query`` releases every buffer and removes the spill
directory, so the ledger reads 0 again. After
that the unspill readahead submits nothing, while the scan readahead may
still serve a late read (``to_pydict`` over a collected scan reads its
partitions after the query) from a private pool that ``pool()`` makes
again, which the garbage collector releases with the last partition that
holds the prefetcher.

Admission. A map op whose expressions call UDFs with a resource request
(``num_cpus``, ``num_gpus``, ``memory_bytes``) has it checked by the
query's ``ResourceAccountant`` (``accountant``), sized from the host's
cores, the cards of ``cfg.device`` (``torch.cuda.device_count()`` for
``"cuda"``, none for ``"cpu"``) and the memory budget: a request that can
never fit raises ``DaftResourceError`` before the op runs; each partition
task then waits in ``admit`` until its request fits what the running tasks
leave, and ``release`` returns it when the task ends.

Observability. Each query's RuntimeStats carries a profiler
(``stats.profiler``): the shared DISARMED no-op unless ``collect(profile=...)``,
``enable_profiling``, an armed chrome trace or the slow-query capture arms
one. Armed, every partition an op emits is an ``op`` span (``_traced``,
whose self time is what ``op_wall_ns`` records), a device attempt adds its
host time to the ``device_dispatch`` phase of the innermost span (staging
and launching; an asynchronous launch's kernels run after it, see
profile/spans.py), a resident segment's fetch is a ``fuse.segment`` span,
blocked IO is the ``io_wait`` phase and a wait for a dispatched task or a
stream channel the ``queue_wait`` phase (``dispatch_wait_ns``); a task's
worker-side span and a stream producer's ``morsel`` spans parent to the op
that submitted them. The breaker logs each transition
(``breaker_trip``, ``_probe``, ``_recovery``, ``_reopen``) and records it as
a ``breaker`` event; an expired deadline logs ``deadline_expired``.
``execute_plan`` gives each execution a query id, bound to the consumer's
thread for each pull; registers its live progress (obs/cluster.py); and at
the end, whatever the outcome, renders the span tree into an armed chrome
trace, folds the query into the process metrics, appends its QueryRecord to
the query log and hands it to the slow and failed query capture
(``_record_query``). No observability defect fails the query: each
degrades to an error log line.

Mesh runs (parallel/mesh_exec.py): ``prepare_broadcast`` is a no-op
here; the mesh context replicates a broadcast build side's key there, and
``eval_join_dispatch`` probes each partition against the copy on its own
device. A map op over a partition that another process owns and has not
read (``foreign_owned``, a multi-process scan) is deferred onto the
partition instead of reading its file (``with_pending_op``), and a plan
segment declines it. Every map output carries its input's
``owner_process``.

The distributed runner (dist/) attaches a dispatch backend
(``dist_backend``, its WorkerPool): map partitions then run through
``_parallel_map`` on worker processes, the device-pipelinable ones among
them (each worker launches the kernels itself), and the pool covers the
fleet (``num_workers``). Shuffles whose pieces stay on the workers
(``register_peer_shuffle``) are dropped at ``finish_query``, after the root
outputs were made local.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch

from . import faults
from .context import ExecutionConfig
from .errors import PORT_FAILURES, DaftStagingError, DaftTimeoutError
from .micropartition import MicroPartition
from .physical import PhysicalOp

# what a device attempt takes as a breaker failure (see above)
DEVICE_FAILURES = (DaftStagingError, faults.InjectedFault, torch.cuda.OutOfMemoryError)


class QueryCancelledError(RuntimeError):
    """Raised inside a running query after RuntimeStats.cancel()."""


class ResourceRequest:
    """What one task needs while it runs: CPUs, cards and memory bytes."""

    __slots__ = ("num_cpus", "num_gpus", "memory_bytes")

    def __init__(self, num_cpus: float = 0.0, num_gpus: float = 0.0, memory_bytes: int = 0):
        self.num_cpus = num_cpus or 0.0
        self.num_gpus = num_gpus or 0.0
        self.memory_bytes = memory_bytes or 0

    def __bool__(self) -> bool:
        return bool(self.num_cpus or self.num_gpus or self.memory_bytes)

    def __repr__(self):
        return (f"ResourceRequest(cpus={self.num_cpus}, gpus={self.num_gpus}, "
                f"memory={self.memory_bytes})")


def op_resource_request(op) -> ResourceRequest:
    """The sum of the resource requests of every UDF an op evaluates (the
    UDFs of one projection all run for the same task)."""
    from .expressions import PyUdf

    cpus = gpus = mem = 0

    def walk(node):
        nonlocal cpus, gpus, mem
        if isinstance(node, PyUdf) and node.resource_request:
            c, g, m = node.resource_request
            cpus += c or 0
            gpus += g or 0
            mem += m or 0
        for ch in node.children():
            walk(ch)

    for e in op._map_exprs():
        walk(e._node)
    return ResourceRequest(cpus, gpus, mem)


class ResourceAccountant:
    """Admission control for tasks: a task dispatches only when its CPUs,
    cards and memory fit what is left; a request that can never fit the host
    fails at once instead of waiting for good."""

    def __init__(self, cpus: float, gpus, memory_bytes: Optional[int]):
        """``gpus`` is a number or a zero-argument callable resolved on first
        use, so a query without a card request never asks torch for one."""
        self.total_cpus = cpus
        self._gpu_src = gpus
        self._gpus_resolved: Optional[float] = float(gpus) if not callable(gpus) else None
        self.total_memory = memory_bytes
        self._cpus = cpus
        self._gpus_used = 0.0
        self._memory = memory_bytes
        self._cond = threading.Condition()

    @property
    def total_gpus(self) -> float:
        if self._gpus_resolved is None:
            self._gpus_resolved = float(self._gpu_src())
        return self._gpus_resolved

    def check(self, req: ResourceRequest) -> None:
        """Raise if the request can NEVER be admitted on this host."""
        from .errors import DaftResourceError

        if req.num_cpus > self.total_cpus:
            raise DaftResourceError(
                f"task requests {req.num_cpus} CPUs but only {self.total_cpus} exist")
        if req.num_gpus and req.num_gpus > self.total_gpus:
            raise DaftResourceError(
                f"task requests {req.num_gpus} accelerator(s) but only "
                f"{self.total_gpus} exist")
        if self.total_memory is not None and req.memory_bytes > self.total_memory:
            raise DaftResourceError(
                f"task requests {req.memory_bytes} bytes but the memory "
                f"budget is {self.total_memory}")

    def _fits(self, req: ResourceRequest) -> bool:
        gpu_ok = not req.num_gpus or req.num_gpus <= self.total_gpus - self._gpus_used + 1e-9
        return (req.num_cpus <= self._cpus + 1e-9 and gpu_ok
                and (self._memory is None or req.memory_bytes <= self._memory))

    def admit(self, req: ResourceRequest) -> None:
        """Wait until the request fits, then reserve it."""
        self.check(req)
        with self._cond:
            while not self._fits(req):
                self._cond.wait()
            self._cpus -= req.num_cpus
            self._gpus_used += req.num_gpus
            if self._memory is not None:
                self._memory -= req.memory_bytes

    def release(self, req: ResourceRequest) -> None:
        with self._cond:
            self._cpus += req.num_cpus
            self._gpus_used -= req.num_gpus
            if self._memory is not None:
                self._memory += req.memory_bytes
            self._cond.notify_all()


def _accelerator_count(cfg: ExecutionConfig) -> int:
    """The cards a task may ask for: torch's CUDA devices when the config
    runs on the card, none when it runs on the CPU."""
    return torch.cuda.device_count() if torch.device(cfg.device).type == "cuda" else 0


class RuntimeStats:
    """Per-query counters, per-operator rows, wall time and bytes, the
    query's profiler and its cancellation handle."""

    def __init__(self):
        from .profile.spans import DISARMED

        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {}
        self.op_rows: Dict[str, int] = {}
        self.op_wall_ns: Dict[str, int] = {}
        self.op_bytes: Dict[str, int] = {}
        # the query's span and event recorder (profile/spans.py): the shared
        # no-op until collect(profile=...), enable_profiling, an armed chrome
        # trace or the slow-query capture swaps in a live one
        self.profiler = DISARMED
        # the QueryRecord of this handle's latest plan execution
        # (execute_plan's completion hook; df.last_query_record())
        self.last_record = None
        # feedback observations (adapt/): canonical subtree fingerprint ->
        # [rows, bytes] accumulated by the tagged exchanges and joins, folded
        # into the process history when the query ends
        self.fdo_obs: Dict[str, list] = {}
        self._cancelled = threading.Event()

    def cancel(self) -> None:
        """Stop the query this handle is attached to at its next partition
        boundary (safe from any thread)."""
        self._cancelled.set()

    def reset_cancel(self) -> None:
        """Re-arm the handle for a new run (a cancelled query's DataFrame
        stays usable)."""
        self._cancelled.clear()

    def is_cancelled(self) -> bool:
        return self._cancelled.is_set()

    def bump(self, key: str, n: int = 1) -> None:
        # counters arrive concurrently from the query's pool, the async spill
        # writer and the prefetch threads: the lock is load-bearing
        with self._lock:
            self.counters[key] = self.counters.get(key, 0) + n

    def fdo_observe(self, site_fp: str, rows: int, nbytes: int) -> None:
        """Accumulate one site observation: what flowed through a tagged
        plan subtree in this query."""
        with self._lock:
            cur = self.fdo_obs.get(site_fp)
            if cur is None:
                self.fdo_obs[site_fp] = [rows, nbytes]
            else:
                cur[0] += rows
                cur[1] += nbytes

    def take_fdo_obs(self) -> Dict[str, tuple]:
        """Drain the accumulated observations (the history folds them once
        per execution)."""
        with self._lock:
            out = {k: (v[0], v[1]) for k, v in self.fdo_obs.items()}
            self.fdo_obs.clear()
        return out

    def bump_max(self, key: str, n: int) -> None:
        """High-water counter: the stored value only ratchets up to ``n``."""
        with self._lock:
            if n > self.counters.get(key, 0):
                self.counters[key] = n

    def record_op(self, name: str, rows: int, wall_ns: int, bytes_out: int = 0) -> None:
        with self._lock:
            self.op_rows[name] = self.op_rows.get(name, 0) + rows
            self.op_wall_ns[name] = self.op_wall_ns.get(name, 0) + wall_ns
            if bytes_out:
                self.op_bytes[name] = self.op_bytes.get(name, 0) + bytes_out

    def io_wait(self, ns: int) -> None:
        """Time the query's own thread waited on IO (a synchronous spill
        write, a spill read it made itself, a full writer queue, a readahead
        it had to wait for): the counter and the io_wait phase of the
        innermost open span, so a profile's io_wait reconciles with
        io_wait_ns."""
        self.bump("io_wait_ns", ns)
        p = self.profiler
        if p.armed:
            p.phase("io_wait", ns)

    def dispatch_wait(self, ns: int) -> None:
        """Time the consumer waited on a dispatched task or a stream channel:
        the counter and the queue_wait phase of the innermost open span."""
        self.bump("dispatch_wait_ns", ns)
        p = self.profiler
        if p.armed:
            p.phase("queue_wait", ns)

    def io_wait_share(self) -> float:
        """The share of the operators' wall time spent waiting on IO."""
        with self._lock:
            wait = self.counters.get("io_wait_ns", 0)
            total = sum(self.op_wall_ns.values())
        if wait <= 0:
            return 0.0
        return min(1.0, wait / max(total, wait))

    def io_breakdown(self) -> Dict[str, float]:
        """The IO wait against compute, the scan readahead's hits, misses
        and throttles, the unspill readahead's hits and the spill write and
        read rates (MiB/s of wall time in the write and read)."""
        with self._lock:
            c = dict(self.counters)

        def mbps(b, ns):
            return (b / 2**20) / (ns / 1e9) if ns > 0 else 0.0

        return {
            "io_wait_share": round(self.io_wait_share(), 4),
            "io_wait_ms": round(c.get("io_wait_ns", 0) / 1e6, 1),
            "prefetch_hits": c.get("prefetch_hits", 0),
            "prefetch_misses": c.get("prefetch_misses", 0),
            "prefetch_throttled": c.get("prefetch_throttled", 0),
            "unspill_readahead_hits": c.get("unspill_readahead_hits", 0),
            "spill_write_mbps": round(mbps(c.get("spill_write_bytes", 0),
                                           c.get("spill_write_ns", 0)), 1),
            "spill_read_mbps": round(mbps(c.get("spill_read_bytes", 0),
                                          c.get("spill_read_ns", 0)), 1),
        }

    def op_throughput(self) -> Dict[str, Dict[str, float]]:
        """Per operator, rows/s and bytes/s over its accumulated wall time."""
        with self._lock:
            out: Dict[str, Dict[str, float]] = {}
            for name, ns in self.op_wall_ns.items():
                secs = ns / 1e9
                if secs <= 0:
                    continue
                out[name] = {"rows_per_sec": self.op_rows.get(name, 0) / secs,
                             "bytes_per_sec": self.op_bytes.get(name, 0) / secs}
            return out

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "op_rows": dict(self.op_rows),
                "op_wall_ns": dict(self.op_wall_ns),
                "op_bytes": dict(self.op_bytes),
            }


class DeviceHealth:
    """Circuit breaker for the card. Closed is normal; after ``threshold``
    consecutive failures it opens and ``allow()`` answers False, so callers
    go straight to the host path instead of paying the failure again per
    partition. After ``cooldown_s`` it goes half-open and lets exactly one
    probe through: success closes it, failure opens it for another
    cooldown. Counters: ``device_breaker_trips``, ``_probes``,
    ``_recoveries`` and ``_reopens``."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0, kind: str = "device"):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self.kind = kind
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self._probe_started = 0.0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self, stats: Optional[RuntimeStats] = None) -> bool:
        """May an attempt use the card now? Open: no; open past the
        cooldown: half-open, admitting one probe."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            now = time.monotonic()
            if self._state == self.OPEN and now - self._opened_at >= self.cooldown_s:
                self._state = self.HALF_OPEN
            if self._state == self.HALF_OPEN and (
                    not self._probe_inflight
                    # a probe whose resolver was abandoned (a limit closed
                    # the stream first) must not hold the breaker open for
                    # good: its slot is reclaimed after one cooldown
                    or now - self._probe_started >= self.cooldown_s):
                self._probe_inflight = True
                self._probe_started = now
                if stats is not None:
                    stats.bump(f"{self.kind}_breaker_probes")
                    self._emit(stats, "probe")
                return True
            return False

    def _emit(self, stats: Optional[RuntimeStats], transition: str) -> None:
        """A transition is a log line and, in a profiled query, a typed
        ``breaker`` event on the timeline, so a trace and the always-on log
        both show when the device path opened or recovered."""
        from .obs.log import get_logger

        get_logger("breaker").info(f"breaker_{transition}", breaker=self.kind,
                                   state=self._state)
        if stats is not None and stats.profiler.armed:
            stats.profiler.event("breaker", kind=self.kind, transition=transition,
                                 state=self._state)

    def record_success(self, stats: Optional[RuntimeStats] = None) -> None:
        with self._lock:
            self._consecutive = 0
            if self._state == self.HALF_OPEN:
                # only the probe closes the breaker: a late success of an
                # attempt launched before the trip leaves it open
                self._state = self.CLOSED
                self._probe_inflight = False
                if stats is not None:
                    stats.bump(f"{self.kind}_breaker_recoveries")
                    self._emit(stats, "recovery")

    def record_failure(self, stats: Optional[RuntimeStats] = None) -> None:
        with self._lock:
            self._consecutive += 1
            if self._state == self.HALF_OPEN:
                # the probe failed: open again for another cooldown
                self._state = self.OPEN
                self._opened_at = time.monotonic()
                self._probe_inflight = False
                if stats is not None:
                    stats.bump(f"{self.kind}_breaker_reopens")
                    self._emit(stats, "reopen")
            elif self._state == self.CLOSED and self._consecutive >= self.threshold:
                self._state = self.OPEN
                self._opened_at = time.monotonic()
                if stats is not None:
                    stats.bump(f"{self.kind}_breaker_trips")
                    self._emit(stats, "trip")

    def release_probe(self) -> None:
        """An admitted attempt declined (neither failure nor success): free
        the probe slot, so a half-open breaker does not wait for a result
        that never comes."""
        with self._lock:
            self._probe_inflight = False


# the least threads of a query's pool: one drain reads one spilled
# partition ahead while the shuffle preloads a bucket
_POOL_MIN_THREADS = 2


class ExecutionContext:
    """One query's execution state: the config, the stats, the breaker, the
    absolute deadline and the memory state (the ledger, the budget, the
    spill scope, the lineage log and the tracked buffers). The runner builds
    the breaker and the deadline once per query; a context built without
    them (tests) makes its own from ``cfg``."""

    def __init__(self, cfg: ExecutionConfig, stats: Optional[RuntimeStats] = None,
                 deadline: Optional[float] = None,
                 device_health: Optional[DeviceHealth] = None,
                 collective_health: Optional[DeviceHealth] = None):
        self.cfg = cfg
        self.stats = stats if stats is not None else RuntimeStats()
        if deadline is None and cfg.execution_timeout_s is not None:
            deadline = time.monotonic() + cfg.execution_timeout_s
        self.deadline = deadline
        self.device_health = device_health if device_health is not None else DeviceHealth(
            cfg.device_breaker_threshold, cfg.device_breaker_cooldown_s)
        # the query's mesh breaker (the runner's, or None): held here so that
        # it lives as long as the device breaker; the mesh context reads it
        self.collective_health = collective_health
        from .spill import MEMORY_LEDGER

        # every buffer of the query charges and reads this ledger
        self.ledger = MEMORY_LEDGER
        self.memory_budget = cfg.memory_budget_bytes
        self._pool = None
        self._pool_finished = False
        self._spill_scope = None
        self._lineage = None
        self._buffers: List = []
        self._accountant: Optional[ResourceAccountant] = None
        # the plan's canonical fingerprint (execute_plan stamps it): the key
        # a broadcast mispredict demotes the plan cache's entries under
        self.canonical_fp = ""
        # the live progress of the running execution (obs/cluster.py)
        self.progress = None
        # the running stream segments (stream/pipeline.py), each by its
        # shutdown: the teardown closes them even where the segment's
        # generator is out of reach (an op above it raised, and the
        # traceback keeps its suspended frame and its producers alive)
        self._active_streams: dict = {}
        # the dispatch backend of map-class partition tasks
        # (scheduler.DispatchBackend): None is the in-process pool; the
        # DistributedRunner attaches its WorkerPool
        self.dist_backend = None
        # shuffle ids whose pieces live on the workers (dist/peerplane.py):
        # finish_query drops them fleet-wide, once every root output has been
        # made local (_rooted)
        self._peer_shuffles: set = set()

    def register_peer_shuffle(self, sid: int) -> None:
        """Record a peer-hosted shuffle, dropped when the query finishes."""
        self._peer_shuffles.add(sid)

    def check_deadline(self) -> None:
        """Raise DaftTimeoutError, carrying the stats so far, once the
        query's deadline has passed. The async spill writer's recorded
        errors surface here first."""
        if self._spill_scope is not None:
            self._spill_scope.raise_async_errors()
        if self.deadline is not None and time.monotonic() > self.deadline:
            from .obs.log import get_logger

            self.stats.bump("deadline_expired")
            get_logger("scheduler").warning("deadline_expired",
                                            timeout_s=self.cfg.execution_timeout_s)
            raise DaftTimeoutError(
                f"query exceeded execution_timeout_s={self.cfg.execution_timeout_s}",
                stats=self.stats.snapshot())

    # ------------------------------------------------------------ memory state
    @property
    def spill_scope(self):
        """The query's spill directory (made on first use, removed by
        ``finish_query``)."""
        if self._spill_scope is None:
            from .spill import SpillScope

            self._spill_scope = SpillScope()
        return self._spill_scope

    @property
    def lineage(self):
        """The query's bounded LineageLog, or None with
        ``lineage_recomputation`` off."""
        if not self.cfg.lineage_recomputation:
            return None
        if self._lineage is None:
            from .integrity.lineage import LineageLog

            self._lineage = LineageLog(self.cfg.lineage_log_depth)
        return self._lineage

    def partition_buffer(self):
        """A spillable PartitionBuffer bound to this query's budget, stats,
        ledger and spill directory, after a deadline check (a breaker about
        to buffer its input proves the query still has time). Tracked, so
        that an abandoned or failed query still returns its bytes."""
        self.check_deadline()
        from .spill import PartitionBuffer

        buf = PartitionBuffer(
            self.memory_budget, self.stats, scope=self.spill_scope,
            async_spill=self.cfg.async_spill_writes,
            readahead=self._bg_submit if self.cfg.unspill_readahead else None,
            ledger=self.ledger, integrity=self.cfg.partition_integrity,
            lineage=self.lineage)
        self._buffers.append(buf)
        return buf

    @property
    def num_workers(self) -> int:
        """The query's worker count (``resolve_executor_threads``): more than
        one runs map partitions, shuffle fan-outs and stream producers at
        once. Under a distributed backend it covers the whole fleet and one
        more: a remote task holds a pool thread for its round trip."""
        from .context import resolve_executor_threads

        n = resolve_executor_threads(self.cfg)
        if self.dist_backend is not None:
            n = max(n, self.dist_backend.capacity() + 1)
        return n

    def register_stream(self, shutdown) -> object:
        """Track a running stream segment's shutdown for the teardown; the
        token unregisters it."""
        token = object()
        self._active_streams[token] = shutdown
        return token

    def unregister_stream(self, token) -> None:
        self._active_streams.pop(token, None)

    def close_streams(self, short_circuit: bool) -> None:
        """Shut every stream segment still registered. ``short_circuit``
        says whether abandoned work counts as ``morsels_short_circuited`` (a
        deliberate early stop) or not (the teardown after an error, a
        cancellation or the deadline)."""
        while self._active_streams:
            _, shutdown = self._active_streams.popitem()
            try:
                shutdown(short_circuit=short_circuit)
            except PORT_FAILURES:
                raise
            except Exception as e:
                from .obs.log import get_logger

                get_logger("execution").warning("stream_shutdown_failed", error=repr(e))

    @property
    def accountant(self) -> ResourceAccountant:
        """The query's admission control, sized from the host's cores, the
        card count of ``cfg.device`` and the memory budget."""
        if self._accountant is None:
            import os

            try:
                cores = len(os.sched_getaffinity(0))
            except AttributeError:
                cores = os.cpu_count() or 1
            self._accountant = ResourceAccountant(
                cpus=float(max(cores, self.num_workers)),
                gpus=lambda: _accelerator_count(self.cfg),  # resolved only if a task asks
                memory_bytes=self.memory_budget)
        return self._accountant

    def pool(self):
        """The query's worker pool, made on first use. A call after
        ``shutdown_pool`` (the scan readahead serving a late read) makes a
        private pool again; the garbage collector releases it with the last
        partition that holds the prefetcher, and its idle threads exit."""
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=max(_POOL_MIN_THREADS, self.num_workers),
                thread_name_prefix="daft-torch-exec")
        return self._pool

    def _bg_submit(self, fn):
        """Submit an unspill read to the query's pool; raises RuntimeError
        after shutdown (the consumer then reads itself)."""
        if self._pool_finished:
            raise RuntimeError("the query's pool is shut down")
        return self.pool().submit(fn)

    def shutdown_pool(self) -> None:
        """Cancel the queued work and wait for the running work (so that no
        background read races the spill directory's removal)."""
        self._pool_finished = True
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    # True in a mesh context: partitions are pinned to the mesh's slots and
    # processes, shuffles go through ``try_device_shuffle``, scans are split
    # by ``scan_owner``, and the sub-plan cache and the morsel stream decline
    partitions_pinned = False

    def foreign_owned(self, part: MicroPartition) -> bool:
        """True where another process must read ``part`` (the scan
        locality of a multi-process run). One process: never."""
        return False

    def prepare_broadcast(self, part: MicroPartition, on_exprs,
                          how: str = "inner") -> MicroPartition:
        """The hook of a mesh context: replicate a broadcast join's build
        side onto every device once. One device: nothing to do."""
        return part

    def finish_query(self) -> None:
        """Release every buffer's bytes, remove the spill directory and drop
        the query's peer-hosted shuffle pieces on every worker."""
        for b in self._buffers:
            b.release()
        self._buffers.clear()
        if self._spill_scope is not None:
            self._spill_scope.cleanup()
            self._spill_scope = None
        if self._peer_shuffles:
            sids, self._peer_shuffles = list(self._peer_shuffles), set()
            drop = getattr(self.dist_backend, "drop_shuffles", None)
            if drop is not None:
                try:
                    drop(sids)
                except Exception:
                    pass  # the pool mid-teardown: workers free them at exit

    # ------------------------------------------------------- breaker gates
    def _device_allowed(self) -> bool:
        """The breaker's gate for work that is device-eligible: an open
        breaker sends it to the host and counts a degraded completion."""
        if self.device_health.allow(self.stats):
            return True
        self.stats.bump("degraded_completions")
        return False

    def _device_eligible(self, part: MicroPartition) -> bool:
        return (self.cfg.use_device_kernels and len(part) >= self.cfg.device_min_rows
                and self._device_allowed())

    def _attempt_failed(self) -> None:
        """A device attempt or its fetch raised one of ``DEVICE_FAILURES``."""
        self.stats.bump("device_attempt_failures")
        self.device_health.record_failure(self.stats)

    def _device_attempt(self, fn, launch: bool = False):
        """Run one device attempt under the fault registry and the breaker.
        One of ``DEVICE_FAILURES`` counts as a breaker failure and gives
        None (the device layer's decline); a None result is a decline (the
        probe slot is freed, the breaker untouched); any other result counts
        as a success unless ``launch`` is set, where the caller's resolver
        (``_resolve``) records the outcome. Any other exception propagates
        and counts as nothing.

        In a profiled query the attempt's host time is the device_dispatch
        phase: staging and launching, and for a synchronous attempt the wait
        for its result. An asynchronous launch's kernels run after it (no
        synchronize here: it would serialize the pipeline)."""
        prof = self.stats.profiler
        t0 = time.perf_counter_ns() if prof.armed else 0
        try:
            faults.check("device.kernel", self.stats)
            out = fn()
        except DEVICE_FAILURES:
            self._attempt_failed()
            return None
        finally:
            if prof.armed:
                prof.phase("device_dispatch", time.perf_counter_ns() - t0)
        if out is None:
            self.device_health.release_probe()
        elif not launch:
            self.device_health.record_success(self.stats)
        return out

    def _resolve(self, fetch, on_host, done=None):
        """A launched attempt's resolver: ``fetch()`` under the breaker.
        Its result counts as a success and gives ``done(result)`` (the
        result itself without ``done``); a None (a decline at the fetch,
        the overflow guard) frees the probe slot, and one of
        ``DEVICE_FAILURES`` counts as a failure: both give ``on_host()``,
        which takes back the device counters and completes the partition on
        the host. ``done`` runs outside the catch, so a defect there reaches
        the caller."""
        try:
            out = fetch()
        except DEVICE_FAILURES:
            self._attempt_failed()
            return on_host()
        if out is None:
            self.device_health.release_probe()
            return on_host()
        self.device_health.record_success(self.stats)
        return out if done is None else done(out)

    def _device(self):
        from .kernels.device import resolve_device

        return resolve_device(self.cfg)

    # ------------------------------------------------------------------ sorts
    def eval_sort(self, part: MicroPartition, sort_by, descending=None,
                  nulls_first=None) -> MicroPartition:
        """A partition's sort through the device argsort when eligible (the
        keys compile and sort on the card, the payload take runs on the
        host), the host pyarrow sort otherwise."""
        if self._device_eligible(part):
            from .kernels.device import device_table_argsort

            idx = self._device_attempt(lambda: device_table_argsort(
                part.table(), sort_by, descending, nulls_first,
                stage_cache=part.device_stage_cache(), device=self._device()))
            if idx is not None:
                import numpy as np

                from .series import Series

                self.stats.bump("device_sorts")
                return MicroPartition.from_table(
                    part.table().take(Series.from_numpy(idx.astype(np.uint64), "indices")))
        self.stats.bump("host_sorts")
        return part.sort(sort_by, descending, nulls_first)

    # ------------------------------------------------- single filters and maps
    def _launch_projection(self, part: MicroPartition, exprs):
        """Stage the partition's columns and launch the projection program
        now: a zero-arg resolver that fetches the output Table, or None when
        the device layer declines the partition."""
        from .kernels.device import eval_projection_device_async

        return eval_projection_device_async(part.table(), list(exprs),
                                            stage_cache=part.device_stage_cache(),
                                            device=self._device())

    def _run_projection(self, part: MicroPartition, exprs):
        """The projection launched and fetched: a Table, or None."""
        resolve = self._launch_projection(part, exprs)
        return None if resolve is None else resolve()

    def _defer_projection(self, part: MicroPartition, exprs) -> MicroPartition:
        """A foreign-owned unloaded partition: the projection joins its
        pending ops instead of reading the file (the owner reads it)."""
        from .schema import Schema

        exprs = list(exprs)
        schema = Schema([e._node.to_field(part.schema) for e in exprs])
        return part.with_pending_op(lambda t: t.eval_expression_list(exprs), schema,
                                    count_preserving=True)

    def _defer_filter(self, part: MicroPartition, predicate) -> MicroPartition:
        return part.with_pending_op(lambda t: t.filter([predicate]), part.schema,
                                    count_preserving=False)

    def _defer_fused(self, part: MicroPartition, program) -> MicroPartition:
        return part.with_pending_op(lambda t: program.run_host(t), program.out_schema,
                                    count_preserving=program.count_preserving)

    def _deferred(self, part: MicroPartition) -> bool:
        return self.foreign_owned(part) and not part.is_loaded()

    def eval_projection(self, part: MicroPartition, exprs) -> MicroPartition:
        """A projection on the card when eligible, else on the host."""
        if self._deferred(part):
            return self._defer_projection(part, exprs)
        if self._device_eligible(part):
            out = self._device_attempt(lambda: self._run_projection(part, exprs))
            if out is not None:
                self.stats.bump("device_projections")
                return MicroPartition.from_table(out).derived_from(part)
        self.stats.bump("host_projections")
        return part.eval_expression_list(exprs)

    def eval_projection_dispatch(self, part: MicroPartition, exprs):
        """Launch a device projection without blocking; returns a zero-arg
        resolver that fetches the output partition, or None when it is
        declined (the caller then projects on the host). A failure at the
        fetch completes the partition on the host."""
        if self._deferred(part):
            deferred = self._defer_projection(part, exprs)
            return lambda: deferred
        if not self._device_eligible(part):
            return None
        resolve = self._device_attempt(lambda: self._launch_projection(part, exprs), launch=True)
        if resolve is None:
            return None
        self.stats.bump("device_projections")
        self.stats.bump("device_projection_dispatches")

        def on_host() -> MicroPartition:
            self.stats.bump("device_projections", -1)
            self.stats.bump("device_projection_fallbacks")
            self.stats.bump("host_projections")
            return part.eval_expression_list(exprs)

        return lambda: self._resolve(
            lambda: MicroPartition.from_table(resolve()).derived_from(part), on_host)

    @staticmethod
    def _compacted(part: MicroPartition, mask_table) -> MicroPartition:
        """Compact the partition on the host by a fetched filter mask."""
        return MicroPartition.from_table(
            part.table().filter_with_mask(mask_table._columns[0])).derived_from(part)

    def eval_filter(self, part: MicroPartition, predicate) -> MicroPartition:
        """A filter whose mask is computed on the card when eligible (the
        compaction runs on the host), else a host filter."""
        if self._deferred(part):
            return self._defer_filter(part, predicate)
        if self._device_eligible(part):
            out = self._device_attempt(lambda: self._run_projection(part, [predicate]))
            if out is not None:
                self.stats.bump("device_filters")
                return self._compacted(part, out)
        self.stats.bump("host_filters")
        return part.filter([predicate])

    def eval_filter_dispatch(self, part: MicroPartition, predicate):
        """Launch the device filter mask without blocking; the resolver
        fetches the mask and compacts on the host. Same contract as
        ``eval_projection_dispatch``."""
        if self._deferred(part):
            deferred = self._defer_filter(part, predicate)
            return lambda: deferred
        if not self._device_eligible(part):
            return None
        resolve = self._device_attempt(lambda: self._launch_projection(part, [predicate]),
                                       launch=True)
        if resolve is None:
            return None
        self.stats.bump("device_filters")
        self.stats.bump("device_filter_dispatches")

        def on_host() -> MicroPartition:
            self.stats.bump("device_filters", -1)
            self.stats.bump("device_filter_fallbacks")
            self.stats.bump("host_filters")
            return part.filter([predicate])

        return lambda: self._resolve(lambda: self._compacted(part, resolve()), on_host)

    def eval_distinct(self, part: MicroPartition, subset) -> MicroPartition:
        """Distinct through the device group-codes kernel when the keys are
        device-eligible (the first row of each key tuple; the take runs on
        the host), the host dictionary encode otherwise."""
        if self._device_eligible(part):
            from .expressions import col
            from .kernels.device_agg import device_distinct_indices

            keys = list(subset) if subset else [col(n) for n in part.schema.field_names()]
            idx = self._device_attempt(lambda: device_distinct_indices(
                part.table(), keys, part.device_stage_cache(), len(part),
                device=self._device()))
            if idx is not None:
                import numpy as np

                from .series import Series

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
                and max(len(lpart), len(rpart)) >= self.cfg.device_min_rows
                and self._device_allowed())

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
        the host). A probe that fails at the fetch takes the host join
        (``device_join_fallbacks``); the assembly runs outside that catch,
        so a defect there reaches the caller."""
        if not self._join_eligible(lpart, rpart, left_on, right_on, how):
            return None
        from .kernels.device_join import device_join_launch, join_key_replicas

        single = len(left_on) == 1
        launch = self._device_attempt(lambda: device_join_launch(
            lpart.table(), rpart.table(), list(left_on), list(right_on),
            lpart.device_stage_cache(), rpart.device_stage_cache(), how,
            device=self._device(),
            left_replicas=join_key_replicas(lpart, left_on[0]) if single else None,
            right_replicas=join_key_replicas(rpart, right_on[0]) if single else None),
            launch=True)
        if launch is None:
            return None
        self.stats.bump("device_join_dispatches")

        def on_host() -> MicroPartition:
            self.stats.bump("device_join_fallbacks")
            self.stats.bump("host_joins")
            return lpart.hash_join(rpart, left_on, right_on, how, suffix)

        def assemble(res) -> MicroPartition:
            out = self._assemble_join(res, lpart, rpart, left_on, right_on, how, suffix)
            self.stats.bump("device_join_probes")
            return out

        return lambda: self._resolve(launch, on_host, assemble)

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

    def _launch_agg(self, part: MicroPartition, aggregations, groupby, predicate):
        """Stage the partition and launch the fused device aggregation now:
        a zero-arg resolver that fetches the result Table (None when the
        int32 overflow guard declines), or None when the plan declines."""
        from .kernels.device_agg import device_grouped_agg_async

        return device_grouped_agg_async(
            part.table(), list(aggregations), list(groupby or []),
            stage_cache=part.device_stage_cache(), predicate=predicate,
            stats=self.stats, device=self._device())

    def _sketch_build_device(self, part: MicroPartition, aggregations, groupby, predicate):
        """Stage 1 of an all-``sketch_hll`` aggregation list with K9 (the
        register scatter, sketch/device.py) on the card: a zero-arg resolver
        (the scatter already launched) or None, a decline, which leaves the
        partition to the usual routing. The kind gate runs before the
        breaker or the fault site is touched, so another kind consumes no
        probe and no planned fault. The resolver takes one of
        ``DEVICE_FAILURES`` at the fetch as a breaker failure and completes
        the partition on the host (``device_sketch_fallbacks``); any other
        exception reaches the caller."""
        from .sketch.device import aggs_all_sketch_hll

        if (predicate is not None or not aggs_all_sketch_hll(aggregations)
                or not self._device_eligible(part)):
            return None

        def launch():
            from .sketch.device import hll_build_table_device_launch

            return hll_build_table_device_launch(part.table(), list(aggregations),
                                                 list(groupby or []), self._device())

        resolve = self._device_attempt(launch, launch=True)
        if resolve is None:
            return None
        self.stats.bump("device_sketch_builds")

        def on_host() -> MicroPartition:
            self.stats.bump("device_sketch_builds", -1)
            self.stats.bump("device_sketch_fallbacks")
            return self._eval_agg_host(part, aggregations, groupby, predicate)

        return lambda: self._resolve(resolve, on_host, MicroPartition.from_table)

    def eval_agg(self, part: MicroPartition, aggregations, groupby,
                 predicate=None) -> MicroPartition:
        """The aggregation on the card when eligible, else on the host (a
        decline of the overflow guard included). An all-HLL stage 1 builds
        its registers with K9 first (``device_sketch_builds``)."""
        fin = self._sketch_build_device(part, aggregations, groupby, predicate)
        if fin is not None:
            return fin()
        if self._device_eligible(part):
            def run():
                resolve = self._launch_agg(part, aggregations, groupby, predicate)
                return None if resolve is None else resolve()

            out = self._device_attempt(run)
            if out is not None:
                self.stats.bump("device_aggregations")
                return MicroPartition.from_table(out)
        return self._eval_agg_host(part, aggregations, groupby, predicate)

    def eval_agg_dispatch(self, part: MicroPartition, aggregations, groupby,
                          predicate=None):
        """Launch the fused device aggregation now and return a zero-arg
        resolver that fetches its result, or None when the partition is not
        device-eligible or the plan declines (the caller then runs the host
        path). The resolver completes on the host when the overflow guard
        declines or the fetch fails (``device_agg_fallbacks``). An all-HLL
        stage 1 launches K9 instead (``_sketch_build_device``)."""
        fin = self._sketch_build_device(part, aggregations, groupby, predicate)
        if fin is not None:
            return fin
        if not self._device_eligible(part):
            return None
        resolve = self._device_attempt(
            lambda: self._launch_agg(part, aggregations, groupby, predicate), launch=True)
        if resolve is None:
            return None
        self.stats.bump("device_aggregations")
        self.stats.bump("device_agg_dispatches")

        def on_host() -> MicroPartition:
            # the overflow guard (a decline) or a failure at the fetch: the
            # partition was not aggregated on the card (the probe slot is
            # freed after a failure too, as the reference's resolver does)
            self.device_health.release_probe()
            self.stats.bump("device_aggregations", -1)
            self.stats.bump("device_agg_fallbacks")
            return self._eval_agg_host(part, aggregations, groupby, predicate)

        return lambda: self._resolve(resolve, on_host, MicroPartition.from_table)

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
        return MicroPartition.from_table(program.run_host(part.table())).derived_from(part)

    def _bump_fused_device(self, program, n: int = 1) -> None:
        g = program.graph
        self.stats.bump("device_fused_maps", n)
        if g.n_project_ops:
            self.stats.bump("device_projections", n * g.n_project_ops)
        if g.n_filter_ops:
            self.stats.bump("device_filters", n * g.n_filter_ops)

    def eval_fused(self, part: MicroPartition, program) -> MicroPartition:
        """A fused map chain as ONE device program when eligible, else the
        segmented host pass (a chain with a pinned UDF has no device program)."""
        if self._deferred(part):
            return self._defer_fused(part, program)
        if program.device_exprs is not None and self._device_eligible(part):
            def run():
                out = self._run_projection(part, program.device_exprs)
                return None if out is None else program.assemble_device(out)

            out = self._device_attempt(run)
            if out is not None:
                self._bump_fused_device(program)
                return MicroPartition.from_table(out).derived_from(part)
        return self._eval_fused_host(part, program)

    def eval_fused_dispatch(self, part: MicroPartition, program):
        """Launch the fused chain's device program without blocking; returns
        a zero-arg resolver, or None when the partition is not
        device-eligible or the program declines it (an ineligible expression
        or column, or the int64 wrap guard): the caller then takes the host
        pass (``host_fused_maps``). A failure at the fetch takes the host
        pass too (``device_fused_map_fallbacks``). A chain with a pinned UDF
        has no device program and takes the host pass."""
        if self._deferred(part):
            deferred = self._defer_fused(part, program)
            return lambda: deferred
        if program.device_exprs is None or not self._device_eligible(part):
            return None
        resolve = self._device_attempt(
            lambda: self._launch_projection(part, program.device_exprs), launch=True)
        if resolve is None:
            return None
        self._bump_fused_device(program)
        self.stats.bump("device_fused_map_dispatches")

        def on_host() -> MicroPartition:
            self._bump_fused_device(program, -1)
            self.stats.bump("device_fused_map_fallbacks")
            return self._eval_fused_host(part, program)

        return lambda: self._resolve(lambda: program.assemble_device(resolve()), on_host,
                                     lambda t: MicroPartition.from_table(t).derived_from(part))

    # ------------------------------------------------------------ plan segments
    def eval_segment_dispatch(self, part: MicroPartition, op):
        """Launch a compiled plan segment (fuse/segment.py DeviceSegmentOp)
        through the resident pipeline; returns a zero-arg resolver, or None
        when the partition is not device-eligible. A resident attempt that
        declines, trips the overflow guard or fails (an armed
        ``fuse.segment`` fault among the failures) runs the staged ops and
        is counted as ``segment_fallbacks``."""
        if self._deferred(part) or not self._device_eligible(part):
            return None
        from .fuse.segment import _proc_bump, run_segment_async

        resolve = self._device_attempt(lambda: run_segment_async(
            part.table(), op.program, part.device_stage_cache(), stats=self.stats,
            cfg=self.cfg, device=self._device()), launch=True)
        if resolve is None:
            return lambda: self._eval_segment_staged(part, op, degraded=True)
        self.stats.bump("device_aggregations")
        self.stats.bump("segment_dispatches")

        def on_host() -> MicroPartition:
            # the overflow guard or a failure at the fetch: the segment did
            # NOT run resident (the probe slot is freed as above)
            self.device_health.release_probe()
            self.stats.bump("device_aggregations", -1)
            return self._eval_segment_staged(part, op, degraded=True)

        def resident(out) -> MicroPartition:
            # the map -> agg Arrow round trip of the staged plan did not happen
            self.stats.bump("device_handoffs_elided")
            op._record_resident(self)
            _proc_bump("handoffs_elided")
            return MicroPartition.from_table(out)

        def finish() -> MicroPartition:
            with self.stats.profiler.span("fuse.segment", kind="phase"):
                return self._resolve(resolve, on_host, resident)

        return finish

    def eval_segment(self, part: MicroPartition, op) -> MicroPartition:
        """A plan segment's partition through the resident pipeline when it
        is device-eligible, else through the staged ops (plain routing)."""
        fin = self.eval_segment_dispatch(part, op)
        if fin is not None:
            return fin()
        return self._eval_segment_staged(part, op, degraded=False)

    def _eval_segment_staged(self, part: MicroPartition, op,
                             degraded: bool = True) -> MicroPartition:
        """The segment as its retained staged ops: the fused map chain, Arrow
        materialization, then the (filter-fused) aggregation, exactly the
        plan the segment pass collapsed. ``degraded`` marks a resident
        attempt that declined or failed (counted), against plain routing of
        an ineligible partition (not counted)."""
        if degraded:
            from .fuse.segment import _proc_bump

            self.stats.bump("segment_fallbacks")
            _proc_bump("segment_fallbacks")
        return op.staged_agg(op.staged_map(part, self), self)


_QUERY_SEQ = itertools.count(1)
_DONE = object()  # the end of the stream, for the per-pull query-id binding


def _classify_outcome(e: BaseException) -> str:
    if isinstance(e, DaftTimeoutError):
        return "timeout"
    if isinstance(e, QueryCancelledError):
        return "cancelled"
    return "error"


def _record_query(root: PhysicalOp, ctx: ExecutionContext, query_id: str, fingerprint: str,
                  plan_ops: Dict[str, int], wall_ns: int, outcome: str, error,
                  rows_emitted: int) -> None:
    """The completion hook, on every outcome: append the QueryRecord, hand
    it to the slow and failed query capture and fold the execution into the
    FDO history. ``enable_query_log`` gates only the ring and
    ``last_query_record``: a failed query still writes its bundle when
    ``diagnostics_dir`` is set. Observability never fails the query: a
    defect here degrades to an error log line (a port failure still
    propagates)."""
    from .obs.log import get_logger

    cfg = ctx.cfg
    want_log = cfg.enable_query_log
    want_capture = cfg.diagnostics_dir or cfg.slow_query_threshold_s is not None
    rec = None
    if want_log or want_capture:
        try:
            from .obs import capture as obs_capture
            from .obs.querylog import QUERY_LOG, build_record

            prof = ctx.stats.profiler
            rec = build_record(query_id, fingerprint, plan_ops, cfg, ctx.stats, wall_ns,
                               outcome, error=error, profiled=prof.armed,
                               rows_emitted=rows_emitted, canonical=ctx.canonical_fp)
            if want_log:
                QUERY_LOG.resize(cfg.query_log_depth)
                QUERY_LOG.append(rec)
                ctx.stats.last_record = rec
            obs_capture.maybe_capture(rec, cfg, ctx.stats, prof)
        except PORT_FAILURES:
            raise
        except Exception as e:
            get_logger("obs").error("query_record_failed", error=repr(e))
    if cfg.history_fdo:
        # fold the execution's FDO observations into the process history,
        # the input of the next plan of this shape
        try:
            from .adapt.history import HISTORY

            HISTORY.fold(ctx.canonical_fp, ctx.stats, rec if rec is not None else {
                "outcome": outcome, "wall_s": wall_ns / 1e9,
                "counters": ctx.stats.snapshot()["counters"]})
        except PORT_FAILURES:
            raise
        except Exception as e:
            get_logger("obs").error("history_fold_failed", error=repr(e))


def execute_plan(root: PhysicalOp, ctx: ExecutionContext) -> Iterator[MicroPartition]:
    """Wire up the generator tree and return the root partition stream. Every
    op is wrapped with per-partition accounting (rows, self wall time and
    bytes) and, when the query's profiler is armed, with op spans. An armed
    chrome trace (tracing.chrome_trace, DAFT_TPU_TORCH_CHROME_TRACE) arms a
    profiler here when none is, as does the slow-query capture when an
    earlier run of this plan took at least ``slow_query_threshold_s``: the
    trace is rendered FROM the span tree at the query's end. Each op takes
    one of the paths of the module docstring's Scheduling. When the stream
    ends, is closed early or raises, the tree is closed, the stream segments
    still registered shut, the pool shut down, the query's buffers and spill
    directory released (``finish_query``), the query folded into the metrics
    and recorded (``_record_query``)."""
    from . import tracing
    from .obs.querylog import plan_signature

    fingerprint, plan_ops = plan_signature(root)
    # the canonical shape fingerprint the planner stamped (adapt/plancache):
    # the key a broadcast mispredict demotes under, and the record's
    ctx.canonical_fp = getattr(root, "_canonical_fp", "")
    prof = ctx.stats.profiler
    if prof.armed:
        query_id = prof.query_id
    else:
        query_id = f"q-{next(_QUERY_SEQ)}"
        arm = tracing.active()
        if not arm:
            from .obs import capture as obs_capture

            arm = obs_capture.take_arm(fingerprint)
        if arm:
            from .profile.spans import Profiler

            ctx.stats.profiler = Profiler(query_id=query_id)
    parallel = ctx.num_workers > 1

    def build(op: PhysicalOp) -> Iterator[MicroPartition]:
        # the sub-plan result cache (adapt/resultcache.py): a Project/Filter
        # chain over a scan that an earlier query materialized replays its
        # partitions, or tees them in on this first run; it fails open
        from .adapt.resultcache import try_result_cache

        served = try_result_cache(op, ctx, build)
        if served is not None:
            return served
        # the morsel pipeline (stream/): a streamable segment rooted here
        # becomes one pipelined stream
        from .stream.pipeline import try_stream

        pipe = try_stream(op, ctx, build)
        if pipe is not None:
            return pipe
        child_streams = [build(c) for c in op.children]
        if getattr(op, "batch_declared", False) and ctx.dist_backend is None:
            # a batch-declared UDF op coalesces across partitions itself: a
            # fan-out would pin each batch to one partition. Under a
            # distributed backend it falls through: the workers run its
            # map_partition and host the model actors in their processes
            return _traced(op, op.execute(child_streams, ctx), ctx)
        if (parallel and op.map_partition is not None and len(child_streams) == 1
                and op.parallel_safe()):
            # under a distributed backend the workers run the device path
            # themselves (each launches K1 and K2 on its own context), so
            # every map partition ships through the fan-out
            if (op.device_pipelinable(ctx) and not op_resource_request(op)
                    and ctx.dist_backend is None):
                # the card runs one partition after another: the first
                # partition's dispatch picks the double-buffered driver, or
                # the fan-out when it declines
                return _adaptive_device_map(op, child_streams[0], ctx)
            # instrumented inside the workers (the consumer would see only
            # its waits)
            return _parallel_map(op, child_streams[0], ctx)
        return _traced(op, op.execute(child_streams, ctx), ctx)

    return _rooted(build(root), ctx, root, query_id, fingerprint, plan_ops)


def _rooted(stream: Iterator[MicroPartition], ctx: ExecutionContext, root: PhysicalOp,
            query_id: str, fingerprint: str,
            plan_ops: Dict[str, int]) -> Iterator[MicroPartition]:
    """The root stream with its teardown. The outcome is ``ok``,
    ``abandoned`` when the consumer closed the stream early, ``timeout`` for
    a deadline, else ``error``. The query id is bound for each pull, never
    across a yield: two lazily interleaved streams on one thread would
    otherwise attribute each other's log lines."""
    from . import tracing
    from .obs import log as obs_log
    from .obs.cluster import QueryProgress, register_progress, unregister_progress

    t0 = time.perf_counter_ns()
    outcome, error = "ok", None
    rows_out = 0
    it = iter(stream)
    progress = QueryProgress(query_id, ctx.stats, plan_ops)
    ctx.progress = progress
    register_progress(progress)
    try:
        while True:
            with obs_log.query_context(query_id):
                part = next(it, _DONE)
            if part is _DONE:
                break
            if ctx._peer_shuffles:
                # a root output over peer-hosted pieces must not outlive
                # them: made local before finish_query drops the shuffles
                from .dist.peerplane import ensure_local

                with obs_log.query_context(query_id):
                    ensure_local(part)
            n = len(part)
            if n:
                rows_out += n
                progress.add_rows(n)
                if rows_out == n:
                    # time to the first row: how long the first non-empty
                    # partition took to surface
                    ctx.stats.bump("time_to_first_row_ns", time.perf_counter_ns() - t0)
            yield part
    except GeneratorExit:
        # the consumer closed the stream early (a limit, an abandoned
        # iterator): not a failure, but the plan never finished
        outcome = "abandoned"
        raise
    except BaseException as e:
        outcome, error = _classify_outcome(e), e
        raise
    finally:
        try:
            with obs_log.query_context(query_id):
                try:
                    # close the tree before the pool goes: an op suspended at
                    # a yield releases its partitions now, not at garbage
                    # collection
                    close = getattr(it, "close", None)
                    if close is not None:
                        close()
                finally:
                    # a segment suspended below an op whose raise ended the
                    # chain is out of close()'s reach: shut it directly. Only
                    # a deliberate early stop counts short-circuits
                    ctx.close_streams(short_circuit=outcome in ("ok", "abandoned"))
                    ctx.shutdown_pool()
                    ctx.finish_query()
                    prof = ctx.stats.profiler
                    prof.finish()
                    if tracing.active() and prof.armed:
                        # the span tree into chrome events, then the armed
                        # file rewritten (the buffer kept: the next query
                        # appends to the same writer); a file that cannot
                        # be written never fails the query
                        try:
                            tracing.add_span_events(prof)
                            tracing.flush_query()
                        except OSError as e:
                            obs_log.get_logger("obs").error("chrome_trace_flush_failed",
                                                            error=repr(e))
                    from .profile.metrics import record_query_metrics

                    wall_ns = time.perf_counter_ns() - t0
                    record_query_metrics(ctx.stats, wall_ns)
                    _record_query(root, ctx, query_id, fingerprint, plan_ops, wall_ns,
                                  outcome, error, rows_out)
                    tracing.query_finished()
        finally:
            unregister_progress(progress)
            ctx.progress = None


def _adaptive_device_map(op: PhysicalOp, child: Iterator[MicroPartition],
                         ctx: ExecutionContext) -> Iterator[MicroPartition]:
    """Dispatch the first partition: accepted, the whole stream runs through
    the double-buffered sequential driver (the launched resolver handed over
    as ``_primed``, nothing recomputes); declined (fewer rows than
    ``device_min_rows``, an ineligible plan), the stream, first partition
    included, goes to the worker pool (``_parallel_map``).

    An unloaded scan partition whose row count is unknown (a pushed filter)
    is read by this dispatch to route it by its rows, where the reference
    routes it to the pool unread; the read then runs under the task retry
    contract the pool's task would give it (``scheduler.run_retrying``)."""
    from .scheduler import run_retrying

    it = iter(child)
    first = next(it, None)
    if first is None:
        yield from _traced(op, op.execute([iter(())], ctx), ctx)
        return
    if first.num_rows_or_none() is None:
        dispatch = run_retrying(lambda: op.map_partition_dispatch(first, ctx), ctx,
                                op.name(), 0)
    else:
        dispatch = op.map_partition_dispatch(first, ctx)
    if dispatch is None:
        yield from _parallel_map(op, itertools.chain([first], it), ctx)
        return
    yield from _traced(op, op._map_execute([it], ctx, _primed=dispatch), ctx)


def _parallel_map(op: PhysicalOp, child: Iterator[MicroPartition],
                  ctx: ExecutionContext) -> Iterator[MicroPartition]:
    """A map op's partitions as tasks on the query's pool, a bounded window
    of them in flight and the outputs in order. Each task records its op's
    rows and wall time on its worker (``dispatch`` opens its op span there,
    parented to the consumer's span)."""
    from . import tracing
    from .scheduler import PartitionTask, dispatch, run_map_task

    name = op.name()
    req = op_resource_request(op)

    def run_one(part, seq=0):
        out, rows, dt = run_map_task(op, part, ctx, name, seq)
        if rows is None:
            n = out.num_rows_or_none()
            rows = n if n is not None else 0
        ctx.stats.record_op(name, rows, dt, _part_bytes(out))
        prof = ctx.stats.profiler
        if prof.armed:
            sp = prof.current()  # the task's span, opened by dispatch
            if sp is not None:
                sp.set_attr("rows", rows)
        return out

    saw_any = False

    def tasks():
        nonlocal saw_any
        for i, part in enumerate(child):
            saw_any = True
            yield PartitionTask(part, lambda p, _i=i: run_one(p, _i), req, name, i)

    for out in dispatch(tasks(), ctx):
        n = out.num_rows_or_none()
        tracing.report_progress(name, n if n is not None else 0)
        yield out
    if not saw_any:
        yield from op.map_empty(ctx)
    if ctx.progress is not None:
        ctx.progress.op_done(name)


def _part_bytes(part: MicroPartition) -> int:
    """Output bytes for the throughput view: loaded partitions only, so that
    the accounting never reads a file."""
    if not part.is_loaded():
        return 0
    b = part.size_bytes()
    return b if b is not None else 0


_tl = threading.local()


def _traced(op: PhysicalOp, stream: Iterator[MicroPartition],
            ctx: ExecutionContext) -> Iterator[MicroPartition]:
    """Per-partition accounting of one op. Pulling ``next(stream)`` runs the
    child wrappers on this same thread, so each wrapper pushes a frame,
    adds its INCLUSIVE time to its parent's frame and records inclusive
    minus children as its own wall time: ``op_wall_ns`` ranks operators by
    where the time is spent, not by depth. An armed profiler's op span
    covers the same interval, and the profile's self time subtracts the
    same child op spans, so the two reconcile by construction."""
    from . import tracing

    name = op.name()
    stats = ctx.stats
    it = iter(stream)
    seq = 0
    while True:
        if stats.is_cancelled():
            raise QueryCancelledError(f"query cancelled (at {name})")
        ctx.check_deadline()
        stack = getattr(_tl, "stack", None)
        if stack is None:
            stack = _tl.stack = []
        stack.append(0)
        prof = stats.profiler
        sp = prof.begin(name, op=name, part=seq) if prof.armed else None
        t0 = time.perf_counter_ns()
        pulled = False
        try:
            part = next(it)
            pulled = True
        except StopIteration:
            progress = getattr(ctx, "progress", None)
            if progress is not None:
                progress.op_done(name)
            return
        finally:
            dt = time.perf_counter_ns() - t0
            child_ns = stack.pop()
            if stack:
                stack[-1] += dt
            if sp is not None:
                # the final StopIteration pull is not a partition: its span
                # closes unrecorded, so per-op partition counts stay exact
                (prof.end if pulled else prof.cancel)(sp)
        # an unloaded partition's rows without reading it (0 when unknown):
        # the accounting never moves a read off the op that needs the rows
        n = part.num_rows_or_none()
        rows = n if n is not None else 0
        stats.record_op(name, rows, max(dt - child_ns, 0), _part_bytes(part))
        if sp is not None:
            sp.set_attr("rows", rows)
        seq += 1
        tracing.report_progress(name, rows)
        yield part
