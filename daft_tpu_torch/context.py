"""Global context + execution config (the port's copy of the part of
daft_tpu/context.py this slice reads).

The port runs its device path on the card by default: ``use_device_kernels``
is on and ``device`` is ``"cuda"``. A caller that wants the CPU says so with
``device="cpu"`` (the tests do); asking for ``cuda`` where there is none
raises instead of running on the CPU.

The planning knobs take the reference's defaults: the plan cache
(``plan_cache``, capped at ``plan_cache_bytes``), feedback-directed planning
(``history_fdo``) and the whole-plan result cache of ``collect``
(``enable_result_cache``) are on; adaptive execution (``enable_aqe``, with
``shuffle_target_partition_bytes``) is off.

The scan knobs size and merge scan tasks, retry their reads and read
ahead of the consumer (``scan_prefetch_depth``, 2 as in the reference); the
sub-plan result cache (``subplan_result_cache``, capped at
``subplan_cache_bytes``) is on, as in the reference. ``num_preview_rows``
is the row count of a collected DataFrame's ``repr``.

The batching knobs (``dynamic_batching``, ``batch_max_rows``,
``batch_max_bytes``, ``batch_flush_ms``, ``batch_padding``) shape the
batches of batch-declared UDFs (batch/), and ``model_cache_bytes`` caps the
pinned model actors' resident weights.

The observability knobs (``enable_profiling``, ``enable_query_log``,
``query_log_depth``, ``slow_query_threshold_s``, ``diagnostics_dir``,
``diagnostics_keep_last``) arm the profiler for every query, keep the
query log and write diagnostics bundles (profile/, obs/);
``DaftContext.last_profile()`` is the latest profiled query's
QueryProfile. DAFT_TPU_TORCH_PROGRESS=1 turns on the terminal progress
bars (tracing.py).

The scheduling knobs take the reference's defaults: ``executor_threads``
(0: one worker thread per core on a host of 4 or more cores, else one;
``resolve_executor_threads``) and ``max_task_backlog`` (-1: one queued task
per worker) size the query's pool and its dispatch window;
``parallel_shuffle_fanout`` splits a shuffle's input partitions on that
pool; ``task_retry_attempts`` and ``task_retry_backoff_s`` re-run a
partition task that raised a transient error. ``default_morsel_size``
splits a large in-memory source into morsels on the host path. The
streaming knobs (``streaming_execution``, ``morsel_size_rows``,
``stream_channel_capacity``, ``stream_producer_window``) shape the morsel
pipeline (stream/).

The distributed knobs take the reference's defaults:
``distributed_workers`` (0: off) sizes the pool of worker processes
(dist/), ``worker_heartbeat_interval_s``/``_timeout_s``,
``worker_spawn_timeout_s``, ``worker_restart_budget`` and
``dist_task_max_attempts`` bound its supervision, ``cluster_telemetry``
folds the workers' telemetry into the query, ``peer_shuffle`` keeps
shuffle pieces on the workers, ``distributed_workers_min``/``_max`` with
``elastic_*`` scale it, ``worker_drain_grace_s``/``_timeout_s`` bound a
drain, and the ``speculat*`` knobs duplicate straggling tasks. Each worker
runs under this config's ``device``.

The runner is NativeRunner unless ``set_runner_mesh()`` (or
``set_runner("mesh")``, or DAFT_TPU_TORCH_RUNNER=mesh at import) selects
``MeshRunner`` over ``default_mesh()``, or ``set_runner("distributed")``
(or DAFT_TPU_TORCH_RUNNER=distributed) the ``DistributedRunner``;
``distributed_workers > 0`` alone also selects it while the runner is
native, and 0 goes back. An installed runner
(``ctx._runner = MeshRunner(mesh)``) is kept until the next ``set_runner``.

Left out: the rest of the planning config (the artifact directory) and the
serving knobs (ROADMAP Queue 1, item 10).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Optional


@dataclasses.dataclass
class ExecutionConfig:
    """Knobs consulted at physical planning / execution time."""

    # route eligible aggregations through the torch device layer
    # (kernels/device_agg.py); host pyarrow path otherwise
    use_device_kernels: bool = True
    # partitions smaller than this stay on the host path (a decline)
    device_min_rows: int = 4096
    # the torch device the device layer stages onto: "cuda" (the card) or
    # "cpu" (the kernels' plain versions, for tests)
    device: str = "cuda"
    # the counterpart of jax_enable_x64 in daft_tpu: False is the 32-bit
    # device mode a TPU runs (int64 narrows to int32 when it fits, float64
    # always computes as float32); True is the 64-bit mode (int64 and
    # float64 stage and compute at full width, epoch temporals as int64,
    # counts in int64), daft_tpu's default where x64 is on
    device_x64: bool = False
    # batch every float sum of a fused aggregation through the masked
    # segment-sums kernel (kernels/segment_sums.py)
    use_segment_sums_kernel: bool = True
    # evaluate the filter and the derived float-sum columns inside the
    # segment-sums kernel: the deep-fused kernel K2
    # (kernels/fused_expr_sums.py), opt-in as in daft_tpu
    use_deep_fusion_kernel: bool = False
    # collapse Project/Filter chains into one fused map op (fuse/compile.py)
    expr_fusion: bool = True
    # compile project -> filter -> agg segments into device-resident
    # DeviceSegmentOps (fuse/segment.py); needs use_device_kernels
    device_residency: bool = True
    # a join side whose estimated size is at most this many bytes is
    # broadcast (BroadcastJoinOp) instead of hash-joined
    broadcast_join_size_bytes_threshold: int = 10 * 1024 * 1024
    # key rows sampled per output partition of a range shuffle (the
    # boundaries of a sort over several partitions)
    sample_size_for_sort: int = 20
    # runtime join filters (exchange/joinfilter.py): the build side's keys
    # make a Bloom + min-max filter that prunes the probe side before its
    # exchange or its broadcast probe; the join re-checks every row kept
    runtime_join_filters: bool = True
    # fold the stage-1 pieces bound for one bucket of a two-stage
    # aggregate's shuffle through the stage-2 merge as they arrive
    # (exchange/combine.py); only exact merges fold
    hierarchical_exchange_combine: bool = True
    # approx_count_distinct and approx_percentiles over several partitions
    # plan as sketch and merge stages whose exchange ships serialized
    # sketches (daft_tpu_torch/sketch/); False shuffles or gathers the raw
    # rows instead
    sketch_aggregations: bool = True
    # query deadline: the runner turns it into one absolute deadline at run
    # start, checked on every partition pull and before a pipeline breaker
    # buffers its input; expiry raises DaftTimeoutError with the partial
    # stats. None is no limit; 0 is a limit
    execution_timeout_s: Optional[float] = None
    # device circuit breaker (execution.DeviceHealth): after this many
    # consecutive failures of device attempts the breaker opens and every
    # device-eligible partition of the query takes the host path ...
    device_breaker_threshold: int = 3
    # ... until the cooldown has passed; then one probe tries the card
    # again: success closes the breaker, failure opens it again
    device_breaker_cooldown_s: float = 30.0
    # bounded-memory execution (spill.py): past this many engine-held bytes
    # the pipeline breakers' partition buffers (the shuffle's buckets, the
    # join sides, the sort-merge buckets) spill partitions to arrow IPC
    # files and read them back lazily; None is no budget
    memory_budget_bytes: Optional[int] = None
    # spill writes run on a bounded writer thread per query; a failed write
    # holds the partition in memory, as a synchronous one does
    async_spill_writes: bool = True
    # draining a spilled buffer reads the next spilled partition back on a
    # background thread; the shuffle preloads bucket i+1 while bucket i merges
    unspill_readahead: bool = True
    # dictionary-encode the low-cardinality columns of the shuffle's pieces
    # before they enter the buckets (exchange/encode.py); engages only under
    # a memory budget
    exchange_payload_encoding: bool = True
    # a crc32 of each spill file and encoded piece, verified when it is read
    # back; a mismatch raises DaftCorruptionError
    partition_integrity: bool = True
    # a spilled partition with a recipe (integrity/lineage.py) is recomputed
    # when its file is corrupt or missing; the recipes a query keeps
    lineage_recomputation: bool = True
    lineage_log_depth: int = 4096
    # adaptive execution (adaptive.py): run the stages under joins first and
    # plan the rest from their real sizes
    enable_aqe: bool = False
    # the bytes one exchange partition should hold: adaptive execution
    # shrinks a repartition of a known size, and feedback-directed planning
    # an aggregate's exchange, to ceil(bytes / this) partitions
    shuffle_target_partition_bytes: int = 64 * 1024 * 1024
    # DataFrame.collect serves a plan it has materialized for a DataFrame
    # that is still alive (runners.PartitionSetCache)
    enable_result_cache: bool = True
    # the plan cache (adapt/plancache.py): a repeated query shape reuses its
    # optimized and translated plan, skipping optimize, translate and the
    # fuse and segment compiles ...
    plan_cache: bool = True
    # ... up to this many bytes of plans and the partitions they pin
    plan_cache_bytes: int = 64 * 1024 * 1024
    # feedback-directed planning (adapt/fdo.py): the sizes recorded for a
    # repeated shape flip a join to broadcast and shrink an aggregate's
    # exchange
    history_fdo: bool = True
    # read_parquet/read_csv/read_json merge files smaller than the minimum
    # into one scan task up to the maximum; a parquet file past the maximum
    # splits into runs of row groups of about the minimum
    scan_tasks_min_size_bytes: int = 96 * 1024 * 1024
    scan_tasks_max_size_bytes: int = 384 * 1024 * 1024
    # a scan task's read retries a transient error (an OSError that is not a
    # missing file, a permission or a directory) this many attempts in all,
    # with jittered exponential backoff from this many seconds
    scan_retry_attempts: int = 3
    scan_retry_backoff_s: float = 0.1
    # reading scan partition i submits the reads of partitions
    # i+1..i+depth to the query's pool (io/prefetch.py); 0 reads each
    # partition on the consumer's thread when it is asked for
    scan_prefetch_depth: int = 2
    # the sub-plan result cache (adapt/resultcache.py): the partitions of a
    # Project/Filter chain over a scan replay in a later query that plans
    # the same prefix, up to this many bytes, charged to the memory
    # ledger's subplan_cache_bytes account
    subplan_result_cache: bool = True
    subplan_cache_bytes: int = 64 * 1024 * 1024
    # rows a collected DataFrame's repr previews
    num_preview_rows: int = 8
    # rows of a morsel of a large in-memory source under an aggregate on the
    # host path: a partition of more than twice this many rows splits at
    # plan time into at most 4 * executor threads morsels
    default_morsel_size: int = 128 * 1024
    # worker threads of a query's pool, which runs map partitions, shuffle
    # fan-outs and stream producers: 0 is one per core on a host of at least
    # 4 cores (one below that), 1 runs maps in order on the consumer's thread
    executor_threads: int = 0
    # tasks queued beyond the workers in the dispatch window; -1 is one per
    # worker
    max_task_backlog: int = -1
    # the map side of a hash or random shuffle (read, hash, split) runs as
    # ordered partition tasks on the pool; off splits on the consumer's thread
    parallel_shuffle_fanout: bool = True
    # a partition task that raises a transient error re-runs this many extra
    # times (0: none), after this many seconds of backoff
    task_retry_attempts: int = 2
    task_retry_backoff_s: float = 0.05
    # the morsel pipeline (stream/): a chain of Project/Filter/FusedMap ops
    # (and a Limit above it) over a scan or in-memory source pulls morsels of
    # morsel_size_rows through bounded channels; results equal those with it
    # off. On the device path it engages only in device-morsel mode (every
    # map device-pipelinable, an in-memory partition above the morsel size)
    streaming_execution: bool = True
    morsel_size_rows: int = 128 * 1024
    # morsels a source partition's channel holds before its producer waits
    stream_channel_capacity: int = 4
    # producers in flight; 0 is one per worker
    stream_producer_window: int = 0
    # batch-declared UDFs (udf.batch_udf, udf(..., batching=...)) run through
    # the BatchingExecutor (batch/): partitions coalesce across their
    # boundaries into batches under the row/byte budget below, and results
    # re-split to the exact source boundaries. The results equal those with
    # this off (the per-partition UDF path)
    dynamic_batching: bool = True
    # a batch closes when EITHER bound is reached (a declaration's values
    # override these per UDF)
    batch_max_rows: int = 4096
    batch_max_bytes: int = 32 * 1024 * 1024
    # a batch older than this flushes when the next partition arrives, even
    # under budget
    batch_flush_ms: float = 25.0
    # "ragged" concatenates as is; "padded" pads to the next power-of-two
    # bucket (repeating the last row, sliced away after the apply)
    batch_padding: str = "ragged"
    # resident weight bytes across the pinned model actors
    # (batch/actors.ModelActorPool), charged to the ledger's
    # model_cache_bytes account; the least recently used evict past it
    model_cache_bytes: int = 512 * 1024 * 1024
    # the structured query profiler (profile/) for every query, without
    # collect(profile=True) each time. Off: the disarmed hot path is one
    # flag check that allocates nothing (guard-tested)
    enable_profiling: bool = False
    # the always-on query log (obs/querylog.py): every completed plan
    # execution appends a QueryRecord to the bounded process ring
    # (query_log(), df.last_query_record()). False turns off only the ring
    # and last_query_record; the diagnostics capture below keeps working
    enable_query_log: bool = True
    query_log_depth: int = 256
    # the slow and failed query capture (obs/capture.py): a query at least
    # this slow (seconds) arms the profiler for the NEXT run of the same
    # plan and, with diagnostics_dir set, writes a bundle. None: no slow
    # path; a failed or timed-out query always bundles with diagnostics_dir
    slow_query_threshold_s: Optional[float] = None
    # where the bundles go (None: none); only the newest
    # diagnostics_keep_last stay
    diagnostics_dir: Optional[str] = None
    diagnostics_keep_last: int = 20
    # the distributed runner (dist/): worker processes the map-class
    # partition tasks ship to over the checksummed socket transport. 0 is
    # off; N spawns N workers, each with a carved share of the memory budget
    # (memory_budget_bytes // (N + 1), the driver keeps one share), each
    # running its tasks on this config's device. The rows equal
    # NativeRunner's at every N
    distributed_workers: int = 0
    # the driver pings every worker at this interval and declares one dead
    # when no pong came within the timeout: its in-flight tasks re-dispatch
    worker_heartbeat_interval_s: float = 0.5
    worker_heartbeat_timeout_s: float = 5.0
    # spawn-to-handshake deadline of one worker process
    worker_spawn_timeout_s: float = 60.0
    # worker respawns the pool may spend in its lifetime (initial spawns are
    # free); spent, the pool degrades to in-process execution
    worker_restart_budget: int = 8
    # dispatch attempts of one task across worker losses: a task that kills
    # every worker it touches fails its query with a DaftError naming it
    dist_task_max_attempts: int = 4
    # workers piggyback a bounded telemetry fragment (spans, counter deltas,
    # log tail) on every reply, merged into the query (obs/cluster.py)
    cluster_telemetry: bool = True
    # hash and random shuffles fan out on the workers, which host their
    # pieces; a reduce bucket is a map of piece locations pulled peer to
    # peer (dist/peerplane.py). The rows equal those with it off
    peer_shuffle: bool = True
    # the elastic pool: with both bounds set the live worker count scales
    # inside [min, max]; unset keeps the fixed-size pool
    distributed_workers_min: Optional[int] = None
    distributed_workers_max: Optional[int] = None
    elastic_scale_interval_s: float = 0.5
    elastic_idle_scale_down_s: float = 10.0
    # a draining worker takes no task but serves its pieces for the grace
    # window; one whose task outlives the timeout is killed and the task
    # re-dispatches
    worker_drain_grace_s: float = 2.0
    worker_drain_timeout_s: float = 10.0
    # a remote task past speculation_quantile_factor x its op's p75 task
    # wall (at least speculation_min_s) gets a duplicate on another worker;
    # the first result wins, at most speculation_max_inflight at once
    speculative_execution: bool = True
    speculation_quantile_factor: float = 3.0
    speculation_min_s: float = 1.0
    speculation_max_inflight: int = 2


# daft_tpu ExecutionConfig field (or "jax_enable_x64") -> port field
_FROM_REFERENCE = {
    "use_device_kernels": "use_device_kernels",
    "device_min_rows": "device_min_rows",
    "use_pallas_segment_sums": "use_segment_sums_kernel",
    "use_pallas_deep_fusion": "use_deep_fusion_kernel",
    "expr_fusion": "expr_fusion",
    "device_residency": "device_residency",
    "broadcast_join_size_bytes_threshold": "broadcast_join_size_bytes_threshold",
    "sample_size_for_sort": "sample_size_for_sort",
    "runtime_join_filters": "runtime_join_filters",
    "hierarchical_exchange_combine": "hierarchical_exchange_combine",
    "sketch_aggregations": "sketch_aggregations",
    "execution_timeout_s": "execution_timeout_s",
    "device_breaker_threshold": "device_breaker_threshold",
    "device_breaker_cooldown_s": "device_breaker_cooldown_s",
    "memory_budget_bytes": "memory_budget_bytes",
    "async_spill_writes": "async_spill_writes",
    "unspill_readahead": "unspill_readahead",
    "exchange_payload_encoding": "exchange_payload_encoding",
    "partition_integrity": "partition_integrity",
    "lineage_recomputation": "lineage_recomputation",
    "lineage_log_depth": "lineage_log_depth",
    "enable_aqe": "enable_aqe",
    "shuffle_target_partition_bytes": "shuffle_target_partition_bytes",
    "enable_result_cache": "enable_result_cache",
    "plan_cache": "plan_cache",
    "plan_cache_bytes": "plan_cache_bytes",
    "history_fdo": "history_fdo",
    "scan_tasks_min_size_bytes": "scan_tasks_min_size_bytes",
    "scan_tasks_max_size_bytes": "scan_tasks_max_size_bytes",
    "scan_retry_attempts": "scan_retry_attempts",
    "scan_retry_backoff_s": "scan_retry_backoff_s",
    "subplan_result_cache": "subplan_result_cache",
    "subplan_cache_bytes": "subplan_cache_bytes",
    "scan_prefetch_depth": "scan_prefetch_depth",
    "num_preview_rows": "num_preview_rows",
    "default_morsel_size": "default_morsel_size",
    "executor_threads": "executor_threads",
    "max_task_backlog": "max_task_backlog",
    "parallel_shuffle_fanout": "parallel_shuffle_fanout",
    "task_retry_attempts": "task_retry_attempts",
    "task_retry_backoff_s": "task_retry_backoff_s",
    "streaming_execution": "streaming_execution",
    "morsel_size_rows": "morsel_size_rows",
    "stream_channel_capacity": "stream_channel_capacity",
    "stream_producer_window": "stream_producer_window",
    "dynamic_batching": "dynamic_batching",
    "batch_max_rows": "batch_max_rows",
    "batch_max_bytes": "batch_max_bytes",
    "batch_flush_ms": "batch_flush_ms",
    "batch_padding": "batch_padding",
    "model_cache_bytes": "model_cache_bytes",
    "enable_profiling": "enable_profiling",
    "enable_query_log": "enable_query_log",
    "query_log_depth": "query_log_depth",
    "slow_query_threshold_s": "slow_query_threshold_s",
    "diagnostics_dir": "diagnostics_dir",
    "diagnostics_keep_last": "diagnostics_keep_last",
    "distributed_workers": "distributed_workers",
    "worker_heartbeat_interval_s": "worker_heartbeat_interval_s",
    "worker_heartbeat_timeout_s": "worker_heartbeat_timeout_s",
    "worker_spawn_timeout_s": "worker_spawn_timeout_s",
    "worker_restart_budget": "worker_restart_budget",
    "dist_task_max_attempts": "dist_task_max_attempts",
    "cluster_telemetry": "cluster_telemetry",
    "peer_shuffle": "peer_shuffle",
    "distributed_workers_min": "distributed_workers_min",
    "distributed_workers_max": "distributed_workers_max",
    "elastic_scale_interval_s": "elastic_scale_interval_s",
    "elastic_idle_scale_down_s": "elastic_idle_scale_down_s",
    "worker_drain_grace_s": "worker_drain_grace_s",
    "worker_drain_timeout_s": "worker_drain_timeout_s",
    "speculative_execution": "speculative_execution",
    "speculation_quantile_factor": "speculation_quantile_factor",
    "speculation_min_s": "speculation_min_s",
    "speculation_max_inflight": "speculation_max_inflight",
    "jax_enable_x64": "device_x64",
}


def execution_config_from_dict(d: dict, **overrides) -> ExecutionConfig:
    """Map ``dataclasses.asdict`` of a daft_tpu ExecutionConfig, plus its
    ``jax_enable_x64`` flag, onto the port's config, so both packages run one
    query under one configuration. Knobs of subsystems the port does not have
    yet are ignored; ``overrides`` (for example ``device="cpu"``) win.

    The 32-bit device mode always computes float64 as float32, so a reference
    config that turns ``device_reduced_precision`` off maps only with
    ``jax_enable_x64`` on, where float64 computes at full width."""
    if d.get("device_reduced_precision") is False and not d.get("jax_enable_x64"):
        raise NotImplementedError(
            "the 32-bit device mode always computes float64 as float32: float64 "
            "without reduced precision needs jax_enable_x64 (device_x64=True)")
    kw = {ours: d[theirs] for theirs, ours in _FROM_REFERENCE.items() if theirs in d}
    kw.update(overrides)
    return ExecutionConfig(**kw)


def resolve_executor_threads(cfg: ExecutionConfig) -> int:
    """The worker threads of a query's pool: ``executor_threads``, or with 0
    the cores this process may run on when there are at least 4 (else 1)."""
    n = cfg.executor_threads
    if n == 0:
        try:
            cores = len(os.sched_getaffinity(0))
        except AttributeError:
            cores = os.cpu_count() or 1
        n = cores if cores >= 4 else 1
    return max(1, n)


class DaftContext:
    """Process-global context: the execution config and the runner."""

    _instance: Optional["DaftContext"] = None
    _lock = threading.Lock()

    def __init__(self):
        self.execution_config = ExecutionConfig()
        self._runner = None
        # the QueryProfile of the latest profiled collect()
        self._last_profile = None
        self._runner_name = os.environ.get("DAFT_TPU_TORCH_RUNNER", "native")
        if os.environ.get("DAFT_TPU_TORCH_PROGRESS") == "1":
            from . import tracing

            tracing.progress_bars(True)

    @classmethod
    def get(cls) -> "DaftContext":
        with cls._lock:
            if cls._instance is None:
                cls._instance = DaftContext()
            return cls._instance

    def runner(self):
        from .runners import MeshRunner, NativeRunner

        if self._runner is None:
            if self._runner_name == "mesh":
                self._runner = MeshRunner()
            elif self._runner_name == "distributed":
                from .dist.runner import DistributedRunner

                self._runner = DistributedRunner()
            else:
                self._runner = NativeRunner()
        if self._runner_name == "native":
            # distributed_workers alone turns the distributed runner on and
            # off; an installed runner (a mesh, a test's own) is kept
            dw = self.execution_config.distributed_workers
            if dw > 0 and type(self._runner) is NativeRunner:
                from .dist.runner import DistributedRunner

                self._runner = DistributedRunner()
            elif dw == 0 and type(self._runner).__name__ == "DistributedRunner":
                self._runner = NativeRunner()
        return self._runner

    def set_runner(self, name: str) -> None:
        """Select the runner by name: ``native``, ``mesh`` or ``distributed``."""
        from .errors import DaftValueError

        if name not in ("native", "mesh", "distributed"):
            raise DaftValueError(f"unknown runner {name!r}")
        self._runner_name = name
        self._runner = None

    def last_profile(self):
        """The QueryProfile of the latest profiled query in this process
        (``df.collect(profile=True)``, ``enable_profiling``), or None."""
        return self._last_profile


def get_context() -> DaftContext:
    return DaftContext.get()


def x64_enabled() -> bool:
    """The current config's device mode: True for the 64-bit one."""
    return bool(get_context().execution_config.device_x64)


def set_execution_config(config: Optional[ExecutionConfig] = None, **kwargs) -> DaftContext:
    """Install ``config`` (or the current config with ``kwargs`` replaced)."""
    ctx = get_context()
    base = config if config is not None else ctx.execution_config
    ctx.execution_config = dataclasses.replace(base, **kwargs)
    return ctx


def set_runner(name: str) -> DaftContext:
    ctx = get_context()
    ctx.set_runner(name)
    return ctx


def set_runner_native() -> DaftContext:
    return set_runner("native")


def set_runner_mesh() -> DaftContext:
    return set_runner("mesh")
