"""MicroPartition: the unit of execution (the port's copy of
daft_tpu/micropartition.py).

A partition is either loaded (one or more Tables; concat chains tables
instead of copying them) or unloaded: a scan task (a file's, a spilled
partition's slot, an encoded exchange piece) that materializes on first
use, under the partition's lock. Metadata (``len``, ``num_rows_or_none``,
``size_bytes``, the schema, and ``statistics``, the task's file statistics)
answers from the task without reading it, so routing decisions never force
a file or a spilled partition in. ``iter_chunk_tables`` reads an unloaded
file task chunk by chunk (``ScanTask.iter_chunks``: parquet one row group
at a time) without changing the partition's state. ``head`` and
``select_columns`` narrow an unloaded task through its pushdowns.
``device_stage_cache`` holds the columns already staged on the card
(DeviceColumns keyed by column, bucket and device), so repeated queries
over a collected partition do not copy the same columns again; a task
loads on the thread that asks for its table, and staging happens there.

``partition_by_hash`` and ``partition_by_range`` split a partition for the
hash and range shuffles chunk by chunk, as the reference does;
``partition_by_random`` splits the whole partition, since its draw is over
row positions; ``partition_by_value`` by exact key values.
``write_tabular`` writes the partition through io/writer.py and returns
its manifest.

An unloaded partition's task may be a ``PrefetchedScanTask``
(io/prefetch.py): its read is served from a background fetch where one
finished, its metadata answers from the wrapped task, and narrowing it
(``head``, ``select_columns``) narrows the wrapped task and abandons the
full fetch.

Scan locality of a multi-process run (parallel/): ``owner_process`` names
the one process whose rows a scan partition contributes, and every
per-partition transform (a derived table, a narrowed task, the split
pieces, a scan-task wrapper) carries it through ``derived_from``. A map op
over a foreign-owned unloaded partition does not read the file:
``with_pending_op`` appends it to a chain of deferred Table -> Table steps,
replayed when the partition materializes (so a consumer that does read it
gets the post-op rows).

Pickling (the distributed runner's transport, dist/): a loaded partition
ships its tables, an unloaded one its scan task (the worker reads the file
itself; a readahead wrapper ships the task it wraps). A deferred chain of
ops is made of closures, so such a partition loads first (the dispatch
backend declines it anyway). The staged columns of ``device_stage_cache``
never ship: they are tensors of this process's card.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

from .schema import Schema
from .stats import TableStats
from .table import Table


class MicroPartition:
    __slots__ = ("schema", "_tables", "_scan_task", "_stats", "_lock", "_device_cache",
                 "lineage_recipe", "owner_process", "_pending", "_count_preserving")

    def __init__(self, schema: Schema, tables: Optional[List[Table]] = None,
                 scan_task=None, stats: Optional[TableStats] = None):
        if (tables is None) == (scan_task is None):
            raise ValueError("MicroPartition needs exactly one of tables / scan_task")
        self.schema = schema
        self._tables = tables
        self._scan_task = scan_task
        self._stats = stats
        self._lock = threading.Lock()
        self._device_cache: Dict[Any, Any] = {}
        # a zero-arg closure that re-derives this partition's tables from
        # stable storage (integrity/lineage.py), or None: the spill layer
        # records it so that a corrupt spill file recomputes
        self.lineage_recipe = None
        # the process whose rows this partition contributes (multi-process
        # scans), the deferred map ops of a foreign-owned unloaded partition,
        # and whether those keep the task's row count
        self.owner_process: Optional[int] = None
        self._pending: Optional[List[Any]] = None
        self._count_preserving = True

    def with_pending_op(self, fn, schema: Schema, count_preserving: bool) -> "MicroPartition":
        """A map op deferred over an unloaded partition: the same task, with
        ``fn`` (Table -> Table) replayed at materialization."""
        out = MicroPartition(schema, scan_task=self._scan_task).derived_from(self)
        out._pending = list(self._pending or []) + [fn]
        out._count_preserving = self._count_preserving and count_preserving
        return out

    def derived_from(self, part: "MicroPartition") -> "MicroPartition":
        """This partition, made from ``part`` (a transform of its rows, a
        narrowed or wrapped task, a piece of it), carrying its owner."""
        self.owner_process = part.owner_process
        return self

    def _wrap(self, tbl: Table) -> "MicroPartition":
        return MicroPartition.from_table(tbl).derived_from(self)

    def device_stage_cache(self) -> Dict[Any, Any]:
        return self._device_cache

    # ------------------------------------------------------------- pickling
    def __getstate__(self):
        with self._lock:
            if self._scan_task is None:
                return {"schema": self.schema, "tables": list(self._tables),
                        "stats": self._stats, "owner": self.owner_process}
            if not self._pending:
                task = self._scan_task
                return {"schema": self.schema, "scan_task": getattr(task, "_task", task),
                        "stats": self._stats, "owner": self.owner_process}
        return {"schema": self.schema, "tables": [self.table()], "stats": self._stats,
                "owner": self.owner_process}

    def __setstate__(self, state):
        self.schema = state["schema"]
        self._tables = state.get("tables")
        self._scan_task = state.get("scan_task")
        self._stats = state.get("stats")
        self._lock = threading.Lock()
        self._device_cache = {}
        self.lineage_recipe = None
        self.owner_process = state.get("owner")
        self._pending = None
        self._count_preserving = True

    # ------------------------------------------------------------------ ctors
    @staticmethod
    def from_table(tbl: Table) -> "MicroPartition":
        return MicroPartition(tbl.schema, [tbl])

    @staticmethod
    def from_scan_task(task) -> "MicroPartition":
        """An unloaded partition: ``task.read()`` materializes it. A file
        task's statistics (None for other tasks) become the partition's."""
        return MicroPartition(task.materialized_schema, scan_task=task,
                              stats=getattr(task, "stats", None))

    @staticmethod
    def empty(schema: Optional[Schema] = None) -> "MicroPartition":
        schema = schema or Schema.empty()
        return MicroPartition.from_table(Table.empty(schema))

    @staticmethod
    def from_pydict(data: Dict[str, Any]) -> "MicroPartition":
        return MicroPartition.from_table(Table.from_pydict(data))

    @staticmethod
    def from_arrow(tbl) -> "MicroPartition":
        return MicroPartition.from_table(Table.from_arrow(tbl))

    # ------------------------------------------------------------------ state
    def is_loaded(self) -> bool:
        return self._scan_task is None

    def scan_task(self):
        """The task of an unloaded partition (None once loaded)."""
        return self._scan_task

    def table(self) -> Table:
        """The partition as ONE table: an unloaded one reads its task, and
        chained pieces concatenate once."""
        with self._lock:
            if self._scan_task is not None:
                tbl = self._scan_task.read()
                for fn in self._pending or ():
                    tbl = fn(tbl)
                self._pending = None
                self._tables = [tbl]
                self._scan_task = None
            if len(self._tables) > 1:
                self._tables = [Table.concat(self._tables)]
            return self._tables[0]

    def chunk_tables(self) -> List[Table]:
        """The partition's chained tables, without concatenating them (an
        unloaded one reads its task's chunks; deferred ops, defined over the
        whole partition, read it as one table)."""
        with self._lock:
            task = self._scan_task
            if task is None:
                return list(self._tables)
            if not self._pending:
                read_chunks = getattr(task, "read_chunks", None)
                tbls = list(read_chunks()) if read_chunks is not None else [task.read()]
                self._tables = [t for t in tbls if len(t)] or [Table.empty(self.schema)]
                self._scan_task = None
                return list(self._tables)
        return [self.table()]

    def iter_chunk_tables(self) -> Iterator[Table]:
        """The partition's tables, lazily: a loaded one yields its chained
        tables; an unloaded one decodes through its task's ``iter_chunks``
        (parquet one row group at a time) where it has one, without loading
        the partition (a second iteration reads again)."""
        with self._lock:
            if self._scan_task is None:
                return iter(list(self._tables))
            task = None if self._pending else self._scan_task
        if task is None or not hasattr(task, "iter_chunks"):
            return iter(self.chunk_tables())
        return (t for t in task.iter_chunks() if len(t))

    def statistics(self) -> Optional[TableStats]:
        """The file statistics of the scan task the partition came from."""
        return self._stats

    def __len__(self) -> int:
        n = self.num_rows_or_none()
        return len(self.table()) if n is None else n

    def num_rows_or_none(self) -> Optional[int]:
        """The row count without reading an unloaded task, where it is known."""
        task = self._scan_task
        if task is None:
            return sum(len(t) for t in self._tables)
        if not self._count_preserving:
            return None  # a deferred filter changes the count
        return task.num_rows()

    def size_bytes(self) -> Optional[int]:
        """The bytes held (an unloaded task's estimate; None when unknown)."""
        task = self._scan_task
        if task is None:
            return sum(t.size_bytes() for t in self._tables)
        if self._pending:
            return None  # deferred ops change the width and the count
        return task.size_bytes()

    def __repr__(self) -> str:
        if self._scan_task is not None:
            return f"MicroPartition(Unloaded {self._scan_task!r})"
        return f"MicroPartition(rows={len(self)})"

    # ------------------------------------------------------------------ conversions
    def to_arrow(self):
        return self.table().to_arrow()

    def to_pydict(self) -> Dict[str, list]:
        return self.table().to_pydict()

    def to_pylist(self) -> List[dict]:
        return self.table().to_pylist()

    def to_pandas(self):
        return self.table().to_pandas()

    # ------------------------------------------------------------------ compute
    def eval_expression_list(self, exprs) -> "MicroPartition":
        return self._wrap(self.table().eval_expression_list(exprs))

    def filter(self, predicate) -> "MicroPartition":
        return self._wrap(self.table().filter(predicate))

    def sort(self, sort_keys, descending=None, nulls_first=None) -> "MicroPartition":
        return self._wrap(self.table().sort(sort_keys, descending, nulls_first))

    def agg(self, to_agg, group_by=None) -> "MicroPartition":
        return self._wrap(self.table().agg(to_agg, group_by))

    def distinct(self, subset=None) -> "MicroPartition":
        return self._wrap(self.table().distinct(subset))

    def sample(self, fraction=None, size=None, with_replacement=False,
               seed=None) -> "MicroPartition":
        return self._wrap(self.table().sample(fraction, size, with_replacement, seed))

    def explode(self, exprs) -> "MicroPartition":
        return self._wrap(self.table().explode(exprs))

    def unpivot(self, ids, values, variable_name="variable",
                value_name="value") -> "MicroPartition":
        return MicroPartition.from_table(
            self.table().unpivot(ids, values, variable_name, value_name))

    def pivot(self, group_by, pivot_col, value_col, names, agg_fn="sum") -> "MicroPartition":
        return MicroPartition.from_table(
            self.table().pivot(group_by, pivot_col, value_col, names, agg_fn))

    def add_monotonic_id(self, partition_offset: int = 0,
                         column_name: str = "id") -> "MicroPartition":
        return MicroPartition.from_table(
            self.table().add_monotonic_id(partition_offset, column_name))

    def select_columns(self, names: List[str]) -> "MicroPartition":
        task = self._scan_task
        if task is not None:
            if self._pending:
                # the names may exist only in a deferred projection's output
                return self.with_pending_op(lambda t: t.select_columns(names),
                                            Schema([self.schema[c] for c in names]),
                                            count_preserving=True)
            # narrow the task's columns instead of reading every column
            return MicroPartition.from_scan_task(
                task.with_pushdowns(task.pushdowns.with_columns(list(names)))).derived_from(self)
        return self._wrap(self.table().select_columns(names))

    def cast_to_schema(self, schema: Schema) -> "MicroPartition":
        return self._wrap(self.table().cast_to_schema(schema))

    def take(self, indices) -> "MicroPartition":
        return self._wrap(self.table().take(indices))

    def slice(self, start: int, end: int) -> "MicroPartition":
        return self._wrap(self.table().slice(start, end))

    def head(self, n: int) -> "MicroPartition":
        task = self._scan_task
        if task is not None:
            if self._pending:
                # a limit must not push below a deferred filter: defer it too
                return self.with_pending_op(lambda t: t.head(n), self.schema,
                                            count_preserving=False)
            # narrow the task's limit instead of reading every row
            pd = task.pushdowns
            limit = n if pd.limit is None else min(pd.limit, n)
            return MicroPartition.from_scan_task(
                task.with_pushdowns(pd.with_limit(limit))).derived_from(self)
        return self._wrap(self.table().head(n))

    def partition_by_hash(self, exprs, num_partitions: int) -> List["MicroPartition"]:
        """``num_partitions`` partitions by row hash mod n."""
        return self._partition_chunkwise(
            lambda t: t.partition_by_hash(exprs, num_partitions), num_partitions)

    def partition_by_random(self, num_partitions: int, seed: int = 0) -> List["MicroPartition"]:
        """``num_partitions`` partitions by a seeded draw over the rows of the
        whole partition: per chunk, one seed would repeat its draw in every
        chunk."""
        return [self._wrap(t) for t in self.table().partition_by_random(num_partitions, seed)]

    def partition_by_range(self, exprs, boundaries: Table, descending=None,
                           nulls_first=None) -> List["MicroPartition"]:
        """``len(boundaries) + 1`` partitions by the sort keys' position
        among the boundary rows."""
        return self._partition_chunkwise(
            lambda t: t.partition_by_range(exprs, boundaries, descending, nulls_first),
            len(boundaries) + 1)

    def _partition_chunkwise(self, split, num: int) -> List["MicroPartition"]:
        """A row-local split (a row's bucket depends on its own values alone)
        of each chained table on its own: bucket i chains its pieces in
        order, with no concat."""
        tabs = self.chunk_tables()
        if len(tabs) == 1:
            return [self._wrap(t) for t in split(tabs[0])]
        buckets: List[List[Table]] = [[] for _ in range(num)]
        for t in tabs:
            for i, bt in enumerate(split(t)):
                if len(bt):
                    buckets[i].append(bt)
        return [(MicroPartition(self.schema, bs) if bs else MicroPartition.empty(self.schema))
                .derived_from(self) for bs in buckets]

    def partition_by_value(self, exprs) -> Tuple[List["MicroPartition"], Table]:
        """The rows grouped by exact key values, with the unique keys."""
        parts, uniq = self.table().partition_by_value(exprs)
        return [MicroPartition.from_table(t) for t in parts], uniq

    def write_tabular(self, root_dir: str, format: str = "parquet", compression=None,
                      partition_cols=None) -> "MicroPartition":
        """Write the partition under ``root_dir``; returns the manifest."""
        from .io.writer import write_tabular

        return MicroPartition.from_table(
            write_tabular(self.table(), root_dir, format, compression, partition_cols))

    def hash_join(self, right: "MicroPartition", left_on, right_on, how="inner",
                  suffix="right.") -> "MicroPartition":
        return MicroPartition.from_table(
            self.table().hash_join(right.table(), left_on, right_on, how, suffix))

    def sort_merge_join(self, right: "MicroPartition", left_on, right_on, how="inner",
                        suffix="right.", is_sorted=False) -> "MicroPartition":
        return MicroPartition.from_table(self.table().sort_merge_join(
            right.table(), left_on, right_on, how, suffix, is_sorted))

    @staticmethod
    def concat(parts: List["MicroPartition"]) -> "MicroPartition":
        """O(1) concat: chains the loaded tables; an unloaded input loads."""
        if not parts:
            raise ValueError("concat of zero partitions")
        tables = [t for p in parts for t in p.chunk_tables()]
        tables = [t for t in tables if len(t) > 0] or [tables[0]]
        return MicroPartition(parts[0].schema, tables)
