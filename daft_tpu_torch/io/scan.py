"""The scan layer: pushdowns, scan tasks, file globbing and IO counters
(the port's copy of daft_tpu/io/scan.py).

A ``ScanTask`` is one unit of IO work: a file (or a run of its parquet row
groups), its schema, and the pushdowns the reader applies (columns, a
filter, a limit). It is the payload of an unloaded MicroPartition: the
partition reads it on first use, each attempt under the scan retry policy
(``scan_retry_attempts``, ``scan_retry_backoff_s``) and the ``scan.read``
fault site. ``MergedScanTask`` reads several small files as one task;
``merge_scan_tasks_by_size`` packs them. ``IO_STATS`` counts what the
readers opened, read and pruned, so tests can see a pushdown reduce IO.
A remote path or glob (``s3://``, ``gs://``, ``az://``, ``hf://``, ...)
expands through the object-store client's listing (io/object_store.py).
"""

from __future__ import annotations

import glob as _glob
import os
import threading
from typing import Any, Dict, List, Optional, Sequence

from ..errors import DaftNotFoundError, DaftValueError
from ..schema import Schema
from ..stats import TableStats, filter_may_match


class IOStats:
    """Process-wide IO counters. Tests read them to see that pushdowns
    reduce IO."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with getattr(self, "_lock", threading.Lock()):
            self.files_opened = 0
            self.bytes_read = 0
            self.rows_read = 0
            self.row_groups_read = 0
            self.row_groups_pruned = 0
            self.columns_read = 0
            self.retries = 0
            self.bytes_written = 0

    def bump(self, **kw: int) -> None:
        with self._lock:
            for k, v in kw.items():
                setattr(self, k, getattr(self, k) + v)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "files_opened": self.files_opened,
                "bytes_read": self.bytes_read,
                "rows_read": self.rows_read,
                "row_groups_read": self.row_groups_read,
                "row_groups_pruned": self.row_groups_pruned,
                "columns_read": self.columns_read,
                "retries": self.retries,
                "bytes_written": self.bytes_written,
            }


IO_STATS = IOStats()


class FileFormat:
    PARQUET = "parquet"
    CSV = "csv"
    JSON = "json"
    # uncompressed arrow IPC, the spill format: it reads back at memcpy speed
    ARROW_IPC = "arrow_ipc"


class Pushdowns:
    """Pushed-down operations a reader may honor: column projection, row
    filters, and a row limit."""

    __slots__ = ("columns", "filters", "limit")

    def __init__(self, columns: Optional[List[str]] = None,
                 filters: Optional[Any] = None,  # ExprNode
                 limit: Optional[int] = None):
        self.columns = columns
        self.filters = filters
        self.limit = limit

    def is_empty(self) -> bool:
        return self.columns is None and self.filters is None and self.limit is None

    def __repr__(self) -> str:
        parts = []
        if self.columns is not None:
            parts.append(f"columns={self.columns}")
        if self.filters is not None:
            parts.append(f"filters={self.filters.display()}")
        if self.limit is not None:
            parts.append(f"limit={self.limit}")
        return f"Pushdowns({', '.join(parts)})"

    def with_columns(self, columns: Optional[List[str]]) -> "Pushdowns":
        return Pushdowns(columns, self.filters, self.limit)

    def with_filters(self, filters) -> "Pushdowns":
        return Pushdowns(self.columns, filters, self.limit)

    def with_limit(self, limit: Optional[int]) -> "Pushdowns":
        return Pushdowns(self.columns, self.filters, limit)


class ScanTask:
    """One unit of scan work: a file + format + schema + pushdowns.

    `materialized_schema` is the post-pushdown schema (column projection
    applied). `stats`/`num_rows`/`size_bytes` come from file metadata where the
    format provides it (parquet), powering pruning and planning estimates.
    """

    __slots__ = ("path", "format", "schema", "pushdowns", "storage_options",
                 "_num_rows", "_size_bytes", "stats", "row_group_ids",
                 "partition_values")

    def __init__(self, path: str, format: str, schema: Schema,
                 pushdowns: Optional[Pushdowns] = None,
                 storage_options: Optional[Dict[str, Any]] = None,
                 num_rows: Optional[int] = None, size_bytes: Optional[int] = None,
                 stats: Optional[TableStats] = None,
                 row_group_ids: Optional[List[int]] = None,
                 partition_values: Optional[Dict[str, Any]] = None):
        self.path = path
        self.format = format
        self.schema = schema
        self.pushdowns = pushdowns or Pushdowns()
        self.storage_options = storage_options or {}
        self._num_rows = num_rows
        self._size_bytes = size_bytes
        self.stats = stats
        self.row_group_ids = row_group_ids
        # hive-style partition columns: constant per file, materialized as
        # columns after the read (the values are not in the file)
        self.partition_values = partition_values

    def __repr__(self) -> str:
        return f"ScanTask({self.format}:{self.path}, {self.pushdowns!r})"

    @property
    def materialized_schema(self) -> Schema:
        if self.pushdowns.columns is None:
            return self.schema
        return self.schema.select([c for c in self.pushdowns.columns if c in self.schema])

    def num_rows(self) -> Optional[int]:
        """Exact row count after pushdowns, when knowable without IO."""
        if self.pushdowns.filters is not None:
            return None
        if self._num_rows is None:
            return None
        if self.pushdowns.limit is not None:
            return min(self._num_rows, self.pushdowns.limit)
        return self._num_rows

    def size_bytes(self) -> Optional[int]:
        return self._size_bytes

    def with_pushdowns(self, pushdowns: Pushdowns) -> "ScanTask":
        return ScanTask(self.path, self.format, self.schema, pushdowns,
                        self.storage_options, self._num_rows, self._size_bytes,
                        self.stats, self.row_group_ids, self.partition_values)

    def can_prune(self) -> bool:
        """True if file-level stats prove the pushdown filter matches no rows."""
        if self.pushdowns.filters is None or self.stats is None:
            return False
        return not filter_may_match(self.pushdowns.filters, self.stats)

    def read(self):
        """Materialize this scan task into a Table (applies pushdowns).

        Transient IO errors (``OSError``, injected faults among them) retry
        under the RetryPolicy: jittered exponential backoff with a cap.
        Permanent errors (a missing file, permissions, a directory) raise
        at once."""
        from .. import faults

        policy = self._retry_policy()

        def attempt():
            faults.check("scan.read")
            return self._read_with_partition_values()

        return policy.run(attempt)

    def _retry_policy(self):
        from ..context import get_context
        from .object_store import RetryPolicy

        cfg = get_context().execution_config
        return RetryPolicy(
            attempts=max(1, cfg.scan_retry_attempts),
            backoff_s=cfg.scan_retry_backoff_s,
            retryable=(OSError,),
            permanent=(FileNotFoundError, PermissionError, IsADirectoryError))

    def iter_chunks(self):
        """Lazily yield the chunk tables ``read()`` would produce, decoding
        parquet one row group at a time, so a consumer holds one decoded row
        group at a time. The footer/plan open and each row-group decode run
        inside the same
        retry policy + ``scan.read`` fault contract as ``read()``; the
        shared ``plan_parquet_chunks`` guarantees chunk-wise reads choose
        exactly the row groups the whole-file read would (pruning and the
        limit early stop included), so concatenated chunks are
        byte-identical content. Non-parquet formats and deferred
        partition-value filters collapse to a single whole-read chunk."""
        if (self.format != FileFormat.PARQUET
                or (self.partition_values
                    and self.pushdowns.filters is not None)):
            yield self.read()
            return
        from .. import faults
        from .readers import plan_parquet_chunks, read_parquet_chunk

        policy = self._retry_policy()

        def plan():
            faults.check("scan.read")
            return plan_parquet_chunks(self.path, self.pushdowns,
                                       self.schema, self.row_group_ids)

        pf, chosen, columns, _ = policy.run(plan)
        handle = {"pf": pf, "fresh": True}
        for rg in chosen:
            handle["fresh"] = True

            def attempt(rg=rg):
                if not handle["fresh"]:
                    # retrying a failed decode: the failure may live in the
                    # open file handle, so reopen it, as the whole-file path
                    # opens and reads under one policy.run
                    from .readers import open_parquet_file

                    handle["pf"] = open_parquet_file(self.path)
                    IO_STATS.bump(files_opened=1)
                handle["fresh"] = False
                faults.check("scan.read")
                return read_parquet_chunk(handle["pf"], rg, columns,
                                          self.pushdowns, self.schema)

            tbl = policy.run(attempt)
            if self.partition_values:
                tbl = self._append_partition_columns(tbl)
            yield tbl

    def _read_with_partition_values(self):
        """Partition columns do not exist in the file, so a pushed-down
        filter over them waits until they are appended: the file reader
        would otherwise evaluate it against its null fill."""
        if not self.partition_values or self.pushdowns.filters is None:
            return self._read_once()
        from ..expressions import Expression
        from ..logical import expr_input_columns

        pred = Expression(self.pushdowns.filters)
        need = expr_input_columns(pred)
        if not set(need) & set(self.partition_values):
            return self._read_once()
        # the limit must also wait: a reader-side early-stop would truncate
        # BEFORE the deferred filter, dropping matching rows in unread ranges
        pd2 = self.pushdowns.with_filters(None).with_limit(None)
        if pd2.columns is not None:
            pd2 = pd2.with_columns(
                list(pd2.columns) + [c for c in need
                                     if c not in pd2.columns and c in self.schema])
        tbl = self.with_pushdowns(pd2)._read_once().filter(pred)
        want = self.materialized_schema
        if tbl.schema.field_names() != want.field_names():
            tbl = tbl.select_columns(want.field_names())
        if self.pushdowns.limit is not None:
            tbl = tbl.head(self.pushdowns.limit)
        return tbl

    def _read_once(self):
        from .readers import read_csv_table, read_json_table, read_parquet_table

        if self.format == FileFormat.PARQUET:
            tbl = read_parquet_table(self.path, self.pushdowns, schema=self.schema,
                                     row_group_ids=self.row_group_ids)
        elif self.format == FileFormat.CSV:
            tbl = read_csv_table(self.path, self.pushdowns, schema=self.schema,
                                 **self.storage_options)
        elif self.format == FileFormat.JSON:
            tbl = read_json_table(self.path, self.pushdowns, schema=self.schema)
        elif self.format == FileFormat.ARROW_IPC:
            from .readers import read_arrow_ipc_table

            tbl = read_arrow_ipc_table(self.path, self.pushdowns,
                                       schema=self.schema)
        else:
            raise DaftValueError(f"unknown scan format {self.format!r}")
        if self.partition_values:
            tbl = self._append_partition_columns(tbl)
        return tbl

    def _append_partition_columns(self, tbl):
        from ..series import Series
        from ..table import Table

        want = self.materialized_schema
        cols = list(tbl._columns)
        fields = [f for f in tbl.schema]
        for name, value in self.partition_values.items():
            if name not in want:
                continue
            f = want[name]
            s = Series.from_pylist([value] * len(tbl), name, f.dtype)
            if name in tbl.schema:
                # the file reader fills partition-only columns with nulls:
                # overwrite them with the partition value
                cols[tbl.schema.index(name)] = s
            else:
                cols.append(s)
                fields.append(f)
        from ..schema import Schema as _S

        return Table(_S(fields), cols).cast_to_schema(want)


class MergedScanTask(ScanTask):
    """Several small files read as ONE unit of scan work, so tiny files do
    not each become a partition. The children stay whole, so per-file
    pushdown narrowing and stats pruning still apply file by file."""

    __slots__ = ("children",)

    def __init__(self, children: Sequence[ScanTask]):
        first = children[0]
        st: Optional[TableStats] = first.stats
        for c in children[1:]:
            st = st.merge(c.stats) if (st is not None and c.stats is not None) else None
        nrows: Optional[int] = 0
        for c in children:
            if c._num_rows is None:
                nrows = None
                break
            nrows += c._num_rows
        sizes = [c._size_bytes for c in children]
        size = sum(sizes) if all(s is not None for s in sizes) else None
        super().__init__(first.path, first.format, first.schema, first.pushdowns,
                         first.storage_options, nrows, size, st)
        self.children = list(children)

    def __repr__(self) -> str:
        return (f"MergedScanTask({self.format}:{len(self.children)} files, "
                f"{self.pushdowns!r})")

    def with_pushdowns(self, pushdowns: Pushdowns) -> "MergedScanTask":
        return MergedScanTask([c.with_pushdowns(pushdowns) for c in self.children])

    def can_prune(self) -> bool:
        return all(c.can_prune() for c in self.children)

    def read(self):
        from ..table import Table

        chunks = self.read_chunks()
        return chunks[0] if len(chunks) == 1 else Table.concat(chunks)

    def read_chunks(self):
        """Per-child tables, cast to the merged schema but NOT concatenated:
        the shuffle splits each chunk on its own
        (MicroPartition.chunk_tables), so merged small files never pay a
        concat on the map side."""
        from ..table import Table

        tables = []
        remaining = self.pushdowns.limit
        for c in self.children:
            if c.can_prune():
                continue
            if remaining is not None:
                c = c.with_pushdowns(c.pushdowns.with_limit(remaining))
            t = c.read()
            tables.append(t)
            if remaining is not None:
                remaining -= len(t)
                if remaining <= 0:
                    break
        if not tables:
            return [Table.empty(self.materialized_schema)]
        want = self.materialized_schema
        return [t.cast_to_schema(want) for t in tables]

    def iter_chunks(self):
        """Lazy counterpart of ``read_chunks``: children decode one at a
        time (and parquet children one row group at a time), with the same
        per-child pruning, limit narrowing, and merged-schema cast — the
        running limit decrements per CHUNK, stopping at the same child the
        eager path would."""
        remaining = self.pushdowns.limit
        want = self.materialized_schema
        for c in self.children:
            if c.can_prune():
                continue
            if remaining is not None:
                c = c.with_pushdowns(c.pushdowns.with_limit(remaining))
            for t in c.iter_chunks():
                yield t.cast_to_schema(want)
                if remaining is not None:
                    remaining -= len(t)
            if remaining is not None and remaining <= 0:
                break


def merge_scan_tasks_by_size(tasks: Sequence[ScanTask],
                             min_bytes: int, max_bytes: int) -> List[ScanTask]:
    """Pack runs of adjacent small tasks into MergedScanTasks: accumulate while
    below `min_bytes`, never exceeding `max_bytes` per merged task. Tasks of
    unknown size or already at/above `min_bytes` pass through unmerged."""
    out: List[ScanTask] = []
    cur: List[ScanTask] = []
    cur_bytes = 0

    def flush():
        nonlocal cur, cur_bytes
        if len(cur) == 1:
            out.append(cur[0])
        elif cur:
            out.append(MergedScanTask(cur))
        cur, cur_bytes = [], 0

    for t in tasks:
        sz = t.size_bytes()
        if sz is None or sz >= min_bytes:
            flush()
            out.append(t)
            continue
        if cur and cur_bytes + sz > max_bytes:
            flush()
        cur.append(t)
        cur_bytes += sz
        if cur_bytes >= min_bytes:
            flush()
    flush()
    return out


def glob_paths(path) -> List[str]:
    """Expand a path, a glob, a directory or a list of them into file paths;
    a remote path or glob expands through the object store's listing."""
    if isinstance(path, (list, tuple)):
        out: List[str] = []
        for p in path:
            out.extend(glob_paths(p))
        return out
    p = str(path)
    from .object_store import is_remote_path

    if is_remote_path(p):
        from .object_store import default_io_client

        metas = default_io_client().glob(p)
        if not metas:
            raise DaftNotFoundError(f"{p!r} matched no objects")
        return [m.path for m in metas]
    if p.startswith("file://"):
        p = p[len("file://"):]
    if os.path.isdir(p):
        files = sorted(
            os.path.join(p, f) for f in os.listdir(p)
            if not f.startswith(".") and not f.startswith("_")
            and os.path.isfile(os.path.join(p, f))
        )
        if not files:
            raise DaftNotFoundError(f"no files found in directory {p!r}")
        return files
    if any(ch in p for ch in "*?["):
        files = sorted(f for f in _glob.glob(p, recursive=True) if os.path.isfile(f))
        if not files:
            raise DaftNotFoundError(f"glob {p!r} matched no files")
        return files
    if not os.path.exists(p):
        raise DaftNotFoundError(f"path {p!r} does not exist")
    return [p]
