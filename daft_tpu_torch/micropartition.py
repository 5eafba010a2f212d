"""MicroPartition: the unit of execution (the port's copy of
daft_tpu/micropartition.py).

A partition holds one or more loaded Tables; concat chains tables instead of
copying them. ``device_stage_cache`` holds the columns already staged on the
card (DeviceColumns keyed by column, bucket and device), so repeated queries
over a collected partition do not copy the same columns again.

``partition_by_hash`` splits a partition for the hash shuffle chunk by chunk,
as the reference does. Left out of this slice: unloaded partitions backed by
scan tasks (with their pending-op chains, file statistics and pickling for
worker processes), the sort-merge join, the explode/pivot methods, range and
random partitioning and the writer.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from .schema import Schema
from .table import Table


class MicroPartition:
    __slots__ = ("schema", "_tables", "_lock", "_device_cache")

    def __init__(self, schema: Schema, tables: List[Table]):
        self.schema = schema
        self._tables = tables
        self._lock = threading.Lock()
        self._device_cache: Dict[Any, Any] = {}

    def device_stage_cache(self) -> Dict[Any, Any]:
        return self._device_cache

    # ------------------------------------------------------------------ ctors
    @staticmethod
    def from_table(tbl: Table) -> "MicroPartition":
        return MicroPartition(tbl.schema, [tbl])

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

    def table(self) -> Table:
        """The partition as ONE table (chained pieces concatenate once)."""
        with self._lock:
            if len(self._tables) > 1:
                self._tables = [Table.concat(self._tables)]
            return self._tables[0]

    def __len__(self) -> int:
        return sum(len(t) for t in self._tables)

    def size_bytes(self) -> int:
        return sum(t.size_bytes() for t in self._tables)

    def __repr__(self) -> str:
        return f"MicroPartition(rows={len(self)})"

    # ------------------------------------------------------------------ compute
    def eval_expression_list(self, exprs) -> "MicroPartition":
        return MicroPartition.from_table(self.table().eval_expression_list(exprs))

    def filter(self, predicate) -> "MicroPartition":
        return MicroPartition.from_table(self.table().filter(predicate))

    def sort(self, sort_keys, descending=None, nulls_first=None) -> "MicroPartition":
        return MicroPartition.from_table(self.table().sort(sort_keys, descending, nulls_first))

    def agg(self, to_agg, group_by=None) -> "MicroPartition":
        return MicroPartition.from_table(self.table().agg(to_agg, group_by))

    def distinct(self, subset=None) -> "MicroPartition":
        return MicroPartition.from_table(self.table().distinct(subset))

    def take(self, indices) -> "MicroPartition":
        return MicroPartition.from_table(self.table().take(indices))

    def slice(self, start: int, end: int) -> "MicroPartition":
        return MicroPartition.from_table(self.table().slice(start, end))

    def head(self, n: int) -> "MicroPartition":
        return MicroPartition.from_table(self.table().head(n))

    def partition_by_hash(self, exprs, num_partitions: int) -> List["MicroPartition"]:
        """``num_partitions`` partitions by row hash mod n. A row's bucket
        depends on its own values alone, so each chained table splits on its
        own and bucket i chains its pieces in order, with no concat."""
        buckets: List[List[Table]] = [[] for _ in range(num_partitions)]
        for t in self._tables:
            for i, bt in enumerate(t.partition_by_hash(exprs, num_partitions)):
                if len(bt):
                    buckets[i].append(bt)
        return [MicroPartition(self.schema, bs) if bs else MicroPartition.empty(self.schema)
                for bs in buckets]

    def hash_join(self, right: "MicroPartition", left_on, right_on, how="inner",
                  suffix="right.") -> "MicroPartition":
        return MicroPartition.from_table(
            self.table().hash_join(right.table(), left_on, right_on, how, suffix))

    @staticmethod
    def concat(parts: List["MicroPartition"]) -> "MicroPartition":
        """O(1) concat: chains the loaded tables."""
        if not parts:
            raise ValueError("concat of zero partitions")
        tables = [t for p in parts for t in p._tables]
        tables = [t for t in tables if len(t) > 0] or [tables[0]]
        return MicroPartition(parts[0].schema, tables)
