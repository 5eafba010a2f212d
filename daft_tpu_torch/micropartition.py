"""MicroPartition: the unit of execution (the port's copy of
daft_tpu/micropartition.py).

A partition holds one or more loaded Tables; concat chains tables instead of
copying them. ``device_stage_cache`` holds the columns already staged on the
card (DeviceColumns keyed by column, bucket and device), so repeated queries
over a collected partition do not copy the same columns again.

``partition_by_hash`` and ``partition_by_range`` split a partition for the
hash and range shuffles chunk by chunk, as the reference does;
``partition_by_random`` splits the whole partition, since its draw is over
row positions. Left out of this slice: unloaded partitions backed by scan
tasks (with their pending-op chains, file statistics and pickling for worker
processes) and the writer.
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

    def sample(self, fraction=None, size=None, with_replacement=False,
               seed=None) -> "MicroPartition":
        return MicroPartition.from_table(
            self.table().sample(fraction, size, with_replacement, seed))

    def explode(self, exprs) -> "MicroPartition":
        return MicroPartition.from_table(self.table().explode(exprs))

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
        return MicroPartition.from_table(self.table().select_columns(names))

    def cast_to_schema(self, schema: Schema) -> "MicroPartition":
        return MicroPartition.from_table(self.table().cast_to_schema(schema))

    def take(self, indices) -> "MicroPartition":
        return MicroPartition.from_table(self.table().take(indices))

    def slice(self, start: int, end: int) -> "MicroPartition":
        return MicroPartition.from_table(self.table().slice(start, end))

    def head(self, n: int) -> "MicroPartition":
        return MicroPartition.from_table(self.table().head(n))

    def chunk_tables(self) -> List[Table]:
        """The partition's chained tables, without concatenating them."""
        return list(self._tables)

    def partition_by_hash(self, exprs, num_partitions: int) -> List["MicroPartition"]:
        """``num_partitions`` partitions by row hash mod n."""
        return self._partition_chunkwise(
            lambda t: t.partition_by_hash(exprs, num_partitions), num_partitions)

    def partition_by_random(self, num_partitions: int, seed: int = 0) -> List["MicroPartition"]:
        """``num_partitions`` partitions by a seeded draw over the rows of the
        whole partition: per chunk, one seed would repeat its draw in every
        chunk."""
        return [MicroPartition.from_table(t)
                for t in self.table().partition_by_random(num_partitions, seed)]

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
        if len(self._tables) == 1:
            return [MicroPartition.from_table(t) for t in split(self._tables[0])]
        buckets: List[List[Table]] = [[] for _ in range(num)]
        for t in self._tables:
            for i, bt in enumerate(split(t)):
                if len(bt):
                    buckets[i].append(bt)
        return [MicroPartition(self.schema, bs) if bs else MicroPartition.empty(self.schema)
                for bs in buckets]

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
        """O(1) concat: chains the loaded tables."""
        if not parts:
            raise ValueError("concat of zero partitions")
        tables = [t for p in parts for t in p._tables]
        tables = [t for t in tables if len(t) > 0] or [tables[0]]
        return MicroPartition(parts[0].schema, tables)
