"""Table: a schema plus equal-length Series (the port's copy of
daft_tpu/table.py). Host kernels are pyarrow compute and numpy.

The host join is ``hash_join`` (pyarrow acero, every join type), and
``join_from_indices`` assembles a join's output from the row-index pairs of
the device probe. ``partition_by_hash`` splits rows by the reference's
row hash (kernels/host_hash.py) for the hash shuffle, ``partition_by_range``
by sampled boundary rows for the range shuffle, ``partition_by_random`` by
a seeded draw, ``partition_by_value`` by exact key values for a
hive-partitioned write. ``sort_merge_join`` sorts both sides and joins them on
the host; ``explode``, ``unpivot``, ``pivot``, ``add_monotonic_id`` and
``sample`` are the host kernels of the reshaping plan nodes. Left out of
this slice: the acero fused filter+aggregate plans and the optional C++
``native`` group-code pass (group codes take the numpy route here). The
grouped aggregation keeps the bincount route (float sums and means, counts)
and the arrow hash-agg route (sum, mean, count, min, max, count_distinct,
stddev, list, any_value), the sketch subsystem's builds, merges and
estimates (``_sketch_agg_fast``), and runs the rest (skew, concat, and a kind over a
column arrow does not take) group by group over its rows sorted by group.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from .datatypes import DataType, try_unify
from .errors import DaftValueError
from .expressions import AggExpr, Alias, Expression, _eval_agg_on_series, col
from .kernels.host_hash import hash_table_columns
from .schema import Field, Schema
from .series import Series


def _downcast_key_offsets(arr):
    """large_string/large_binary -> the 32-bit-offset type when the buffer
    fits (< 2 GiB): acero's hash table is about 3x slower on 64-bit-offset
    keys."""
    if arr.nbytes < (1 << 31) - 1:
        if pa.types.is_large_string(arr.type):
            return arr.cast(pa.string())
        if pa.types.is_large_binary(arr.type):
            return arr.cast(pa.binary())
    return arr


def _as_expressions(exprs) -> List[Expression]:
    if isinstance(exprs, Expression):
        return [exprs]
    out = []
    for e in exprs:
        out.append(col(e) if isinstance(e, str) else e)
    return out



class Table:
    __slots__ = ("schema", "_columns", "_memo_by_thread", "__weakref__")

    def __init__(self, schema: Schema, columns: List[Series]):
        if len(schema) != len(columns):
            raise DaftValueError(f"schema has {len(schema)} fields but got {len(columns)} columns")
        n = len(columns[0]) if columns else 0
        for f, c in zip(schema, columns):
            if len(c) != n:
                raise DaftValueError(f"column {f.name!r} length {len(c)} != {n}")
        self.schema = schema
        self._columns = columns
        # per-thread cache of evaluated subexpressions, active only inside
        # _memo_scope (tables are immutable, so hits are always sound; the
        # scope bounds the lifetime of the cached column-sized intermediates).
        # Keyed by thread ident: the same Table may be evaluated concurrently
        # from different worker threads (shared InMemorySource partitions) and
        # the depth counter must not race across them.
        self._memo_by_thread: Dict[int, list] = {}

    # pickling (the distributed runner's transport): the schema and the
    # columns; the evaluation memo is this process's
    def __getstate__(self):
        return (self.schema, self._columns)

    def __setstate__(self, state):
        self.schema, self._columns = state
        self._memo_by_thread = {}

    @property
    def _eval_memo(self) -> Optional[Dict[Tuple, Series]]:
        state = self._memo_by_thread.get(threading.get_ident())
        return state[0] if state is not None else None

    @contextmanager
    def _memo_scope(self):
        """Share structurally-identical subexpression results across the
        evaluates of one logical pass; dropped when the outermost scope
        exits so intermediates are not pinned for the table's lifetime."""
        tid = threading.get_ident()
        state = self._memo_by_thread.get(tid)
        if state is None:
            state = self._memo_by_thread[tid] = [{}, 0]
        state[1] += 1
        try:
            yield
        finally:
            state[1] -= 1
            if state[1] == 0:
                self._memo_by_thread.pop(tid, None)

    # ------------------------------------------------------------------ ctors
    @staticmethod
    def empty(schema: Optional[Schema] = None) -> "Table":
        schema = schema or Schema.empty()
        return Table(schema, [Series.empty(f.name, f.dtype) for f in schema])

    @staticmethod
    def from_pydict(data: Dict[str, Any]) -> "Table":
        cols: List[Series] = []
        for name, vals in data.items():
            if isinstance(vals, Series):
                cols.append(vals.rename(name))
            elif isinstance(vals, (pa.Array, pa.ChunkedArray)):
                cols.append(Series.from_arrow(vals, name))
            elif isinstance(vals, np.ndarray):
                cols.append(Series.from_numpy(vals, name))
            else:
                cols.append(Series.from_pylist(list(vals), name))
        n = max((len(c) for c in cols), default=0)
        cols = [c if len(c) == n else _broadcast_series(c, n) for c in cols]
        schema = Schema([Field(c.name, c.dtype) for c in cols])
        return Table(schema, cols)

    @staticmethod
    def from_arrow(tbl: Union[pa.Table, pa.RecordBatch]) -> "Table":
        if isinstance(tbl, pa.RecordBatch):
            tbl = pa.Table.from_batches([tbl])
        tbl = tbl.combine_chunks()
        cols = [Series.from_arrow(tbl.column(i), tbl.schema.names[i]) for i in range(tbl.num_columns)]
        schema = Schema([Field(c.name, c.dtype) for c in cols])
        return Table(schema, cols)

    @staticmethod
    def from_pylist(rows: List[dict]) -> "Table":
        """One row per dict; the columns are every key, in order of first
        appearance, with None where a row lacks one."""
        keys: List[str] = []
        for r in rows:
            for k in r:
                if k not in keys:
                    keys.append(k)
        return Table.from_pydict({k: [r.get(k) for r in rows] for k in keys})

    # ------------------------------------------------------------------ basics
    def __len__(self) -> int:
        return len(self._columns[0]) if self._columns else 0

    @property
    def column_names(self) -> List[str]:
        return self.schema.field_names()

    def select_columns(self, names: List[str]) -> "Table":
        return Table(self.schema.select(names), [self.get_column(n) for n in names])

    def get_column(self, name: str) -> Series:
        return self._columns[self.schema.index(name)]

    def rename_columns(self, mapping: Dict[str, str]) -> "Table":
        return Table(self.schema.rename(mapping),
                     [c.rename(mapping.get(c.name, c.name)) for c in self._columns])

    def size_bytes(self) -> int:
        return sum(c.size_bytes() for c in self._columns)

    def to_arrow(self) -> pa.Table:
        arrays, fields = [], []
        for f, c in zip(self.schema, self._columns):
            if c.is_python():
                raise DaftValueError(f"column {f.name!r} has python dtype; no arrow representation")
            arrays.append(c.to_arrow())
            fields.append(pa.field(f.name, c.to_arrow().type))
        return pa.Table.from_arrays(arrays, schema=pa.schema(fields))

    def to_pydict(self) -> Dict[str, list]:
        return {f.name: c.to_pylist() for f, c in zip(self.schema, self._columns)}

    def to_pylist(self) -> List[dict]:
        d = self.to_pydict()
        names = list(d)
        return [dict(zip(names, vals)) for vals in zip(*d.values())] if names else []

    def to_pandas(self):
        return self.to_arrow().to_pandas()

    def __repr__(self) -> str:
        return f"Table({self.schema!r}, rows={len(self)})"

    def cast_to_schema(self, schema: Schema) -> "Table":
        cols = []
        for f in schema:
            if f.name in self.schema:
                cols.append(self.get_column(f.name).cast(f.dtype))
            else:
                cols.append(Series.full_null(f.name, f.dtype, len(self)))
        return Table(schema, cols)

    # ------------------------------------------------------------------ eval
    def eval_expression_list(self, exprs: Sequence[Expression]) -> "Table":
        exprs = _as_expressions(exprs)
        n = len(self)
        out: List[Series] = []
        names: List[str] = []
        any_agg = any(e._node.is_aggregation() for e in exprs)
        with self._memo_scope():
            for e in exprs:
                s = e._node.evaluate(self)
                out.append(s)
                names.append(e.name())
        if any_agg:
            m = max((len(s) for s in out), default=0)
        else:
            m = n
        out = [_broadcast_series(s, m) if len(s) != m else s for s in out]
        schema = Schema([Field(nm, s.dtype) for nm, s in zip(names, out)])
        return Table(schema, [s.rename(nm) for nm, s in zip(names, out)])

    # ------------------------------------------------------------------ selection
    def filter(self, predicate: Union[Expression, Sequence[Expression]]) -> "Table":
        preds = _as_expressions(predicate)
        mask: Optional[Series] = None
        with self._memo_scope():
            for p in preds:
                s = p._node.evaluate(self)
                if not s.dtype.is_boolean() and not s.dtype.is_null():
                    raise DaftValueError(f"filter predicate must be boolean, got {s.dtype}")
                mask = s if mask is None else (mask & s)
        if mask is None:
            return self
        return self.filter_with_mask(mask)

    def filter_with_mask(self, mask: Series) -> "Table":
        """Compact rows by a precomputed boolean mask (the device filter path
        computes the predicate on the TPU and hands the mask back here)."""
        mask = _broadcast_series(mask, len(self))
        m = mask._arrow
        if m is None:
            return Table(self.schema, [c.filter(mask) for c in self._columns])
        if m.null_count:
            m = pc.fill_null(m, False)
        # one multithreaded arrow-table filter instead of a per-column pass
        arrow_idx = [i for i, c in enumerate(self._columns) if c._arrow is not None]
        ftbl = None
        if arrow_idx:
            ftbl = pa.Table.from_arrays(
                [self._columns[i]._arrow for i in arrow_idx],
                names=[str(i) for i in arrow_idx]).filter(m)
        out: List[Series] = []
        for i, c in enumerate(self._columns):
            if c._arrow is None:
                out.append(c.filter(mask))
            else:
                ch = ftbl.column(str(i))
                arr = ch.chunk(0) if ch.num_chunks == 1 else ch.combine_chunks()
                out.append(Series(c._name, c._dtype, arr))
        return Table(self.schema, out)

    def distinct(self, subset: Optional[Sequence[Expression]] = None) -> "Table":
        """The first row of each distinct tuple of ``subset`` (every column
        when None), in row order; null keys form one group."""
        exprs = _as_expressions(subset) if subset else [col(n) for n in self.column_names]
        codes, _uniq = _group_codes(self.eval_expression_list(exprs))
        if len(codes) == 0:
            return self
        _, first_idx = np.unique(codes, return_index=True)
        return self.take(Series.from_arrow(pa.array(np.sort(first_idx).astype(np.uint64)),
                                           "idx"))

    def take(self, indices: Series) -> "Table":
        return Table(self.schema, [c.take(indices) for c in self._columns])

    def slice(self, start: int, end: int) -> "Table":
        return Table(self.schema, [c.slice(start, end) for c in self._columns])

    def head(self, n: int) -> "Table":
        return self.slice(0, min(n, len(self)))

    @staticmethod
    def concat(tables: List["Table"]) -> "Table":
        if not tables:
            raise DaftValueError("concat of zero tables")
        first = tables[0]
        names = first.column_names
        for t in tables[1:]:
            if t.column_names != names:
                raise DaftValueError(f"concat schema mismatch: {names} vs {t.column_names}")
        cols = []
        for i, name in enumerate(names):
            cols.append(Series.concat([t._columns[i] for t in tables]))
        schema = Schema([Field(c.name, c.dtype) for c in cols])
        return Table(schema, cols)

    # ------------------------------------------------------------------ joins
    def hash_join(self, right: "Table", left_on: Sequence[Expression],
                  right_on: Sequence[Expression], how: str = "inner",
                  suffix: str = "right.") -> "Table":
        """Hash join on pyarrow acero with SQL null semantics (null keys never
        match). Output row order is unspecified engine-wide (the device
        probe emits another order); this host join sorts by (left row, right
        row) so its own output is deterministic."""
        how_map = {
            "inner": "inner", "left": "left outer", "right": "right outer",
            "outer": "full outer", "semi": "left semi", "anti": "left anti",
        }
        if how not in how_map:
            raise DaftValueError(f"unknown join type {how!r}")
        left_on = _as_expressions(left_on)
        right_on = _as_expressions(right_on)
        lk = self.eval_expression_list(left_on)
        rk = right.eval_expression_list(right_on)
        lka, rka = [], []
        for a, b in zip(lk._columns, rk._columns):
            u = try_unify(a.dtype, b.dtype)
            if u is None:
                raise DaftValueError(f"cannot join on {a.dtype} vs {b.dtype}")
            la, ra = a.cast(u).to_arrow(), b.cast(u).to_arrow()
            # the downcast is joint per key: acero raises on string vs large_string
            la2, ra2 = _downcast_key_offsets(la), _downcast_key_offsets(ra)
            lka.append(la2 if la2.type == ra2.type else la)
            rka.append(ra2 if la2.type == ra2.type else ra)

        key_names = [f"__k{i}" for i in range(len(lka))]
        lt = pa.Table.from_arrays(
            lka + [c.to_arrow() for c in self._columns]
            + [pa.array(np.arange(len(self), dtype=np.int64))],
            names=key_names + [f"__l{i}" for i in range(len(self._columns))] + ["__lidx"])
        rt = pa.Table.from_arrays(
            rka + [c.to_arrow() for c in right._columns]
            + [pa.array(np.arange(len(right), dtype=np.int64))],
            names=key_names + [f"__r{i}" for i in range(len(right._columns))] + ["__ridx"])
        # acero builds its hash table on the RIGHT operand: keep the build on
        # the smaller table by swapping operands and flipping the join type
        # (assembly below is by column name, so orientation stays unchanged)
        if len(self) < len(right):
            flip = {"inner": "inner", "left outer": "right outer",
                    "right outer": "left outer", "full outer": "full outer",
                    "left semi": "right semi", "left anti": "right anti"}
            joined = rt.join(lt, keys=key_names, join_type=flip[how_map[how]], use_threads=True)
        else:
            joined = lt.join(rt, keys=key_names, join_type=how_map[how], use_threads=True)
        sort_keys = [(c, "ascending") for c in ("__lidx", "__ridx") if c in joined.column_names]
        if sort_keys:
            # nulls (the unmatched rows of an outer join) sort last by default
            joined = joined.take(pc.sort_indices(joined, sort_keys=sort_keys))
        joined = joined.combine_chunks()

        if how in ("semi", "anti"):
            cols = [Series.from_arrow(joined.column(f"__l{i}"), f.name, f.dtype)
                    for i, f in enumerate(self.schema)]
            return Table(Schema(list(self.schema)), cols)

        out_cols: List[Series] = []
        out_fields: List[Field] = []
        left_names = set(self.column_names)
        # join keys: one merged column named after the left key
        lk_names = [e.name() for e in left_on]
        rk_names = [e.name() for e in right_on]
        for i, kn in enumerate(key_names):
            out_cols.append(Series.from_arrow(joined.column(kn), lk_names[i]))
            out_fields.append(Field(lk_names[i], out_cols[-1].dtype))
        for i, f in enumerate(self.schema):
            if f.name in lk_names:
                continue
            s = Series.from_arrow(joined.column(f"__l{i}"), f.name, f.dtype)
            out_cols.append(s)
            out_fields.append(Field(f.name, s.dtype))
        for i, f in enumerate(right.schema):
            if f.name in rk_names:
                continue
            name = f.name if f.name not in left_names else f"{suffix}{f.name}"
            s = Series.from_arrow(joined.column(f"__r{i}"), name, f.dtype)
            out_cols.append(s)
            out_fields.append(Field(name, s.dtype))
        return Table(Schema(out_fields), out_cols)

    def sort_merge_join(self, right: "Table", left_on, right_on, how: str = "inner",
                        suffix: str = "right.", is_sorted: bool = False) -> "Table":
        """Each side sorted by its keys (unless ``is_sorted``), joined on the
        host (``hash_join``), and the output sorted by the left keys."""
        left_on = _as_expressions(left_on)
        right_on = _as_expressions(right_on)
        lt = self if is_sorted else self.sort(left_on)
        rt = right if is_sorted else right.sort(right_on)
        out = lt.hash_join(rt, left_on, right_on, how=how, suffix=suffix)
        return out.sort([col(e.name()) for e in left_on])

    def join_from_indices(self, right: "Table", lidx: np.ndarray, ridx: np.ndarray,
                          left_on, right_on, suffix: str = "right.") -> "Table":
        """Assemble a join's output from row-index pairs (the device probe,
        kernels/device_join.py). ``ridx`` entries of -1 emit nulls (left-outer
        misses). Names and order as ``hash_join``: merged key columns named
        after the left keys, then the left columns, then the right columns
        with ``suffix`` on collisions."""
        left_on = _as_expressions(left_on)
        right_on = _as_expressions(right_on)
        lk_names = [e.name() for e in left_on]
        rk_names = [e.name() for e in right_on]
        l_take = Series.from_arrow(pa.array(lidx.astype(np.uint64)), "i")
        miss = ridx < 0
        r_take = pa.array(np.where(miss, 0, ridx).astype(np.int64),
                          mask=miss if miss.any() else None)
        out_cols: List[Series] = []
        out_fields: List[Field] = []
        lkeys = self.eval_expression_list(left_on)
        for i, kn in enumerate(lk_names):
            s = lkeys._columns[i].take(l_take).rename(kn)
            out_cols.append(s)
            out_fields.append(Field(kn, s.dtype))
        left_names = set(self.column_names)
        for f in self.schema:
            if f.name in lk_names:
                continue
            s = self.get_column(f.name).take(l_take)
            out_cols.append(s)
            out_fields.append(Field(f.name, s.dtype))
        for f in right.schema:
            if f.name in rk_names:
                continue
            name = f.name if f.name not in left_names else f"{suffix}{f.name}"
            rc = right.get_column(f.name)
            s = Series.from_arrow(rc.to_arrow().take(r_take), name, rc.dtype)
            out_cols.append(s)
            out_fields.append(Field(name, s.dtype))
        return Table(Schema(out_fields), out_cols)

    # ------------------------------------------------------------------ sort
    def argsort(self, sort_keys: Sequence[Expression], descending=None, nulls_first=None) -> Series:
        sort_keys = _as_expressions(sort_keys)
        k = len(sort_keys)
        descending = _norm_flag(descending, k, False)
        nulls_first = _norm_flag(nulls_first, k, None)
        keys = [e._node.evaluate(self) for e in sort_keys]
        arrs, sort_spec, placements = [], [], []
        for i, (s, d, nf) in enumerate(zip(keys, descending, nulls_first)):
            arrs.append(_broadcast_series(s, len(self)).to_arrow())
            placements.append("at_start" if (nf if nf is not None else d) else "at_end")
            sort_spec.append((f"k{i}", "descending" if d else "ascending"))
        # pyarrow sort_keys are (name, order) pairs with ONE global
        # null_placement (per-key 3-tuples are not part of its API); keys
        # that disagree on placement fall back to a dense-rank lexsort where
        # each key's rank bakes in its own placement
        if len(set(placements)) <= 1:
            tbl = pa.Table.from_arrays(arrs, names=[f"k{i}" for i in range(k)])
            idx = pc.sort_indices(tbl, sort_keys=sort_spec,
                                  null_placement=placements[0] if placements else "at_end")
            return Series.from_arrow(idx.cast(pa.uint64()), "indices")
        ranks = [np.asarray(pc.rank(a, sort_keys="descending" if d else "ascending",
                                    null_placement=p, tiebreaker="dense"))
                 for a, d, p in zip(arrs, descending, placements)]
        idx = np.lexsort(tuple(reversed(ranks)))  # first key = primary
        return Series.from_arrow(pa.array(idx.astype(np.uint64)), "indices")

    def sort(self, sort_keys: Sequence[Expression], descending=None, nulls_first=None) -> "Table":
        return self.take(self.argsort(sort_keys, descending, nulls_first))

    # ------------------------------------------------------------------ hashing / partitioning
    def hash_rows(self, exprs: Sequence[Expression]) -> np.ndarray:
        """(n,) uint64 row hashes of ``exprs``, the seed chained across the
        columns: the reference's bits."""
        cols = []
        for e in _as_expressions(exprs):
            s = e._node.evaluate(self)
            if s.is_python():
                s = s.cast(DataType.string())
            cols.append(_broadcast_series(s, len(self)).to_arrow())
        return hash_table_columns(cols)

    def partition_by_hash(self, exprs: Sequence[Expression], num_partitions: int) -> List["Table"]:
        """Split the rows into ``num_partitions`` tables by hash mod n, each
        keeping the rows' order."""
        if num_partitions <= 0:
            raise DaftValueError("num_partitions must be positive")
        if len(self) == 0:
            return [self] * num_partitions
        buckets = (self.hash_rows(exprs) % np.uint64(num_partitions)).astype(np.int64)
        return self._split_by_buckets(buckets, num_partitions)

    def partition_by_random(self, num_partitions: int, seed: int = 0) -> List["Table"]:
        """Split the rows into ``num_partitions`` tables by a seeded draw of
        a bucket per row (the reference's RandomState stream, so equal
        seeds give equal buckets in both packages)."""
        rng = np.random.RandomState(seed & 0x7FFFFFFF)
        buckets = rng.randint(0, num_partitions, size=len(self))
        return self._split_by_buckets(buckets, num_partitions)

    def partition_by_range(self, exprs: Sequence[Expression], boundaries: "Table",
                           descending: Optional[List[bool]] = None,
                           nulls_first: Optional[List[Optional[bool]]] = None) -> List["Table"]:
        """Split the rows by comparing their sort keys with the boundary
        rows: bucket i holds the rows with i boundaries at or below them in
        the sort order (``descending`` and ``nulls_first`` per key; a
        ``nulls_first`` of None means the sort's default, nulls last
        ascending and first descending)."""
        exprs = _as_expressions(exprs)
        k = len(exprs)
        descending = _norm_flag(descending, k, False)
        nulls_first = list(nulls_first) if nulls_first is not None else [None] * k
        nb = len(boundaries)
        if nb == 0:
            return [self]
        keys = [_broadcast_series(e._node.evaluate(self), len(self)) for e in exprs]
        ranks = _composite_rank(keys, list(boundaries._columns), descending, nulls_first)
        return self._split_by_buckets(ranks, nb + 1)

    def partition_by_value(self, exprs: Sequence[Expression]) -> Tuple[List["Table"], "Table"]:
        """The rows grouped by their exact key values (nulls form a group):
        (one table per key, the table of unique keys), in order of first
        appearance."""
        keyed = self.eval_expression_list(_as_expressions(exprs))
        codes, uniq = _group_codes(keyed)
        return self._split_by_buckets(codes, len(uniq)), uniq

    def _split_by_buckets(self, buckets: np.ndarray, num: int) -> List["Table"]:
        """Tables 0..num-1 of the rows of each bucket, in row order."""
        if len(self) == 0:
            return [self.slice(0, 0) for _ in range(num)]
        order = np.argsort(buckets, kind="stable")
        offs = np.concatenate([[0], np.cumsum(np.bincount(buckets, minlength=num))])
        sorted_tbl = self.take(Series.from_arrow(pa.array(order.astype(np.uint64)), "idx"))
        return [sorted_tbl.slice(int(offs[i]), int(offs[i + 1])) for i in range(num)]

    def sample(self, fraction: Optional[float] = None, size: Optional[int] = None,
               with_replacement: bool = False, seed: Optional[int] = None) -> "Table":
        """``round(fraction * n)`` rows, or ``size``, drawn from a
        RandomState(``seed``) (unseeded when None): with replacement
        ``randint`` draws, without it the first rows of a permutation (all
        rows when there are fewer)."""
        if fraction is None and size is None:
            raise DaftValueError("sample requires either fraction or size")
        n = len(self)
        k = int(round(n * fraction)) if fraction is not None else int(size)
        rng = np.random.RandomState(seed)
        if with_replacement:
            idx = rng.randint(0, max(n, 1), size=k) if n else np.empty(0, np.int64)
        else:
            idx = rng.permutation(n)[:min(k, n)]
        return self.take(Series.from_arrow(pa.array(idx.astype(np.uint64)), "idx"))

    # ------------------------------------------------------------------ reshaping
    def explode(self, exprs: Sequence[Expression]) -> "Table":
        """One row per list element of the ``exprs`` columns (equal list
        lengths per row); an empty or null list gives one null row. The
        other columns repeat."""
        exprs = _as_expressions(exprs)
        list_cols: Dict[str, Series] = {}
        for e in exprs:
            s = e._node.evaluate(self)
            if not s.dtype.is_list():
                raise DaftValueError(
                    f"explode requires list column, got {s.dtype} for {e.name()!r}")
            list_cols[e.name()] = _broadcast_series(s, len(self))
        lens = None
        for s in list_cols.values():
            ln = np.asarray(pc.fill_null(pc.list_value_length(s.to_arrow()), 0), dtype=np.int64)
            if lens is not None and not np.array_equal(ln, lens):
                raise DaftValueError("exploded columns must have equal list lengths per row")
            lens = ln
        out_lens = np.maximum(lens, 1)
        repeat_idx = Series.from_arrow(
            pa.array(np.repeat(np.arange(len(self), dtype=np.int64), out_lens)), "i")
        out_cols: List[Series] = []
        out_fields: List[Field] = []
        for f, c in zip(self.schema, self._columns):
            if f.name in list_cols:
                flat = _explode_series(list_cols[f.name], out_lens).rename(f.name)
                out_cols.append(flat)
                out_fields.append(Field(f.name, flat.dtype))
            else:
                out_cols.append(c.take(repeat_idx))
                out_fields.append(f)
        return Table(Schema(out_fields), out_cols)

    def unpivot(self, ids: Sequence[Expression], values: Sequence[Expression],
                variable_name: str = "variable", value_name: str = "value") -> "Table":
        """Wide to long: for each value column in turn, every row's ``ids``,
        the column's name and its value (cast to the value columns' unified
        type)."""
        ids = _as_expressions(ids)
        values = _as_expressions(values)
        if not values:
            raise DaftValueError("unpivot requires at least one value column")
        n = len(self)
        m = len(values)
        val_series = [e._node.evaluate(self) for e in values]
        vdt = val_series[0].dtype
        for s in val_series[1:]:
            u = try_unify(vdt, s.dtype)
            if u is None:
                raise DaftValueError(
                    f"unpivot value columns have incompatible types {vdt} vs {s.dtype}")
            vdt = u
        out_cols: List[Series] = []
        out_fields: List[Field] = []
        if ids:
            id_tbl = self.eval_expression_list(ids)
            tile_idx = Series.from_arrow(pa.array(np.tile(np.arange(n, dtype=np.int64), m)), "i")
            for f, c in zip(id_tbl.schema, id_tbl._columns):
                out_cols.append(c.take(tile_idx))
                out_fields.append(f)
        names = pa.array([e.name() for e in values], DataType.string().to_arrow())
        variable = names.take(pa.array(np.repeat(np.arange(m, dtype=np.int64), n)))
        out_cols.append(Series.from_arrow(variable, variable_name, DataType.string()))
        out_fields.append(Field(variable_name, DataType.string()))
        out_cols.append(Series.concat([s.cast(vdt) for s in val_series]).rename(value_name))
        out_fields.append(Field(value_name, vdt))
        return Table(Schema(out_fields), out_cols)

    def pivot(self, group_by: Sequence[Expression], pivot_col: Expression,
              value_col: Expression, names: List[str], agg_fn: str = "sum") -> "Table":
        """One row per ``group_by`` tuple, then one column per name:
        ``agg_fn`` of ``value_col`` over the rows whose ``pivot_col`` equals
        the name (null where there are none)."""
        group_by = _as_expressions(group_by)
        pivot_e = _as_expressions(pivot_col)[0]
        value_e = _as_expressions(value_col)[0]
        agg_e = Expression(AggExpr(agg_fn, value_e._node))
        grouped = self.agg([agg_e.alias("__v")], group_by + [pivot_e])
        key_names = [e.name() for e in group_by]
        keys = [col(n) for n in key_names]
        piv = col(pivot_e.name())
        out = grouped.distinct(keys).select_columns(key_names)
        for nm in names:
            sub = grouped.filter(piv == nm if nm is not None else piv.is_null())
            sub = sub.select_columns(key_names + ["__v"]).rename_columns({"__v": str(nm)})
            out = out.hash_join(sub, keys, keys, how="left")
        return out

    def add_monotonic_id(self, partition_offset: int = 0, column_name: str = "id") -> "Table":
        """A uint64 column ``column_name`` first: ``partition_offset`` plus
        the row's index."""
        ids = np.arange(len(self), dtype=np.uint64) + np.uint64(partition_offset)
        s = Series.from_arrow(pa.array(ids), column_name)
        return Table(Schema([Field(column_name, s.dtype)] + list(self.schema)),
                     [s] + self._columns)

    # ------------------------------------------------------------------ aggregation
    def agg(self, to_agg: Sequence[Expression], group_by: Optional[Sequence[Expression]] = None) -> "Table":
        group_by = _as_expressions(group_by) if group_by else []
        to_agg = _as_expressions(to_agg)
        if not group_by:
            return self.eval_expression_list(to_agg)
        n = len(self)
        with self._memo_scope():
            key_tbl = self.eval_expression_list(group_by)
            codes, uniq = _group_codes(key_tbl)
            num_groups = len(uniq)
            out_cols: List[Series] = list(uniq._columns)
            out_fields: List[Field] = list(uniq.schema)
            seg: Dict[str, Any] = {}

            def segments():
                """Each group's rows contiguous (a stable sort by code) and
                the groups' offsets, made on first use."""
                if not seg:
                    seg["order"] = Series.from_arrow(
                        pa.array(np.argsort(codes, kind="stable").astype(np.uint64)), "o")
                    seg["offs"] = np.concatenate(
                        [[0], np.cumsum(np.bincount(codes, minlength=num_groups))])
                return seg["order"], seg["offs"]

            for e in to_agg:
                node = e._node
                while isinstance(node, Alias):
                    node = node.child
                if not isinstance(node, AggExpr):
                    raise DaftValueError(f"aggregation list contains non-aggregation {e!r}")
                child_s = _broadcast_series(node.child.evaluate(self), n)
                expected_dt = node.to_field(self.schema).dtype
                merged = _sketch_agg_fast(node, child_s, codes, num_groups)
                if merged is None:
                    merged = _bincount_agg_fast(node, child_s, codes, num_groups)
                if merged is None:
                    merged = _hash_agg_fast(node, child_s, codes, num_groups)
                if merged is None:  # group by group
                    order, offs = segments()
                    rows = child_s.take(order)
                    outs = [_eval_agg_on_series(node, rows.slice(int(offs[g]), int(offs[g + 1])))
                            for g in range(num_groups)]
                    merged = Series.concat(outs) if outs else _empty_agg_series(node, child_s)
                if merged.dtype != expected_dt:
                    merged = merged.cast(expected_dt)
                out_cols.append(merged.rename(e.name()))
                out_fields.append(Field(e.name(), expected_dt))
        return Table(Schema(out_fields), out_cols)


def _broadcast_series(s: Series, n: int) -> Series:
    from .series import _broadcast_to

    return _broadcast_to(s, n)


def _explode_series(s: Series, out_lens: np.ndarray) -> Series:
    """The elements of list series ``s`` in row order, with one null for
    each empty or null list (``out_lens``: each row's output count)."""
    arr = s.to_arrow()
    if pa.types.is_fixed_size_list(arr.type):
        arr = arr.cast(pa.large_list(arr.type.value_type))
    offs = np.asarray(arr.offsets).astype(np.int64)
    lo = int(offs[0])
    starts = offs[:-1] - lo
    child = arr.values.slice(lo, int(offs[-1]) - lo)
    real = np.where(np.asarray(pc.is_valid(arr)), offs[1:] - offs[:-1], 0)
    rows = np.repeat(np.arange(len(arr), dtype=np.int64), out_lens)
    first = np.repeat(np.cumsum(out_lens) - out_lens, out_lens)
    idx = starts[rows] + (np.arange(len(rows), dtype=np.int64) - first)
    valid = real[rows] > 0
    if len(child) == 0:
        out = pa.nulls(len(idx), arr.type.value_type)
    else:
        taken = child.take(pa.array(np.clip(idx, 0, len(child) - 1)))
        out = pc.if_else(pa.array(valid), taken, pa.nulls(len(idx), taken.type))
    return Series.from_arrow(out, s.name)


def _norm_flag(v, k: int, default):
    if v is None:
        return [default] * k
    if isinstance(v, (bool, int)):
        return [bool(v)] * k
    out = list(v)
    if len(out) != k:
        raise DaftValueError(f"expected {k} flags, got {len(out)}")
    return out


def _composite_rank(keys: List[Series], bounds: List[Series], descending: List[bool],
                    nulls_first: List[Optional[bool]]) -> np.ndarray:
    """For each row, the number of boundary rows at or below it in the
    lexicographic sort order, with each key's direction and null placement
    as ``Table.argsort`` orders them, so range partitions align with the
    sort."""
    n = len(keys[0])
    nb = len(bounds[0])
    ge_all = np.zeros((nb, n), dtype=bool)
    for bi in range(nb):
        cmp_state = np.zeros(n, dtype=np.int8)  # -1 lt, 0 eq, +1 gt (in sort order)
        for s, b, d, nf in zip(keys, bounds, descending, nulls_first):
            eq_mask = cmp_state == 0
            if not eq_mask.any():
                break
            sv = s.to_arrow()
            bscalar = b.slice(bi, bi + 1).to_arrow()[0]
            lt = np.asarray(pc.fill_null(pc.less(sv, bscalar), False))
            gt = np.asarray(pc.fill_null(pc.greater(sv, bscalar), False))
            if d:
                lt, gt = gt, lt
            isnull = np.asarray(pc.is_null(sv))
            nulls_at_start = nf if nf is not None else d
            if not bscalar.is_valid:  # non-null rows against a null boundary
                none = np.zeros(n, dtype=bool)
                lt2, gt2 = (none, ~isnull) if nulls_at_start else (~isnull, none)
            elif nulls_at_start:
                lt2, gt2 = np.where(isnull, True, lt), np.where(isnull, False, gt)
            else:
                lt2, gt2 = np.where(isnull, False, lt), np.where(isnull, True, gt)
            cmp_state = np.where(eq_mask & lt2, -1, cmp_state)
            cmp_state = np.where(eq_mask & gt2, 1, cmp_state)
        ge_all[bi] = cmp_state >= 0
    return ge_all.sum(axis=0).astype(np.int64)


def _group_codes(key_tbl: Table) -> Tuple[np.ndarray, Table]:
    """Dense group codes per row + table of unique key rows (nulls form a group)."""
    n = len(key_tbl)
    if n == 0:
        return np.empty(0, dtype=np.int64), key_tbl
    # dictionary-encode each key column, then combine codes by mixed-radix
    combined = np.zeros(n, dtype=np.int64)
    for s in key_tbl._columns:
        enc = s.to_arrow().dictionary_encode()
        codes = np.asarray(enc.indices.fill_null(-1)).astype(np.int64)
        codes = codes + 1  # null -> 0
        card = len(enc.dictionary) + 1
        card = max(card, 1)
        if (int(combined.max(initial=0)) + 1) * card >= (1 << 62):
            # overflow guard: re-densify intermediate codes before combining
            _, combined = np.unique(combined, return_inverse=True)
            combined = combined.astype(np.int64)
        combined = combined * np.int64(card) + codes
    # Densify the combined codes without an O(n log n) sort: arrow's
    # dictionary_encode (C++ hash pass) + first-occurrence fixup via a
    # reversed fancy-assignment (last write wins, so a reversed index write
    # leaves each slot holding its FIRST occurrence).
    enc = pa.array(combined).dictionary_encode()
    codes = np.asarray(enc.indices).astype(np.int64)
    num = len(enc.dictionary)
    first_per_code = np.empty(num, dtype=np.int64)
    first_per_code[codes[::-1]] = np.arange(n - 1, -1, -1)
    order = np.argsort(first_per_code, kind="stable")
    remap = np.empty(num, dtype=np.int64)
    remap[order] = np.arange(num)
    codes = remap[codes]
    first_idx = first_per_code[order]
    uniq = key_tbl.take(Series.from_arrow(pa.array(first_idx.astype(np.uint64)), "i"))
    return codes, uniq


def _acero_agg_fn(node: AggExpr):
    """AggExpr -> (arrow hash-agg function name, options), or None.

    ``list`` and ``any_value`` (arrow's ``first``) depend on row order. The
    reference declines both under a threaded arrow plan, which orders rows
    by thread timing; every grouped aggregate of the port runs arrow on one
    thread (``_hash_agg_fast``), which keeps the input order, so both map."""
    k = node.kind
    if k in ("sum", "mean", "min", "max", "count_distinct", "list"):
        return k, None  # count_distinct counts valid values only (nulls skipped)
    if k == "count":
        mode = node.extra.get("mode", "valid")
        if mode not in ("valid", "null", "all"):
            return None
        return "count", pc.CountOptions(
            mode={"valid": "only_valid", "null": "only_null", "all": "all"}[mode])
    if k == "stddev":
        return "stddev", pc.VarianceOptions(ddof=0)
    if k == "any_value":
        return "first", pc.ScalarAggregateOptions(
            skip_nulls=bool(node.extra.get("ignore_nulls", False)))
    return None


def _sketch_agg_fast(node: AggExpr, child: Series, codes: np.ndarray,
                     num_groups: int) -> Optional[Series]:
    """The grouped kernels of the sketch subsystem (daft_tpu_torch/sketch/):
    the stage kinds (``sketch_*`` build one binary sketch a group,
    ``merge_sketch_*`` merge serialized sketches) and the one-partition
    ``approx_*``, which build and estimate in one pass and so give the
    two-stage plan's estimates. None for every other kind."""
    k = node.kind
    if k in ("sketch_hll", "merge_sketch_hll", "approx_count_distinct"):
        from .sketch import hll

        if k == "sketch_hll":
            return hll.build_grouped(child, codes, num_groups)
        if k == "merge_sketch_hll":
            return hll.merge_grouped(child, codes, num_groups)
        est = hll.grouped_estimates(child, codes, num_groups)
        return Series.from_arrow(pa.array(est, type=pa.uint64()), child.name)
    if k in ("sketch_quantile", "merge_sketch_quantile", "approx_percentiles"):
        from .sketch import quantile

        if k == "sketch_quantile":
            return quantile.build_grouped(child, codes, num_groups)
        if k == "merge_sketch_quantile":
            return quantile.merge_grouped(child, codes, num_groups)
        return quantile.estimate_series(quantile.build_grouped(child, codes, num_groups),
                                        node.extra.get("percentiles", 0.5))
    return None


def _bincount_agg_fast(node: AggExpr, child: Series, codes: np.ndarray,
                       num_groups: int) -> Optional[Series]:
    """O(n) grouped count/sum/mean via np.bincount (no hash pass, no sort).

    Floats only for sum/mean (bincount accumulates in float64; integer sums
    stay on the exact arrow hash-agg path to avoid 2^53 precision loss).
    Matches arrow hash-agg null semantics: nulls skipped, all-null/empty
    groups yield null, NaN propagates.
    """
    if child.is_python() or num_groups == 0 or len(codes) == 0:
        return None
    k = node.kind
    arr = child.to_arrow()
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if k == "count":
        mode = node.extra.get("mode", "valid")
        if mode == "all" or (mode == "valid" and arr.null_count == 0):
            cnt = np.bincount(codes, minlength=num_groups)
        elif mode == "valid":
            cnt = np.bincount(codes[np.asarray(arr.is_valid())], minlength=num_groups)
        elif mode == "null":
            cnt = np.bincount(codes[np.asarray(arr.is_null())], minlength=num_groups)
        else:
            return None
        return Series.from_arrow(pa.array(cnt.astype(np.uint64)), child.name)
    if k not in ("sum", "mean") or not pa.types.is_floating(arr.type):
        return None
    if arr.null_count == 0:
        vals = arr.to_numpy(zero_copy_only=False)
        sums = np.bincount(codes, weights=vals, minlength=num_groups)
        cnt = np.bincount(codes, minlength=num_groups)
    else:
        valid = np.asarray(arr.is_valid())
        vals = np.where(valid, arr.to_numpy(zero_copy_only=False), 0.0)
        sums = np.bincount(codes, weights=vals, minlength=num_groups)
        cnt = np.bincount(codes[valid], minlength=num_groups)
    empty = cnt == 0
    out = sums if k == "sum" else np.divide(sums, cnt, out=np.zeros_like(sums), where=~empty)
    return Series.from_arrow(pa.array(out, type=pa.float64(), mask=empty), child.name)


def _hash_agg_fast(node: AggExpr, child: Series, codes: np.ndarray, num_groups: int) -> Optional[Series]:
    """Vectorized grouped aggregation through arrow's hash-agg engine.

    Returns None when the (kind, dtype) combination needs the segment fallback.
    """
    if child.is_python() or num_groups == 0:
        return None
    k = node.kind
    spec = _acero_agg_fn(node)
    if spec is None:
        return None
    fname, opts = spec
    arr = child.to_arrow()
    if pa.types.is_nested(arr.type) and k in ("sum", "mean", "min", "max", "stddev",
                                              "count_distinct", "list"):
        return None
    try:
        tbl = pa.table({"g": pa.array(codes), "v": arr})
        agg = tbl.group_by("g", use_threads=False).aggregate([("v", fname, opts)])
    except (pa.ArrowNotImplementedError, pa.ArrowInvalid):
        return None
    out_name = [c for c in agg.column_names if c != "g"][0]
    g = np.asarray(agg.column("g").combine_chunks())
    v = agg.column(out_name).combine_chunks()
    if isinstance(v, pa.ChunkedArray):
        v = v.combine_chunks()
    # scatter into group order 0..num_groups-1
    order = np.argsort(g, kind="stable")
    inv = np.empty(num_groups, dtype=np.int64)
    inv[g[order]] = order
    v = v.take(pa.array(inv))
    return Series.from_arrow(v, child.name)


def _empty_agg_series(node: AggExpr, child: Series) -> Series:
    """An empty result column of the dtype ``node`` gives over ``child``."""
    out_field = AggExpr(node.kind, _ConstNode(child.dtype), node.extra).to_field(Schema([]))
    return Series.empty(child.name, out_field.dtype)


class _ConstNode:
    """An ExprNode-like of a fixed dtype, for typing an empty aggregate."""

    def __init__(self, dtype: DataType):
        self._dtype = dtype

    def to_field(self, _schema):
        return Field("x", self._dtype)

    def name(self):
        return "x"
