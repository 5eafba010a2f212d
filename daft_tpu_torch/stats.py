"""Column and table statistics for pruning and cost estimation (the port's
copy of daft_tpu/stats.py).

Per-column min/max/null_count bounds flow from file metadata (parquet
row-group statistics) through scan tasks and unloaded MicroPartitions to
the planner: ``filter_may_match`` prunes the row groups and scan tasks whose
bounds prove a pushed-down filter matches no row.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class ColumnStats:
    """Bounds for one column: [min, max] (python scalars) + null_count.

    A ``None`` field means "unknown" (a missing bound).
    """

    __slots__ = ("min", "max", "null_count")

    def __init__(self, min: Any = None, max: Any = None, null_count: Optional[int] = None):
        self.min = min
        self.max = max
        self.null_count = null_count

    def __repr__(self) -> str:
        return f"ColumnStats(min={self.min!r}, max={self.max!r}, nulls={self.null_count})"

    def merge(self, other: "ColumnStats") -> "ColumnStats":
        mn = None
        if self.min is not None and other.min is not None:
            try:
                mn = min(self.min, other.min)
            except TypeError:
                mn = None
        mx = None
        if self.max is not None and other.max is not None:
            try:
                mx = max(self.max, other.max)
            except TypeError:
                mx = None
        nc = None
        if self.null_count is not None and other.null_count is not None:
            nc = self.null_count + other.null_count
        return ColumnStats(mn, mx, nc)


class TableStats:
    """Per-column stats + row count for a table/partition/file fragment."""

    __slots__ = ("columns", "num_rows", "size_bytes")

    def __init__(self, columns: Optional[Dict[str, ColumnStats]] = None,
                 num_rows: Optional[int] = None, size_bytes: Optional[int] = None):
        self.columns = columns or {}
        self.num_rows = num_rows
        self.size_bytes = size_bytes

    def __repr__(self) -> str:
        return f"TableStats(rows={self.num_rows}, bytes={self.size_bytes}, cols={list(self.columns)})"

    def merge(self, other: "TableStats") -> "TableStats":
        cols: Dict[str, ColumnStats] = {}
        for name in set(self.columns) | set(other.columns):
            a, b = self.columns.get(name), other.columns.get(name)
            if a is not None and b is not None:
                cols[name] = a.merge(b)
        nr = None
        if self.num_rows is not None and other.num_rows is not None:
            nr = self.num_rows + other.num_rows
        sb = None
        if self.size_bytes is not None and other.size_bytes is not None:
            sb = self.size_bytes + other.size_bytes
        return TableStats(cols, nr, sb)

    @staticmethod
    def merge_all(stats: List["TableStats"]) -> "TableStats":
        if not stats:
            return TableStats(num_rows=0, size_bytes=0)
        out = stats[0]
        for s in stats[1:]:
            out = out.merge(s)
        return out


# ---------------------------------------------------------------------------
# Filter evaluation against stats (row-group / partition pruning)
# ---------------------------------------------------------------------------

# Tri-state result of evaluating a predicate against bounds:
#   True  -> predicate may be true for some row (keep fragment)
#   False -> predicate is false for ALL rows (prune fragment)
# Unknown is represented as True (keep).


def filter_may_match(expr_node, stats: TableStats) -> bool:
    """Conservatively decide whether any row of a fragment with these stats
    can satisfy the predicate (False only when the bounds prove none can)."""
    res = _eval(expr_node, stats)
    return res is not False


def _eval(node, stats: TableStats):
    """Returns True (may match), False (cannot match), or None (unknown)."""
    from .expressions import Alias, BinaryOp, IsNull, Not

    if isinstance(node, Alias):
        return _eval(node.child, stats)
    if isinstance(node, Not):
        # only an exact True/False could be negated, and the lattice loses
        # exactness: Not() is always unknown
        return None
    if isinstance(node, IsNull):
        return None  # null_count bound alone can't prove all-match/none-match cheaply
    if isinstance(node, BinaryOp):
        op = node.op
        if op == "&":
            l, r = _eval(node.left, stats), _eval(node.right, stats)
            if l is False or r is False:
                return False
            return None
        if op == "|":
            l, r = _eval(node.left, stats), _eval(node.right, stats)
            if l is False and r is False:
                return False
            return None
        if op in ("==", "<", "<=", ">", ">=", "!="):
            return _eval_cmp(op, node.left, node.right, stats)
    return None


def _bounds_of(node, stats: TableStats):
    """(min, max) bounds of an expression, or None if unknown."""
    from .expressions import Alias, Column, Literal

    if isinstance(node, Alias):
        return _bounds_of(node.child, stats)
    if isinstance(node, Literal):
        v = node.value
        if v is None:
            return None
        return (v, v)
    if isinstance(node, Column):
        cs = stats.columns.get(node.cname)
        if cs is None or cs.min is None or cs.max is None:
            return None
        return (cs.min, cs.max)
    return None


def _eval_cmp(op: str, left, right, stats: TableStats):
    lb = _bounds_of(left, stats)
    rb = _bounds_of(right, stats)
    if lb is None or rb is None:
        return None
    lmin, lmax = lb
    rmin, rmax = rb
    try:
        if op == "==":
            if lmax < rmin or lmin > rmax:
                return False
        elif op == "<":
            if lmin >= rmax:
                return False
        elif op == "<=":
            if lmin > rmax:
                return False
        elif op == ">":
            if lmax <= rmin:
                return False
        elif op == ">=":
            if lmax < rmin:
                return False
        elif op == "!=":
            # can only prune if both sides are single constant and equal... but
            # equal bounds still admit nulls; stay conservative
            return None
    except TypeError:
        return None
    return True
