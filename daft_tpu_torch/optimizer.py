"""Rule-based logical optimizer (the port's copy of daft_tpu/optimizer.py,
over the plan nodes the port has).

The rules rewrite the logical tree to a fixed point (bounded passes):
filter pushdown (across projections, sorts, repartitions, distincts and
monotonic ids, into both sides of a concat, into the sides of an equi
join, and into a scan's tasks), limit pushdown (across projections, into
both sides of a concat, and into a scan's tasks under the Limit that stays
above), repartition elision and projection folding. Then one
column-pruning pass pushes the set of needed columns toward the sources
(through pivots, explodes, unpivots, concats, samples and monotonic ids
too): a scan reads only those columns (its column pushdown), and a pruning
Project over an in-memory source keeps only what later operators read.
The rules then run to a fixed point again.

Left out until its node is ported: the write branch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .expressions import BinaryOp, Expression, col
from .logical import (Aggregate, Concat, Distinct, Explode, Filter, InMemorySource, Join, Limit,
                      LogicalPlan, MonotonicallyIncreasingId, Pivot, Project, Repartition,
                      Sample, ScanSource, Sort, Unpivot, Write, expr_has_special,
                      expr_input_columns, is_trivial_passthrough, substitute_columns)


def optimize(plan: LogicalPlan, max_passes: int = 8) -> LogicalPlan:
    for _ in range(max_passes):
        new = _apply_once(plan)
        if new is None:
            break
        plan = new
    plan = _prune_columns(plan, None)
    # pruning may introduce Projects that enable further pushdown
    for _ in range(max_passes):
        new = _apply_once(plan)
        if new is None:
            break
        plan = new
    return plan


def _apply_once(plan: LogicalPlan) -> Optional[LogicalPlan]:
    """One top-down rewrite pass; returns None if nothing changed."""
    changed = False

    def rec(p: LogicalPlan) -> LogicalPlan:
        nonlocal changed
        while True:
            q = _rewrite(p)
            if q is None:
                break
            changed = True
            p = q
        kids = p.children()
        if kids:
            new_kids = [rec(k) for k in kids]
            if any(a is not b for a, b in zip(kids, new_kids)):
                p = p.with_children(new_kids)
        return p

    out = rec(plan)
    return out if changed else None


def _rewrite(p: LogicalPlan) -> Optional[LogicalPlan]:
    for rule in (_push_down_filter, _push_down_limit, _drop_repartition, _fold_projections):
        q = rule(p)
        if q is not None:
            return q
    return None


# ---------------------------------------------------------------------------
# filter pushdown
# ---------------------------------------------------------------------------

def _split_conjuncts(e: Expression) -> List[Expression]:
    n = e._node
    if isinstance(n, BinaryOp) and n.op == "&":
        return _split_conjuncts(Expression(n.left)) + _split_conjuncts(Expression(n.right))
    return [e]


def _and_all(preds: List[Expression]) -> Expression:
    out = preds[0]
    for p in preds[1:]:
        out = out & p
    return out


def _push_down_filter(p: LogicalPlan) -> Optional[LogicalPlan]:
    if not isinstance(p, Filter):
        return None
    child = p.input
    pred = p.predicate

    if isinstance(child, Filter):
        return Filter(child.input, child.predicate & pred)

    if isinstance(child, Project):
        # a pure column-pruning Project over an in-memory source is there to
        # narrow the filter's working set: swapping the filter below it would
        # widen the filter to every source column again
        if isinstance(child.input, InMemorySource) and all(
                is_trivial_passthrough(e) is not None for e in child.exprs):
            return None
        # substitute computed columns into the predicate; abort if any
        # referenced projection expression holds an aggregation
        defs: Dict[str, Optional[Expression]] = {}
        for e in child.exprs:
            src = is_trivial_passthrough(e)
            if src is not None:
                defs[e.name()] = col(src)
            else:
                defs[e.name()] = None if expr_has_special(e) else e
        needed = expr_input_columns(pred)
        if any(defs.get(c, col(c)) is None for c in needed):
            return None
        subst = substitute_columns(pred, {k: v for k, v in defs.items() if v is not None})
        return Project(Filter(child.input, subst), child.exprs)

    if isinstance(child, (Sort, Repartition, MonotonicallyIncreasingId, Distinct)):
        if (isinstance(child, MonotonicallyIncreasingId)
                and child.column_name in expr_input_columns(pred)):
            return None
        return child.with_children([Filter(child.input, pred)])

    if isinstance(child, Concat):
        return Concat(Filter(child.input, pred), Filter(child.other, pred))

    if isinstance(child, Join):
        return _filter_into_join(p, child)

    if isinstance(child, ScanSource):
        pd = child.pushdowns()
        if pd.limit is not None:
            return None  # a limit already applies at the scan: the filter stays above it
        if expr_has_special(pred):
            return None
        new_filter = pred._node if pd.filters is None else (Expression(pd.filters) & pred)._node
        return child.with_pushdowns(pd.with_filters(new_filter))

    return None


def _filter_into_join(f: Filter, j: Join) -> Optional[LogicalPlan]:
    if j.how not in ("inner", "semi", "anti", "left", "right"):
        return None
    # join-output column name -> (side, original name)
    lk = [e.name() for e in j.left_on]
    origin: Dict[str, Tuple[str, str]] = {}
    for ln in lk:
        origin[ln] = ("key", ln)
    for fld in j.left.schema:
        if fld.name not in origin:
            origin[fld.name] = ("left", fld.name)
    lnames = set(j.left.schema.field_names())
    rk = [e.name() for e in j.right_on]
    for fld in j.right.schema:
        if fld.name in rk:
            continue
        out_name = fld.name if fld.name not in lnames else f"{j.suffix}{fld.name}"
        if out_name not in origin:
            origin[out_name] = ("right", fld.name)

    to_left: List[Expression] = []
    to_right: List[Expression] = []
    keep: List[Expression] = []
    for c in _split_conjuncts(f.predicate):
        sides = set()
        ok = True
        for cc in expr_input_columns(c):
            o = origin.get(cc)
            if o is None:
                ok = False
                break
            sides.add(o[0])
        if not ok or expr_has_special(c):
            keep.append(c)
            continue
        side_set = sides - {"key"}
        if not side_set:
            # only join keys: output keys coalesce from the preserved side,
            # so the conjunct belongs to that side (left unless a right join)
            side_set = {"right"} if j.how == "right" else {"left"}
        if side_set == {"left"} and j.how in ("inner", "left", "semi", "anti"):
            to_left.append(c)
        elif side_set == {"right"} and j.how in ("inner", "right"):
            # output names back to the right side's names
            ren = {out: col(orig) for out, (s, orig) in origin.items() if s == "right"}
            to_right.append(substitute_columns(c, ren))
        else:
            keep.append(c)
    if not to_left and not to_right:
        return None
    new_left = j.left
    new_right = j.right
    if to_left:
        new_left = Filter(new_left, _and_all(to_left))
    if to_right:
        # a key referenced on the right side reads the right key expression
        key_map = {ln: j.right_on[i] for i, ln in enumerate(lk)}
        to_right = [substitute_columns(c, key_map) for c in to_right]
        new_right = Filter(new_right, _and_all(to_right))
    new_join = Join(new_left, new_right, j.left_on, j.right_on, j.how, j.strategy, j.suffix)
    if keep:
        return Filter(new_join, _and_all(keep))
    return new_join


# ---------------------------------------------------------------------------
# limit pushdown
# ---------------------------------------------------------------------------

def _push_down_limit(p: LogicalPlan) -> Optional[LogicalPlan]:
    if not isinstance(p, Limit):
        return None
    child = p.input
    if isinstance(child, Limit):
        return Limit(child.input, min(p.limit, child.limit))
    if isinstance(child, Project):
        if any(expr_has_special(e) for e in child.exprs):
            return None
        return Project(Limit(child.input, p.limit), child.exprs)
    if isinstance(child, ScanSource):
        pd = child.pushdowns()
        if pd.limit is not None and pd.limit <= p.limit:
            return None
        new_limit = p.limit if pd.limit is None else min(pd.limit, p.limit)
        # the Limit node stays: each task's limit still needs a global cap
        return Limit(child.with_pushdowns(pd.with_limit(new_limit)), p.limit)
    if isinstance(child, Concat):
        a, b = child.input, child.other
        if (isinstance(a, Limit) and a.limit <= p.limit
                and isinstance(b, Limit) and b.limit <= p.limit):
            return None
        return Limit(Concat(Limit(a, p.limit), Limit(b, p.limit)), p.limit)
    return None


# ---------------------------------------------------------------------------
# repartition elision
# ---------------------------------------------------------------------------

def _drop_repartition(p: LogicalPlan) -> Optional[LogicalPlan]:
    if not isinstance(p, Repartition):
        return None
    child = p.input
    if isinstance(child, Repartition):
        return Repartition(child.input, p.scheme, p.num, p.by, p.descending)
    if p.num == 1 and child.num_partitions() == 1:
        return child
    return None


# ---------------------------------------------------------------------------
# projection folding
# ---------------------------------------------------------------------------

def _fold_projections(p: LogicalPlan) -> Optional[LogicalPlan]:
    if not isinstance(p, Project):
        return None
    child = p.input
    if isinstance(child, Project):
        defs: Dict[str, Expression] = {}
        for e in child.exprs:
            if expr_has_special(e):
                return None
            src = is_trivial_passthrough(e)
            defs[e.name()] = e if src is None else col(src)
        # inline each outer expression; bail if an inner definition would be
        # duplicated into a non-trivial expression more than once (recompute)
        use_count: Dict[str, int] = {}
        for e in p.exprs:
            for c in expr_input_columns(e):
                use_count[c] = use_count.get(c, 0) + 1
        for name, d in defs.items():
            if is_trivial_passthrough(d) is None and use_count.get(name, 0) > 1:
                return None
        return Project(child.input, [substitute_columns(e, defs).alias(e.name())
                                     for e in p.exprs])
    # identity projection over the full child schema -> drop
    names = [e.name() for e in p.exprs]
    if names == child.schema.field_names() and all(
            is_trivial_passthrough(e) == e.name() for e in p.exprs):
        return child
    return None


# ---------------------------------------------------------------------------
# column pruning (single deterministic pass)
# ---------------------------------------------------------------------------

def _restrict(required: Optional[List[str]], schema_names: List[str]) -> List[str]:
    if required is None:
        return list(schema_names)
    return [c for c in schema_names if c in required]


def _add_inputs(need: List[str], exprs) -> None:
    for e in exprs:
        for c in expr_input_columns(e):
            if c not in need:
                need.append(c)


def _prune_columns(p: LogicalPlan, required: Optional[List[str]]) -> LogicalPlan:
    """Push the set of needed columns toward the sources. required=None
    means every column is needed; a scan takes them as its column
    pushdown."""
    if isinstance(p, ScanSource):
        pd = p.pushdowns()
        want = _restrict(required, p.schema.field_names())
        if required is not None and want != p.schema.field_names():
            return p.with_pushdowns(pd.with_columns(want))
        return p

    if isinstance(p, InMemorySource):
        want = _restrict(required, p.schema.field_names())
        if required is not None and want != p.schema.field_names():
            return Project(p, [col(c) for c in want])
        return p

    if isinstance(p, Project):
        keep = [e for e in p.exprs if required is None or e.name() in required
                or expr_has_special(e)]
        if not keep:
            keep = p.exprs[:1]
        need: List[str] = []
        _add_inputs(need, keep)
        need = [c for c in p.input.schema.field_names() if c in need]
        return Project(_prune_columns(p.input, need), keep)

    if isinstance(p, Filter):
        need = None if required is None else list(required)
        if need is not None:
            _add_inputs(need, [p.predicate])
        out: LogicalPlan = Filter(_prune_columns(p.input, need), p.predicate)
        if required is not None and [f for f in out.schema.field_names()
                                     if f in required] != out.schema.field_names():
            out = Project(out, [col(c) for c in _restrict(required, out.schema.field_names())])
        return out

    if isinstance(p, Aggregate):
        need = []
        _add_inputs(need, p.groupby + p.aggregations)
        need = ([c for c in p.input.schema.field_names() if c in need]
                or p.input.schema.field_names()[:1])
        return Aggregate(_prune_columns(p.input, need), p.aggregations, p.groupby)

    if isinstance(p, Pivot):
        need = []
        _add_inputs(need, p.groupby + [p.pivot_col, p.value_col])
        need = [c for c in p.input.schema.field_names() if c in need]
        return Pivot(_prune_columns(p.input, need), p.groupby, p.pivot_col, p.value_col,
                     p.agg_fn, p.names)

    if isinstance(p, Join):
        lneed: Optional[List[str]] = None
        rneed: Optional[List[str]] = None
        if required is not None:
            lnames = set(p.left.schema.field_names())
            rk = [e.name() for e in p.right_on]
            lneed, rneed = [], []
            _add_inputs(lneed, p.left_on)
            _add_inputs(rneed, p.right_on)
            for fld in p.left.schema:
                if fld.name in required and fld.name not in lneed:
                    lneed.append(fld.name)
            for fld in p.right.schema:
                out_name = fld.name if fld.name not in lnames else f"{p.suffix}{fld.name}"
                if (out_name in required or fld.name in required) and fld.name not in rneed:
                    if fld.name in rk and out_name not in required:
                        continue
                    rneed.append(fld.name)
                if out_name != fld.name and out_name in required and fld.name not in lneed:
                    # the left column the suffix comes from stays, or the
                    # right column would lose its suffixed name (the
                    # reference prunes it, and its plan then fails to build)
                    lneed.append(fld.name)
            lneed = [c for c in p.left.schema.field_names() if c in lneed]
            rneed = [c for c in p.right.schema.field_names() if c in rneed]
        return Join(_prune_columns(p.left, lneed), _prune_columns(p.right, rneed),
                    p.left_on, p.right_on, p.how, p.strategy, p.suffix)

    if isinstance(p, (Sort, Repartition)):
        need = None if required is None else list(required)
        if need is not None:
            _add_inputs(need, p.sort_by if isinstance(p, Sort) else p.by)
            need = [c for c in p.input.schema.field_names() if c in need]
        return p.with_children([_prune_columns(p.input, need)])

    if isinstance(p, Explode):
        need = None if required is None else list(required)
        if need is not None:
            _add_inputs(need, p.to_explode)
            need = [c for c in p.input.schema.field_names() if c in need]
        return Explode(_prune_columns(p.input, need), p.to_explode)

    if isinstance(p, Unpivot):
        need = []
        _add_inputs(need, p.ids + p.values)
        need = [c for c in p.input.schema.field_names() if c in need]
        return Unpivot(_prune_columns(p.input, need), p.ids, p.values, p.variable_name,
                       p.value_name)

    if isinstance(p, Distinct):
        # distinct semantics depend on every visible column: no pruning below
        return p.with_children([_prune_columns(p.input, None)])

    if isinstance(p, Concat):
        # both sides keep one layout
        need = None if required is None else _restrict(required, p.schema.field_names())
        a = _prune_columns(p.input, need)
        b = _prune_columns(p.other, need)
        if a.schema.field_names() != b.schema.field_names():
            a = _prune_columns(p.input, None)
            b = _prune_columns(p.other, None)
        return Concat(a, b)

    if isinstance(p, (Limit, Sample)):
        return p.with_children([_prune_columns(p.input, required)])

    if isinstance(p, (MonotonicallyIncreasingId, Write)):
        # the ids number every row, and a write writes every column: the
        # full requirement passes through
        return p.with_children([_prune_columns(p.input, None)])

    raise ValueError(f"column pruning has no rule for logical node {p.name()}")
