"""Rule-based logical optimizer (the port's copy of daft_tpu/optimizer.py,
over the plan nodes the port has).

The rules rewrite the logical tree to a fixed point (bounded passes):
filter pushdown (across projections, sorts, repartitions and distincts,
and into the sides of a join), limit pushdown, repartition elision and
projection folding. Then one column-pruning pass pushes the set of needed
columns toward the sources, where a pruning Project over an in-memory
source keeps only what later operators read, and the rules run to a fixed
point again.

Left out until their nodes are ported: the scan pushdowns (filters, limits
and columns installed in a ScanSource) and the pivot, explode, unpivot,
concat, sample, write and monotonic-id branches.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .expressions import BinaryOp, Expression, col
from .logical import (Aggregate, Distinct, Filter, InMemorySource, Join, Limit, LogicalPlan,
                      Project, Repartition, Sort, expr_has_special, expr_input_columns,
                      is_trivial_passthrough, substitute_columns)


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

    if isinstance(child, (Sort, Repartition, Distinct)):
        return child.with_children([Filter(child.input, pred)])

    if isinstance(child, Join):
        return _filter_into_join(p, child)

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
    return None


# ---------------------------------------------------------------------------
# repartition elision
# ---------------------------------------------------------------------------

def _drop_repartition(p: LogicalPlan) -> Optional[LogicalPlan]:
    if not isinstance(p, Repartition):
        return None
    child = p.input
    if isinstance(child, Repartition):
        return Repartition(child.input, p.scheme, p.num, p.by)
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
    means every column is needed."""
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

    if isinstance(p, Distinct):
        # distinct semantics depend on every visible column: no pruning below
        return p.with_children([_prune_columns(p.input, None)])

    if isinstance(p, Limit):
        return p.with_children([_prune_columns(p.input, required)])

    raise ValueError(f"column pruning has no rule for logical node {p.name()}")
