"""Column-level dataflow DAG of a map chain (the port's copy of
daft_tpu/fuse/graph.py).

A chain's Project/Filter expressions are inlined through each other into
one DAG over the INPUT columns:

- ``Column`` references resolve through upstream projections (alias-preserving
  substitution via ``ExprNode.with_children``), so a chain of N ops becomes
  one set of root expressions;
- hash-consing CSE (structural ``_key()`` interning) makes shared subtrees a
  single DAG node, so each distinct subexpression is evaluated once per
  partition; ``cse_hits`` counts the evaluations saved;
- filters become mask nodes that split the DAG into *segments*: everything
  in segment j evaluates on the rows surviving masks 1..j-1, preserving
  filter-then-project row semantics exactly;
- *carries* materialize subtrees shared across segments as scratch columns
  at their FIRST use's row set, so later segments reuse the filtered column
  instead of recomputing (host path only);
- consecutive masks separated only by *total* expressions (ones that cannot
  raise on a filtered-out row) conjoin into one mask.

Fusion declines (``FuseDecline``) on an aggregation inside the chain, on an
input column that collides with the scratch prefixes, and on any node kind
outside the port's expression set. Left out: UDF pinning, because the port
has no UDFs yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ..errors import DaftError
from ..expressions import Alias, Between, BinaryOp, Cast, Column, ExprNode, Literal, Not
from ..schema import Schema

# reserved scratch-column prefixes (declined if the input schema collides)
CSE_PREFIX = "__fuse_cse_"
MASK_PREFIX = "__fuse_mask_"

_FUSABLE = (Alias, Between, BinaryOp, Cast, Column, Literal, Not)


class FuseDecline(DaftError):
    """Fusion is not applicable or safe for this chain; callers keep the
    unfused op chain (never a query failure)."""


class Segment:
    """One row-set epoch of the fused program: scratch-column evaluations
    (``lets``: cross-segment carries), then an optional mask that compacts
    the working set before the next segment."""

    __slots__ = ("lets", "mask")

    def __init__(self):
        self.lets: List[Tuple[str, ExprNode]] = []
        self.mask: Optional[ExprNode] = None


class FusedGraph:
    """The compiled dataflow of one Project/Filter chain (see module doc)."""

    __slots__ = ("input_schema", "segments", "outputs", "device_masks",
                 "device_outputs", "n_ops", "n_project_ops", "n_filter_ops",
                 "cse_hits", "carries", "source_exprs")

    def __init__(self, input_schema: Schema):
        self.input_schema = input_schema
        self.segments: List[Segment] = [Segment()]
        self.outputs: List[Tuple[str, ExprNode]] = []
        # pre-carry roots: the device path runs the WHOLE DAG as one program,
        # so carries are host-only
        self.device_masks: List[ExprNode] = []
        self.device_outputs: List[Tuple[str, ExprNode]] = []
        self.n_ops = 0
        self.n_project_ops = 0
        self.n_filter_ops = 0
        self.cse_hits = 0
        self.carries = 0
        self.source_exprs: list = []


# binary ops that cannot raise on data (comparisons yield bool; kleene
# logic over bools); arithmetic is handled separately (int kernels are
# checked and can raise on overflow/div-by-zero)
_TOTAL_BINOPS = {"==", "!=", "<", "<=", ">", ">=", "<=>", "&", "|", "^"}
_TOTAL_ARITH = {"+", "-", "*"}


class _Builder:
    def __init__(self, input_schema: Schema):
        self.graph = FusedGraph(input_schema)
        self._canon: Dict[tuple, ExprNode] = {}
        self._canon_ids: Set[int] = set()
        self._keep: List[ExprNode] = []  # canonical nodes stay alive: their
        # id()s in _canon_ids / memo maps must never be reused by GC
        self._total_memo: Dict[int, bool] = {}
        self._inline_seen: Set[int] = set()

    def cons(self, node: ExprNode) -> ExprNode:
        """Intern ``node`` (children first)."""
        if id(node) in self._canon_ids:
            return node
        if not isinstance(node, _FUSABLE):
            raise FuseDecline(f"{type(node).__name__} is not fusable")
        kids = node.children()
        if kids:
            new = [self.cons(c) for c in kids]
            if any(a is not b for a, b in zip(new, kids)):
                node = node.with_children(new)
                if id(node) in self._canon_ids:
                    return node
        try:
            key = node._key()
            hash(key)
        except TypeError:
            self._register(node)
            return node
        hit = self._canon.get(key)
        if hit is not None:
            if hit is not node and kids:
                self.graph.cse_hits += 1
            self._keep.append(node)
            return hit
        self._canon[key] = node
        self._register(node)
        return node

    def _register(self, node: ExprNode) -> None:
        self._canon_ids.add(id(node))
        self._keep.append(node)

    def inline(self, node: ExprNode, scope: Dict[str, ExprNode]) -> ExprNode:
        """Resolve Column references through the visible projection scope,
        alias-wrapping when the defining node's name differs so downstream
        name-sensitive typing (e.g. ``BinaryOp.name()``) is unchanged."""
        if isinstance(node, Column):
            d = scope.get(node.cname)
            if d is None:
                raise FuseDecline(f"unresolvable column {node.cname!r}")
            if d.children():
                # every reference past the first to a COMPUTED def is a
                # subexpression a naive inliner would have re-evaluated;
                # the shared DAG node evaluates it once
                if id(d) in self._inline_seen:
                    self.graph.cse_hits += 1
                else:
                    self._inline_seen.add(id(d))
            if _node_name(d) != node.cname:
                d = self.cons(Alias(d, node.cname))
            return d
        kids = node.children()
        if not kids:
            return self.cons(node)
        return self.cons(node.with_children([self.inline(c, scope) for c in kids]))

    def is_total(self, node: ExprNode, schema: Schema) -> bool:
        """True when evaluating ``node`` on a superset of its unfused row set
        cannot raise or observably differ. Gates mask conjoining only."""
        hit = self._total_memo.get(id(node))
        if hit is None:
            hit = self._total_memo[id(node)] = self._is_total(node, schema)
        return hit

    def _is_total(self, node: ExprNode, schema: Schema) -> bool:
        if not all(self.is_total(c, schema) for c in node.children()):
            return False
        if isinstance(node, (Column, Literal, Alias, Not, Between)):
            return True
        if isinstance(node, BinaryOp):
            if node.op in _TOTAL_BINOPS:
                return True
            if node.op in _TOTAL_ARITH:
                try:
                    return node.to_field(schema).dtype.is_floating()
                except Exception:
                    return False
        return False


def _node_name(node: ExprNode) -> Optional[str]:
    try:
        return node.name()
    except Exception:
        return None


def build_fused_graph(stages: List[Tuple[str, object]], input_schema: Schema) -> FusedGraph:
    """Build the fused DAG for a chain of map-class stages.

    ``stages`` is the chain in EXECUTION order (bottom-up):
    ``("project", [Expression, ...])`` or ``("filter", Expression)``.
    Raises FuseDecline when fusion would be unsafe; callers keep the
    unfused chain."""
    for name in input_schema.field_names():
        if name.startswith((CSE_PREFIX, MASK_PREFIX)):
            raise FuseDecline(f"input column {name!r} collides with fusion scratch names")
    b = _Builder(input_schema)
    g = b.graph
    scope: Dict[str, ExprNode] = {n: b.cons(Column(n)) for n in input_schema.field_names()}
    for kind, payload in stages:
        g.n_ops += 1
        if kind == "project":
            g.n_project_ops += 1
            new_scope: Dict[str, ExprNode] = {}
            for e in payload:
                g.source_exprs.append(e)
                if e._node.is_aggregation():
                    raise FuseDecline("aggregation inside a map chain")
                new_scope[e.name()] = b.inline(e._node, scope)
            scope = new_scope
        elif kind == "filter":
            g.n_filter_ops += 1
            g.source_exprs.append(payload)
            if payload._node.is_aggregation():
                raise FuseDecline("aggregation inside a filter predicate")
            mask = b.inline(payload._node, scope)
            cur = g.segments[-1]
            prev = g.segments[-2] if len(g.segments) > 1 else None
            if (not cur.lets and cur.mask is None and prev is not None
                    and prev.mask is not None and b.is_total(mask, input_schema)):
                # conjoin: a total mask cannot raise on the rows the previous
                # mask would have dropped, and kleene `&` drops exactly the
                # same survivors as sequential filtering
                prev.mask = b.cons(BinaryOp("&", prev.mask, mask))
                continue
            cur.mask = mask
            g.segments.append(Segment())
        else:  # pragma: no cover - planner bug
            raise FuseDecline(f"unknown stage kind {kind!r}")
    g.outputs = [(name, node) for name, node in scope.items()]
    g.device_masks = [s.mask for s in g.segments if s.mask is not None]
    g.device_outputs = list(g.outputs)
    _plant_carries(g)
    return g


def _plant_carries(g: FusedGraph) -> None:
    """Cross-segment CSE: subtrees used in 2+ row-set epochs materialize as
    scratch columns at their FIRST use's segment (the row set the unfused
    chain first evaluated them on) and are reused, filtered, downstream."""
    nsegs = len(g.segments)
    roots: List[Tuple[int, ExprNode]] = []
    for si, seg in enumerate(g.segments):
        if seg.mask is not None:
            roots.append((si, seg.mask))
    for _name, node in g.outputs:
        roots.append((nsegs - 1, node))

    usage: Dict[int, Set[int]] = {}
    nodes_by_id: Dict[int, ExprNode] = {}

    def visit(node: ExprNode, si: int, seen: Set[int]) -> None:
        if id(node) in seen:
            return
        seen.add(id(node))
        usage.setdefault(id(node), set()).add(si)
        nodes_by_id[id(node)] = node
        for c in node.children():
            visit(c, si, seen)

    for si, root in roots:
        visit(root, si, set())

    def subtree_size(node: ExprNode) -> int:
        return 1 + sum(subtree_size(c) for c in node.children())

    cands = []
    for order, (nid, segs) in enumerate(usage.items()):
        node = nodes_by_id[nid]
        if len(segs) < 2 or not node.children() or isinstance(node, Alias):
            continue  # an Alias's child spans the same segments: carry that
        cands.append((min(segs), subtree_size(node), order, node))
    if not cands:
        return
    # inner shared subtrees evaluate before the nodes that embed them
    cands.sort(key=lambda t: (t[0], t[1], t[2]))
    carry_map: Dict[int, str] = {}

    def subst_carries(node: ExprNode, exclude: Optional[int] = None) -> ExprNode:
        cname = carry_map.get(id(node))
        if cname is not None and id(node) != exclude:
            return Column(cname)
        kids = node.children()
        if not kids:
            return node
        new = [subst_carries(c) for c in kids]
        if all(a is b_ for a, b_ in zip(new, kids)):
            return node
        return node.with_children(new)

    for first_seg, _size, _order, node in cands:
        cname = f"{CSE_PREFIX}{len(carry_map)}"
        body = subst_carries(node, exclude=id(node))
        carry_map[id(node)] = cname
        g.segments[first_seg].lets.append((cname, body))
        g.carries += 1
    # rewrite every root against the carry columns (let bodies were
    # rewritten incrementally above; masks and outputs here)
    for seg in g.segments:
        if seg.mask is not None:
            seg.mask = subst_carries(seg.mask)
    g.outputs = [(n, subst_carries(node)) for n, node in g.outputs]
