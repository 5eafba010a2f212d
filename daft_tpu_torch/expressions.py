"""Expression DSL: a lazy, typed expression tree over columns (the port's
copy of daft_tpu/expressions.py).

Each node knows `to_field(schema)` (static type resolution), `evaluate(table)`
(host evaluation against a Table through pyarrow kernels) and the rewriting
hooks (children/with_children). Device-eligible trees are compiled to torch by
daft_tpu_torch/kernels/device.py.

The port carries Column, Literal (with the weak typing of plain python
numbers), Alias, Cast, BinaryOp (arithmetic, comparisons, & | ^), Not,
Between, IsNull, FillNull, IsIn, IfElse and Function (a call into the
registry of daft_tpu_torch/functions.py, with the str, dt, float, list,
struct, map, partitioning and json namespaces and the hash functions),
``interval`` literals, and the aggregations sum, mean, count, min, max,
count_distinct, stddev, skew, any_value, list (``agg_list``), concat
(``agg_concat``) and the approximate ``approx_count_distinct`` (HyperLogLog)
and ``approx_percentiles`` (a bounded weighted sample), with the
planner's sketch-stage kinds (``sketch_hll``, ``sketch_quantile``,
``merge_sketch_hll``, ``merge_sketch_quantile``, binary columns of
serialized sketches, daft_tpu_torch/sketch/), and python UDF calls
(``PyUdf``, made by udf.py's ``UDF``, by ``Expression.apply`` and by
``batch_udf``), which are never memoized and carry their resource request
and batching declaration to the planner (``expr_has_udf``,
``expr_has_batch_udf``, ``expr_batch_udfs``, ``expr_udfs_parallel_safe``).
The ``image`` and ``url`` namespaces live in multimodal.py, the
``embedding`` namespace (``cosine_distance``) here.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from .errors import DaftValueError
from .datatypes import DataType, TypeKind, infer_datatype, try_unify
from .functions import get_function
from .schema import Field, Schema
from .series import Series


def col(name: str) -> "Expression":
    """Reference a column by name."""
    return Expression(Column(name))


def lit(value: Any, dtype: Optional[DataType] = None) -> "Expression":
    """A literal value."""
    return Expression(Literal(value, dtype))


def interval(**kwargs) -> "Expression":
    """An interval literal for temporal arithmetic, e.g. interval(days=3): a
    microsecond duration."""
    import datetime

    allowed = ("weeks", "days", "hours", "minutes", "seconds", "milliseconds", "microseconds")
    unknown = set(kwargs) - set(allowed)
    if unknown:
        raise DaftValueError(f"unsupported interval unit(s) {sorted(unknown)}; allowed: {allowed}")
    return lit(datetime.timedelta(**kwargs), DataType.duration("us"))


# ---------------------------------------------------------------------------
# IR nodes
# ---------------------------------------------------------------------------

class ExprNode:
    """Base IR node. Concrete nodes implement name/to_field/evaluate/children."""

    def name(self) -> str:
        raise NotImplementedError

    def to_field(self, schema: Schema) -> Field:
        raise NotImplementedError

    def _eval(self, table) -> Series:
        raise NotImplementedError

    def _memoizable(self) -> bool:
        """Subtrees containing a user function are never cached (UDFs may be
        non-deterministic, and their _key uses id(fn) which can be reused)."""
        cached = getattr(self, "_memoizable_cache", None)
        if cached is None:
            cached = not isinstance(self, PyUdf) and all(
                c._memoizable() for c in self.children())
            self._memoizable_cache = cached
        return cached

    def evaluate(self, table) -> Series:
        """Evaluate against a Table, sharing results of structurally identical
        subtrees within one eval pass (table._eval_memo, scoped by Table's
        _memo_scope) — e.g. Q1's disc_price feeds two aggregates but runs once."""
        memo = getattr(table, "_eval_memo", None)
        if memo is None or not self._memoizable():
            return self._eval(table)
        try:
            k = self._key()
            hit = memo.get(k)
        except TypeError:  # unhashable key component (e.g. list literal)
            return self._eval(table)
        if hit is None:
            hit = self._eval(table)
            memo[k] = hit
        return hit

    def children(self) -> List["ExprNode"]:
        return []

    def with_children(self, children: List["ExprNode"]) -> "ExprNode":
        if children:
            raise DaftValueError(f"{type(self).__name__} has no children")
        return self

    def is_aggregation(self) -> bool:
        return False

    # structural identity (used for dedup / optimizer)
    def _key(self) -> Tuple:
        return (type(self).__name__,) + tuple(c._key() for c in self.children())

    def __repr__(self) -> str:
        return self.display()

    def display(self) -> str:
        raise NotImplementedError


class Column(ExprNode):
    def __init__(self, cname: str):
        self.cname = cname

    def name(self) -> str:
        return self.cname

    def to_field(self, schema: Schema) -> Field:
        return schema[self.cname]

    def _eval(self, table) -> Series:
        return table.get_column(self.cname)

    def _key(self):
        return ("col", self.cname)

    def display(self) -> str:
        return f"col({self.cname})"


class Literal(ExprNode):
    def __init__(self, value: Any, dtype: Optional[DataType] = None):
        if isinstance(value, Expression):
            raise DaftValueError("lit() of an Expression; pass a plain value")
        self.value = value
        self.dtype = dtype or infer_datatype(value)
        # A plain python int/float with no declared dtype is *weak-typed*
        # (jax-style): in a binary context it adopts the other operand's
        # dtype when the value fits, so `col_f32 * 2` stays float32 instead
        # of promoting through int64 to float64 — which would knock the
        # expression off the 32-bit device path on real TPUs (x64 off).
        self.weak = dtype is None and isinstance(value, (int, float)) \
            and not isinstance(value, bool)

    def name(self) -> str:
        return "literal"

    def to_field(self, schema: Schema) -> Field:
        return Field("literal", self.dtype)

    def _eval(self, table) -> Series:
        s = Series.from_pylist([self.value], "literal", self.dtype)
        return s

    def _key(self):
        v = self.value
        if isinstance(v, (list, dict)):
            v = repr(v)
        # `weak` is typing-relevant: a weak lit(2) and a strong lit(2, int64)
        # evaluate to different dtypes in binary contexts, so they must not
        # alias in the eval memo / plan cache
        return ("lit", v, self.dtype, self.weak)

    def display(self) -> str:
        return f"lit({self.value!r})"


class Alias(ExprNode):
    def __init__(self, child: ExprNode, alias: str):
        self.child = child
        self.alias = alias

    def name(self) -> str:
        return self.alias

    def to_field(self, schema: Schema) -> Field:
        return Field(self.alias, self.child.to_field(schema).dtype)

    def _eval(self, table) -> Series:
        return self.child.evaluate(table).rename(self.alias)

    def children(self):
        return [self.child]

    def with_children(self, c):
        return Alias(c[0], self.alias)

    def is_aggregation(self):
        return self.child.is_aggregation()

    def _key(self):
        return ("alias", self.alias, self.child._key())

    def display(self) -> str:
        return f"{self.child.display()}.alias({self.alias!r})"


class Cast(ExprNode):
    def __init__(self, child: ExprNode, dtype: DataType):
        self.child = child
        self.dtype = dtype

    def name(self) -> str:
        return self.child.name()

    def to_field(self, schema: Schema) -> Field:
        self.child.to_field(schema)  # validates child
        return Field(self.name(), self.dtype)

    def _eval(self, table) -> Series:
        return self.child.evaluate(table).cast(self.dtype)

    def children(self):
        return [self.child]

    def with_children(self, c):
        return Cast(c[0], self.dtype)

    def _key(self):
        return ("cast", self.dtype, self.child._key())

    def display(self) -> str:
        return f"{self.child.display()}.cast({self.dtype!r})"


_ARITH_OPS = {"+", "-", "*", "/", "//", "%", "**"}
_CMP_OPS = {"==", "!=", "<", "<=", ">", ">=", "<=>"}
_LOGIC_OPS = {"&", "|", "^"}


class BinaryOp(ExprNode):
    def __init__(self, op: str, left: ExprNode, right: ExprNode):
        self.op = op
        self.left = left
        self.right = right

    def name(self) -> str:
        return self.left.name()

    def to_field(self, schema: Schema) -> Field:
        lf = self.left.to_field(schema)
        rf = self.right.to_field(schema)
        _, _, ldt, rdt = effective_operands(self.left, self.right, lf.dtype, rf.dtype)
        lf, rf = Field(lf.name, ldt), Field(rf.name, rdt)
        op = self.op
        nm = self.name()
        if op in _CMP_OPS:
            # A string *literal* compares against a temporal column by parsing
            # at plan time (SQL semantics: WHERE l_shipdate <= '1998-09-02').
            # String columns vs temporal columns are rejected, matching the
            # reference which only coerces literals (src/daft-dsl/resolve_expr.rs).
            str_vs_temporal = (lf.dtype.is_temporal() and rf.dtype.is_string()) or (
                rf.dtype.is_temporal() and lf.dtype.is_string())
            if str_vs_temporal:
                str_node = self.right if rf.dtype.is_string() else self.left
                temporal_dt = lf.dtype if lf.dtype.is_temporal() else rf.dtype
                litv = _unwrap_string_literal(str_node)
                if litv is None:
                    raise DaftValueError(
                        f"cannot compare {lf.dtype} with {rf.dtype}: only string "
                        f"literals coerce to temporal types")
                try:
                    import pyarrow as pa
                    pa.scalar(litv).cast(temporal_dt.to_arrow())
                except Exception as e:
                    raise DaftValueError(
                        f"string literal {litv!r} does not parse as {temporal_dt}: {e}"
                    ) from e
                return Field(nm, DataType.bool())
            if try_unify(lf.dtype, rf.dtype) is None and not (
                lf.dtype.is_temporal() and rf.dtype.is_temporal()
            ):
                raise DaftValueError(f"cannot compare {lf.dtype} with {rf.dtype}")
            return Field(nm, DataType.bool())
        if op in _LOGIC_OPS:
            for f in (lf, rf):
                if not (f.dtype.is_boolean() or f.dtype.is_null() or f.dtype.is_integer()):
                    raise DaftValueError(f"logical op {op} needs bool/int, got {f.dtype}")
            if lf.dtype.is_integer() or rf.dtype.is_integer():
                # bitwise form: both sides must be integers — mixing a bool
                # with an int has no kernel (kleene ops are bool-only)
                if lf.dtype.is_boolean() or rf.dtype.is_boolean():
                    raise DaftValueError(f"cannot {op} {lf.dtype} with {rf.dtype}")
                u = try_unify(lf.dtype, rf.dtype)
                if u is None or not u.is_integer():
                    # e.g. signed | uint64 unifies to float64 — no bitwise kernel
                    raise DaftValueError(f"cannot {op} {lf.dtype} with {rf.dtype}")
                return Field(nm, u)
            return Field(nm, DataType.bool())
        # arithmetic
        if op == "+" and (lf.dtype.is_string() or rf.dtype.is_string()):
            return Field(nm, DataType.string())
        # temporal arithmetic (must precede the '/' check: duration / numeric
        # is legal and resolved by _temporal_arith_type)
        if lf.dtype.is_temporal() or rf.dtype.is_temporal():
            return Field(nm, _temporal_arith_type(op, lf.dtype, rf.dtype))
        if op in ("/", "**"):
            for f in (lf, rf):
                if not (f.dtype.is_numeric() or f.dtype.is_boolean() or f.dtype.is_null()):
                    raise DaftValueError(f"cannot apply {op} to {lf.dtype} and {rf.dtype}")
            return Field(nm, DataType.float64())
        u = try_unify(lf.dtype, rf.dtype)
        if u is None or not (u.is_numeric() or u.is_boolean() or u.is_null()):
            raise DaftValueError(f"cannot apply {op} to {lf.dtype} and {rf.dtype}")
        if u.is_boolean():
            # bool op numeric unifies to the numeric side (handled above by
            # try_unify); bool op bool arithmetic is rejected like the
            # reference (binary_ops.rs Add: only (Boolean, numeric) is legal)
            raise DaftValueError(f"cannot apply {op} to {lf.dtype} and {rf.dtype}")
        return Field(nm, u)

    def _eval(self, table) -> Series:
        l = self.left.evaluate(table)
        r = self.right.evaluate(table)
        # weak-literal adoption must mirror to_field so planner and kernel agree
        _, _, ldt, rdt = effective_operands(self.left, self.right, l.dtype, r.dtype)
        if ldt != l.dtype:
            l = l.cast(ldt)
        if rdt != r.dtype:
            r = r.cast(rdt)
        fn = {
            "+": lambda a, b: a + b, "-": lambda a, b: a - b, "*": lambda a, b: a * b,
            "/": lambda a, b: a / b, "//": lambda a, b: a // b, "%": lambda a, b: a % b,
            "**": lambda a, b: a ** b,
            "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
            "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
            ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
            "<=>": lambda a, b: a.eq_null_safe(b),
            "&": lambda a, b: a & b, "|": lambda a, b: a | b, "^": lambda a, b: a ^ b,
        }[self.op]
        return fn(l, r).rename(self.name())

    def children(self):
        return [self.left, self.right]

    def with_children(self, c):
        return BinaryOp(self.op, c[0], c[1])

    def is_aggregation(self):
        return self.left.is_aggregation() or self.right.is_aggregation()

    def _key(self):
        return ("bin", self.op, self.left._key(), self.right._key())

    def display(self) -> str:
        return f"({self.left.display()} {self.op} {self.right.display()})"


def _unwrap_string_literal(node: "ExprNode"):
    """Return the python string value if node is (an alias or string-cast of)
    a string Literal, else None. Gates SQL-style string→temporal coercion."""
    while isinstance(node, Alias) or (
            isinstance(node, Cast) and node.dtype.is_string()):
        node = node.child
    if isinstance(node, Literal) and isinstance(node.value, str):
        return node.value
    return None


def _weak_literal_node(node: "ExprNode") -> Optional[Literal]:
    """Unwrap aliases; return the Literal if weak-typed, else None."""
    while isinstance(node, Alias):
        node = node.child
    if isinstance(node, Literal) and getattr(node, "weak", False):
        return node
    return None


_INT_KIND_RANGE = {
    TypeKind.INT8: (-128, 127), TypeKind.INT16: (-32768, 32767),
    TypeKind.INT32: (-2**31, 2**31 - 1), TypeKind.INT64: (-2**63, 2**63 - 1),
    TypeKind.UINT8: (0, 255), TypeKind.UINT16: (0, 65535),
    TypeKind.UINT32: (0, 2**32 - 1), TypeKind.UINT64: (0, 2**64 - 1),
}


def adopt_weak_literal_dtype(value, other: DataType) -> Optional[DataType]:
    """jax-style weak typing: the dtype a plain int/float literal should take
    next to an operand of dtype `other`, or None when normal supertype
    promotion applies. int literals adopt any numeric dtype they fit; float
    literals adopt float dtypes (a float literal next to an int column still
    promotes to float64 like the host kernels do)."""
    if not other.is_numeric():
        return None
    if isinstance(value, float):
        return other if other.is_floating() else None
    if other.is_floating():
        return other
    rng = _INT_KIND_RANGE.get(other.kind)
    if rng is not None and rng[0] <= value <= rng[1]:
        return other
    return None


def effective_operands(left: "ExprNode", right: "ExprNode",
                       ldt: DataType, rdt: DataType):
    """Apply weak-literal adoption to one binary context. Returns
    (left_node, right_node, ldt, rdt) where an adopted literal is rewritten to
    a strong Literal of the adopted dtype. Shared by the host planner
    (BinaryOp.to_field), the host kernel (BinaryOp._eval) and the device
    compiler (kernels/device.py) so all three agree on result types."""
    lw, rw = _weak_literal_node(left), _weak_literal_node(right)
    if lw is not None and rw is None:
        ad = adopt_weak_literal_dtype(lw.value, rdt)
        if ad is not None and ad != ldt:
            return Literal(lw.value, ad), right, ad, rdt
    elif rw is not None and lw is None:
        ad = adopt_weak_literal_dtype(rw.value, ldt)
        if ad is not None and ad != rdt:
            return left, Literal(rw.value, ad), ldt, ad
    return left, right, ldt, rdt


def normalize_literals(node: "ExprNode", schema) -> "ExprNode":
    """Rewrite context-dependent literals throughout a tree into strong
    literals: weak int/float literals adopt their sibling operand's dtype and
    string literals next to temporal operands are parsed to temporal literals.
    The device compiler (kernels/device.py) runs this first so every Literal
    carries the concrete dtype it executes at."""
    kids = node.children()
    if kids:
        new_kids = [normalize_literals(c, schema) for c in kids]
        if any(n is not o for n, o in zip(new_kids, kids)):
            node = node.with_children(new_kids)
    if isinstance(node, BinaryOp):
        l, r = effective_binop_children(node.left, node.right, schema)
        if l is not node.left or r is not node.right:
            node = BinaryOp(node.op, l, r)
    elif isinstance(node, Between):
        _, lo = effective_binop_children(node.child, node.lower, schema)
        _, hi = effective_binop_children(node.child, node.upper, schema)
        if lo is not node.lower or hi is not node.upper:
            node = Between(node.child, lo, hi)
    elif isinstance(node, FillNull):
        _, fill = effective_binop_children(node.child, node.fill, schema)
        if fill is not node.fill:
            node = FillNull(node.child, fill)
    elif isinstance(node, IfElse):
        t, f = effective_binop_children(node.if_true, node.if_false, schema)
        if t is not node.if_true or f is not node.if_false:
            node = IfElse(node.pred, t, f)
    return node


def effective_binop_children(left: "ExprNode", right: "ExprNode", schema):
    """Resolve context-dependent literals for one BinaryOp against `schema`:
    weak int/float literals adopt the other operand's dtype, and a string
    literal next to a temporal column is parsed to a temporal literal at plan
    time. Used by the device compiler so the staged expression tree carries
    concrete device dtypes."""
    import pyarrow as _pa

    ldt = left.to_field(schema).dtype
    rdt = right.to_field(schema).dtype
    if ldt.is_temporal() and rdt.is_string():
        v = _unwrap_string_literal(right)
        if v is not None:
            parsed = _pa.scalar(v).cast(ldt.to_arrow()).as_py()
            return left, Literal(parsed, ldt)
    if rdt.is_temporal() and ldt.is_string():
        v = _unwrap_string_literal(left)
        if v is not None:
            parsed = _pa.scalar(v).cast(rdt.to_arrow()).as_py()
            return Literal(parsed, rdt), right
    l2, r2, _, _ = effective_operands(left, right, ldt, rdt)
    return l2, r2


def _temporal_arith_type(op: str, l: DataType, r: DataType) -> DataType:
    def unit_of(dt):
        return dt.params[0] if dt.kind in (TypeKind.TIMESTAMP, TypeKind.DURATION) else "us"

    if op == "-":
        if l.kind == TypeKind.TIMESTAMP and r.kind == TypeKind.TIMESTAMP:
            return DataType.duration(unit_of(l))
        if l.kind == TypeKind.DATE and r.kind == TypeKind.DATE:
            return DataType.duration("s")
        if l.kind == TypeKind.TIMESTAMP and r.kind == TypeKind.DURATION:
            return l
        if l.kind == TypeKind.DATE and r.kind == TypeKind.DURATION:
            return DataType.timestamp(unit_of(r))
        if l.kind == TypeKind.DURATION and r.kind == TypeKind.DURATION:
            return DataType.duration(unit_of(l))
    if op == "+":
        if l.kind == TypeKind.TIMESTAMP and r.kind == TypeKind.DURATION:
            return l
        if l.kind == TypeKind.DURATION and r.kind == TypeKind.TIMESTAMP:
            return r
        if l.kind == TypeKind.DATE and r.kind == TypeKind.DURATION:
            return DataType.timestamp(unit_of(r))
        if l.kind == TypeKind.DURATION and r.kind == TypeKind.DATE:
            return DataType.timestamp(unit_of(l))
        if l.kind == TypeKind.DURATION and r.kind == TypeKind.DURATION:
            return DataType.duration(unit_of(l))
    if op in ("*", "/", "//") and (l.kind == TypeKind.DURATION) != (r.kind == TypeKind.DURATION):
        return l if l.kind == TypeKind.DURATION else r
    raise DaftValueError(f"unsupported temporal arithmetic: {l} {op} {r}")



class Not(ExprNode):
    def __init__(self, child: ExprNode):
        self.child = child

    def name(self):
        return self.child.name()

    def to_field(self, schema):
        f = self.child.to_field(schema)
        if not (f.dtype.is_boolean() or f.dtype.is_null()):
            raise DaftValueError(f"~ expects bool, got {f.dtype}")
        return Field(f.name, DataType.bool())

    def _eval(self, table):
        return (~self.child.evaluate(table)).rename(self.name())

    def children(self):
        return [self.child]

    def with_children(self, c):
        return Not(c[0])

    def is_aggregation(self):
        return self.child.is_aggregation()

    def display(self):
        return f"~{self.child.display()}"


class IsNull(ExprNode):
    def __init__(self, child: ExprNode, negate: bool = False):
        self.child = child
        self.negate = negate

    def name(self):
        return self.child.name()

    def to_field(self, schema):
        f = self.child.to_field(schema)
        return Field(f.name, DataType.bool())

    def _eval(self, table):
        s = self.child.evaluate(table)
        out = s.not_null() if self.negate else s.is_null()
        return out.rename(self.name())

    def children(self):
        return [self.child]

    def with_children(self, c):
        return IsNull(c[0], self.negate)

    def is_aggregation(self):
        return self.child.is_aggregation()

    def _key(self):
        return ("isnull", self.negate, self.child._key())

    def display(self):
        return f"{self.child.display()}.{'not_null' if self.negate else 'is_null'}()"


class FillNull(ExprNode):
    def __init__(self, child: ExprNode, fill: ExprNode):
        self.child = child
        self.fill = fill

    def name(self):
        return self.child.name()

    def to_field(self, schema):
        f = self.child.to_field(schema)
        g = self.fill.to_field(schema)
        _, _, cdt, fdt = effective_operands(self.child, self.fill, f.dtype, g.dtype)
        u = try_unify(cdt, fdt)
        if u is None:
            raise DaftValueError(f"fill_null type mismatch: {f.dtype} vs {g.dtype}")
        return Field(f.name, u)

    def _eval(self, table):
        f = self.to_field(table.schema)
        s = self.child.evaluate(table).cast(f.dtype)
        fill = self.fill.evaluate(table).cast(f.dtype)
        return s.fill_null(fill).rename(self.name())

    def children(self):
        return [self.child, self.fill]

    def with_children(self, c):
        return FillNull(c[0], c[1])

    def is_aggregation(self):
        return self.child.is_aggregation() or self.fill.is_aggregation()

    def display(self):
        return f"{self.child.display()}.fill_null({self.fill.display()})"


class IsIn(ExprNode):
    def __init__(self, child: ExprNode, items: ExprNode):
        self.child = child
        self.items = items

    def name(self):
        return self.child.name()

    def to_field(self, schema):
        f = self.child.to_field(schema)
        return Field(f.name, DataType.bool())

    def _eval(self, table):
        s = self.child.evaluate(table)
        items = self.items.evaluate(table)
        if items.dtype.is_list() and len(items) == 1:
            items = Series.from_pylist(items.to_pylist()[0], "items")
        return s.is_in(items).rename(self.name())

    def children(self):
        return [self.child, self.items]

    def with_children(self, c):
        return IsIn(c[0], c[1])

    def is_aggregation(self):
        return self.child.is_aggregation()

    def display(self):
        return f"{self.child.display()}.is_in({self.items.display()})"


class Between(ExprNode):
    def __init__(self, child: ExprNode, lower: ExprNode, upper: ExprNode):
        self.child = child
        self.lower = lower
        self.upper = upper

    def name(self):
        return self.child.name()

    def to_field(self, schema):
        f = self.child.to_field(schema)
        self.lower.to_field(schema)
        self.upper.to_field(schema)
        return Field(f.name, DataType.bool())

    def _eval(self, table):
        s = self.child.evaluate(table)
        lo = self.lower.evaluate(table)
        hi = self.upper.evaluate(table)
        # weak-literal bounds adopt the tested expression's dtype, mirroring
        # normalize_literals so host and device agree on comparison precision
        _, _, _, lodt = effective_operands(self.child, self.lower, s.dtype, lo.dtype)
        _, _, _, hidt = effective_operands(self.child, self.upper, s.dtype, hi.dtype)
        if lodt != lo.dtype:
            lo = lo.cast(lodt)
        if hidt != hi.dtype:
            hi = hi.cast(hidt)
        return s.between(lo, hi).rename(self.name())

    def children(self):
        return [self.child, self.lower, self.upper]

    def with_children(self, c):
        return Between(c[0], c[1], c[2])

    def is_aggregation(self):
        return self.child.is_aggregation()

    def display(self):
        return f"{self.child.display()}.between({self.lower.display()}, {self.upper.display()})"


class IfElse(ExprNode):
    def __init__(self, pred: ExprNode, if_true: ExprNode, if_false: ExprNode):
        self.pred = pred
        self.if_true = if_true
        self.if_false = if_false

    def name(self):
        return self.if_true.name()

    def to_field(self, schema):
        p = self.pred.to_field(schema)
        if not (p.dtype.is_boolean() or p.dtype.is_null()):
            raise DaftValueError(f"if_else predicate must be bool, got {p.dtype}")
        t = self.if_true.to_field(schema)
        f = self.if_false.to_field(schema)
        _, _, tdt, fdt = effective_operands(self.if_true, self.if_false, t.dtype, f.dtype)
        u = try_unify(tdt, fdt)
        if u is None:
            raise DaftValueError(f"if_else branches incompatible: {t.dtype} vs {f.dtype}")
        return Field(t.name, u)

    def _eval(self, table):
        out_dt = self.to_field(table.schema).dtype
        p = self.pred.evaluate(table)
        t = self.if_true.evaluate(table)
        f = self.if_false.evaluate(table)
        if t.dtype != out_dt:
            t = t.cast(out_dt)
        if f.dtype != out_dt:
            f = f.cast(out_dt)
        return p.if_else(t, f).rename(self.name())

    def children(self):
        return [self.pred, self.if_true, self.if_false]

    def with_children(self, c):
        return IfElse(c[0], c[1], c[2])

    def is_aggregation(self):
        return any(c.is_aggregation() for c in self.children())

    def display(self):
        return f"{self.pred.display()}.if_else({self.if_true.display()}, {self.if_false.display()})"


class Function(ExprNode):
    """A registered scalar function over expression arguments
    (daft_tpu_torch/functions.py)."""

    def __init__(self, fname: str, args: List[ExprNode], kwargs: Optional[Dict[str, Any]] = None):
        self.fname = fname
        self.args = args
        self.kwargs = kwargs or {}

    def name(self):
        if self.fname == "struct.get":  # named after the field it extracts
            return self.kwargs.get("name", "")
        return self.args[0].name() if self.args else self.fname

    def to_field(self, schema):
        spec = get_function(self.fname)
        arg_dts = [a.to_field(schema).dtype for a in self.args]
        return Field(self.name(), spec.resolve(*arg_dts, **self.kwargs))

    def _eval(self, table):
        spec = get_function(self.fname)
        args = [a.evaluate(table) for a in self.args]
        return spec.evaluate(*args, **self.kwargs).rename(self.name())

    def children(self):
        return list(self.args)

    def with_children(self, c):
        return Function(self.fname, c, self.kwargs)

    def is_aggregation(self):
        return any(a.is_aggregation() for a in self.args)

    def _key(self):
        return ("fn", self.fname, tuple(sorted((k, repr(v)) for k, v in self.kwargs.items())),
                tuple(a._key() for a in self.args))

    def display(self):
        inner = ", ".join(a.display() for a in self.args)
        return f"{self.fname}({inner})"


class PyUdf(ExprNode):
    """A python UDF call (udf.py's batch trampoline)."""

    def __init__(self, fn: Callable, return_dtype: DataType, args: List[ExprNode],
                 fn_name: Optional[str] = None, batch_size: Optional[int] = None,
                 concurrency: Optional[int] = None, init_args: Optional[tuple] = None,
                 resource_request: Optional[tuple] = None,
                 batching: Optional[dict] = None):
        self.fn = fn
        self.return_dtype = return_dtype
        self.args = args
        self.fn_name = fn_name or getattr(fn, "__name__", "udf")
        self.batch_size = batch_size
        self.concurrency = concurrency
        self.init_args = init_args
        # (num_cpus, num_gpus, memory_bytes): the executor admits each
        # partition of an op that evaluates it (execution.ResourceAccountant)
        self.resource_request = resource_request
        # the dynamic-batching declaration (batch/): the user's contract that
        # the fn is ROW-LOCAL, so the engine may coalesce partitions into
        # batches and re-split the output. None is undeclared (the
        # per-partition UDF path). Keys: max_rows, max_bytes, flush_ms, mode
        # ("ragged" | "padded"), device, all optional; the config fills the gaps
        self.batching = batching

    def name(self):
        return self.args[0].name() if self.args else self.fn_name

    def to_field(self, schema):
        for a in self.args:
            a.to_field(schema)
        return Field(self.name(), self.return_dtype)

    # user functions may be non-deterministic: never memoize the udf call itself
    def evaluate(self, table):
        return self._eval(table)

    def _eval(self, table):
        from .udf import run_udf

        args = [a.evaluate(table) for a in self.args]
        return run_udf(self.fn, args, self.return_dtype, len(table), self.batch_size,
                       self.init_args, self.concurrency,
                       batching=self.batching).rename(self.name())

    def children(self):
        return list(self.args)

    def with_children(self, c):
        return PyUdf(self.fn, self.return_dtype, c, self.fn_name, self.batch_size,
                     self.concurrency, self.init_args, self.resource_request, self.batching)

    def _key(self):
        return ("udf", id(self.fn), tuple(a._key() for a in self.args))

    def display(self):
        return f"udf:{self.fn_name}({', '.join(a.display() for a in self.args)})"


AGG_KINDS = ("sum", "mean", "min", "max", "count", "count_distinct", "any_value", "list",
             "concat", "stddev", "approx_count_distinct", "approx_percentiles", "skew",
             # the planner's sketch stages (populate_aggregation_stages
             # decomposes approx_* into them; users never write them)
             "sketch_hll", "sketch_quantile", "merge_sketch_hll", "merge_sketch_quantile")


def _numeric_input(dt: DataType) -> bool:
    return dt.is_numeric() or dt.is_boolean() or dt.is_null()


class AggExpr(ExprNode):
    """An aggregation over a child expression (reference: AggExpr, expr.rs:72)."""

    def __init__(self, kind: str, child: ExprNode, extra: Optional[Dict[str, Any]] = None):
        if kind not in AGG_KINDS:
            raise DaftValueError(f"unknown aggregation {kind!r}")
        self.kind = kind
        self.child = child
        self.extra = extra or {}

    def name(self):
        return self.child.name()

    def to_field(self, schema):
        f = self.child.to_field(schema)
        k = self.kind
        if k in ("count", "count_distinct", "approx_count_distinct"):
            return Field(f.name, DataType.uint64())
        if k == "sum":
            dt = f.dtype
            if dt.is_signed_integer() or dt.is_boolean():
                dt = DataType.int64()
            elif dt.is_unsigned_integer():
                dt = DataType.uint64()
            return Field(f.name, dt)
        if k in ("mean", "stddev", "skew"):
            return Field(f.name, DataType.float64())
        if k == "list":
            return Field(f.name, DataType.list(f.dtype))
        if k == "concat" and not (f.dtype.is_list() or f.dtype.is_string()):
            raise DaftValueError(f"agg_concat needs list/string, got {f.dtype}")
        if k == "approx_percentiles":
            if not _numeric_input(f.dtype):
                raise DaftValueError(
                    f"approx_percentiles needs a numeric input, got {f.dtype}")
            if isinstance(self.extra.get("percentiles"), float):
                return Field(f.name, DataType.float64())
            return Field(f.name, DataType.list(DataType.float64()))
        if k == "sketch_quantile" and not _numeric_input(f.dtype):
            raise DaftValueError(f"sketch_quantile needs a numeric input, got {f.dtype}")
        if k in ("merge_sketch_hll", "merge_sketch_quantile") and not (
                f.dtype.is_binary() or f.dtype.is_null()):
            raise DaftValueError(f"{k} merges serialized sketches (binary), got {f.dtype}")
        if k in ("sketch_hll", "sketch_quantile", "merge_sketch_hll", "merge_sketch_quantile"):
            return Field(f.name, DataType.binary())
        return Field(f.name, f.dtype)  # min / max / any_value / concat

    def _eval(self, table) -> Series:
        # global (ungrouped) aggregation path; grouped agg handled by Table.agg
        s = self.child.evaluate(table)
        return _eval_agg_on_series(self, s).rename(self.name())

    def children(self):
        return [self.child]

    def with_children(self, c):
        return AggExpr(self.kind, c[0], self.extra)

    def is_aggregation(self):
        return True

    def _key(self):
        return ("agg", self.kind, tuple(sorted((k, repr(v)) for k, v in self.extra.items())),
                self.child._key())

    def display(self):
        return f"{self.child.display()}.{self.kind}()"


def _eval_agg_on_series(agg: AggExpr, s: Series) -> Series:
    k = agg.kind
    if k == "count":
        return s.count(agg.extra.get("mode", "valid"))
    if k == "count_distinct":
        import pyarrow.compute as pc

        return Series.from_pylist([pc.count_distinct(s.to_arrow()).as_py()], s.name,
                                  DataType.uint64())
    if k == "any_value":
        return s.any_value(agg.extra.get("ignore_nulls", False))
    if k == "list":
        return s.agg_list()
    if k == "concat":
        return s.agg_concat()
    if k == "approx_count_distinct":
        return s.approx_count_distinct()
    if k == "approx_percentiles":
        return s.approx_percentiles(agg.extra.get("percentiles", 0.5))
    if k in ("sketch_hll", "merge_sketch_hll"):
        from .sketch import hll

        return (hll.build_grouped if k == "sketch_hll" else hll.merge_grouped)(s, None, 1)
    if k in ("sketch_quantile", "merge_sketch_quantile"):
        from .sketch import quantile

        return (quantile.build_grouped if k == "sketch_quantile"
                else quantile.merge_grouped)(s, None, 1)
    if k == "skew":
        # numpy's population moments over the non-null values; a constant
        # input gives 0.0, an empty one null
        import numpy as np

        v = np.asarray(s.cast(DataType.float64()).to_arrow().drop_null(), dtype=np.float64)
        if len(v) == 0:
            return Series.from_pylist([None], s.name, DataType.float64())
        m = v.mean()
        sd = v.std()
        out = 0.0 if sd == 0 else float(((v - m) ** 3).mean() / sd ** 3)
        return Series.from_pylist([out], s.name, DataType.float64())
    return getattr(s, k)()  # sum / mean / stddev / min / max


# ---------------------------------------------------------------------------
# Public Expression facade
# ---------------------------------------------------------------------------

def _as_expr_node(v) -> ExprNode:
    if isinstance(v, Expression):
        return v._node
    if isinstance(v, ExprNode):
        return v
    return Literal(v)


def expr_has_udf(e: "Expression") -> bool:
    """True if any node of the expression tree is a user function call."""
    def rec(n):
        return isinstance(n, PyUdf) or any(rec(c) for c in n.children())

    return rec(e._node)


def expr_has_batch_udf(e: "Expression") -> bool:
    """True if any UDF node carries a dynamic-batching declaration (batch/).
    The planner routes such projections through BatchedUdfOp."""
    def rec(n):
        if isinstance(n, PyUdf) and n.batching is not None:
            return True
        return any(rec(c) for c in n.children())

    return rec(e._node)


def expr_batch_udfs(e: "Expression") -> list:
    """All batch-declared PyUdf nodes in the expression tree, in eval order."""
    out = []

    def rec(n):
        if isinstance(n, PyUdf) and n.batching is not None:
            out.append(n)
        for c in n.children():
            rec(c)

    rec(e._node)
    return out


def expr_udfs_parallel_safe(e: "Expression") -> bool:
    """Whether partitions of this expression may evaluate concurrently. Plain
    function UDFs (and bare class UDFs sharing one cached instance) carry
    user state with no thread-safety contract; class UDFs on an actor pool
    (concurrency > 1) serialize calls per instance and are safe."""
    import inspect

    def rec(n):
        if isinstance(n, PyUdf):
            if not (inspect.isclass(n.fn) and (n.concurrency or 0) > 1):
                return False
        return all(rec(c) for c in n.children())

    return rec(e._node)


class Expression:
    """User-facing expression wrapper with operators and namespaces."""

    __slots__ = ("_node",)

    def __init__(self, node: ExprNode):
        self._node = node

    # --- naming / typing
    def name(self) -> str:
        return self._node.name()

    def alias(self, name: str) -> "Expression":
        return Expression(Alias(self._node, name))

    def cast(self, dtype: DataType) -> "Expression":
        return Expression(Cast(self._node, dtype))

    def to_field(self, schema: Schema) -> Field:
        return self._node.to_field(schema)

    # --- operators
    def _bin(self, op: str, other, reverse=False) -> "Expression":
        o = _as_expr_node(other)
        l, r = (o, self._node) if reverse else (self._node, o)
        return Expression(BinaryOp(op, l, r))

    def __add__(self, o):
        return self._bin("+", o)

    def __radd__(self, o):
        return self._bin("+", o, True)

    def __sub__(self, o):
        return self._bin("-", o)

    def __rsub__(self, o):
        return self._bin("-", o, True)

    def __mul__(self, o):
        return self._bin("*", o)

    def __rmul__(self, o):
        return self._bin("*", o, True)

    def __truediv__(self, o):
        return self._bin("/", o)

    def __rtruediv__(self, o):
        return self._bin("/", o, True)

    def __floordiv__(self, o):
        return self._bin("//", o)

    def __rfloordiv__(self, o):
        return self._bin("//", o, True)

    def __mod__(self, o):
        return self._bin("%", o)

    def __rmod__(self, o):
        return self._bin("%", o, True)

    def __pow__(self, o):
        return self._bin("**", o)

    def __eq__(self, o):  # type: ignore[override]
        return self._bin("==", o)

    def __ne__(self, o):  # type: ignore[override]
        return self._bin("!=", o)

    def __lt__(self, o):
        return self._bin("<", o)

    def __le__(self, o):
        return self._bin("<=", o)

    def __gt__(self, o):
        return self._bin(">", o)

    def __ge__(self, o):
        return self._bin(">=", o)

    def eq_null_safe(self, o):
        return self._bin("<=>", o)

    def __and__(self, o):
        return self._bin("&", o)

    def __rand__(self, o):
        return self._bin("&", o, True)

    def __or__(self, o):
        return self._bin("|", o)

    def __ror__(self, o):
        return self._bin("|", o, True)

    def __xor__(self, o):
        return self._bin("^", o)

    def __invert__(self):
        return Expression(Not(self._node))

    def __neg__(self):
        return self._fn("numeric.negate")

    def __abs__(self):
        return self.abs()

    def __hash__(self):
        return hash(repr(self._node._key()))

    def __bool__(self):
        raise DaftValueError(
            "Expressions are lazy and have no truth value; use & | ~ instead of and/or/not"
        )

    # --- null / membership
    def is_null(self):
        return Expression(IsNull(self._node))

    def not_null(self):
        return Expression(IsNull(self._node, negate=True))

    def fill_null(self, fill):
        return Expression(FillNull(self._node, _as_expr_node(fill)))

    def is_in(self, items):
        if isinstance(items, (list, tuple)):
            items = Literal(list(items), DataType.list(DataType.null()) if not items else None)
        return Expression(IsIn(self._node, _as_expr_node(items)))

    def between(self, lower, upper):
        return Expression(Between(self._node, _as_expr_node(lower), _as_expr_node(upper)))

    def if_else(self, if_true, if_false):
        return Expression(IfElse(self._node, _as_expr_node(if_true), _as_expr_node(if_false)))

    # --- functions
    def _fn(self, _fname: str, *args, **kwargs) -> "Expression":
        return Expression(Function(_fname, [self._node] + [_as_expr_node(a) for a in args],
                                   kwargs))

    def abs(self):
        return self._fn("numeric.abs")

    def ceil(self):
        return self._fn("numeric.ceil")

    def floor(self):
        return self._fn("numeric.floor")

    def sign(self):
        return self._fn("numeric.sign")

    def round(self, decimals: int = 0):
        return self._fn("numeric.round", decimals=decimals)

    def sqrt(self):
        return self._fn("numeric.sqrt")

    def cbrt(self):
        return self._fn("numeric.cbrt")

    def exp(self):
        return self._fn("numeric.exp")

    def log(self, base: Optional[float] = None):
        return self._fn("numeric.log", base=base)

    def log2(self):
        return self._fn("numeric.log2")

    def log10(self):
        return self._fn("numeric.log10")

    def ln(self):
        return self._fn("numeric.log")

    def sin(self):
        return self._fn("numeric.sin")

    def cos(self):
        return self._fn("numeric.cos")

    def tan(self):
        return self._fn("numeric.tan")

    def arcsin(self):
        return self._fn("numeric.arcsin")

    def arccos(self):
        return self._fn("numeric.arccos")

    def arctan(self):
        return self._fn("numeric.arctan")

    def arctanh(self):
        return self._fn("numeric.arctanh")

    def arccosh(self):
        return self._fn("numeric.arccosh")

    def arcsinh(self):
        return self._fn("numeric.arcsinh")

    def radians(self):
        return self._fn("numeric.radians")

    def degrees(self):
        return self._fn("numeric.degrees")

    def shift_left(self, o):
        return self._fn("numeric.shift_left", o)

    def shift_right(self, o):
        return self._fn("numeric.shift_right", o)

    def hash(self, seed=None):
        if seed is None:
            return self._fn("hash")
        return self._fn("hash", seed)

    def minhash(self, num_hashes: int = 64, ngram_size: int = 1, seed: int = 1):
        return self._fn("minhash", num_hashes=num_hashes, ngram_size=ngram_size, seed=seed)

    # --- aggregations
    def _agg(self, kind: str, **extra) -> "Expression":
        return Expression(AggExpr(kind, self._node, extra))

    def sum(self):
        return self._agg("sum")

    def mean(self):
        return self._agg("mean")

    def min(self):
        return self._agg("min")

    def max(self):
        return self._agg("max")

    def count(self, mode: str = "valid"):
        return self._agg("count", mode=mode)

    def count_distinct(self):
        return self._agg("count_distinct")

    def stddev(self):
        return self._agg("stddev")

    def skew(self):
        return self._agg("skew")

    def any_value(self, ignore_nulls: bool = False):
        return self._agg("any_value", ignore_nulls=ignore_nulls)

    def agg_list(self):
        return self._agg("list")

    def agg_concat(self):
        return self._agg("concat")

    def approx_count_distinct(self):
        return self._agg("approx_count_distinct")

    def approx_percentiles(self, percentiles):
        return self._agg("approx_percentiles", percentiles=percentiles)

    # --- namespaces
    @property
    def str(self) -> "ExprStrNamespace":
        return ExprStrNamespace(self)

    @property
    def dt(self) -> "ExprDtNamespace":
        return ExprDtNamespace(self)

    @property
    def list(self) -> "ExprListNamespace":
        return ExprListNamespace(self)

    @property
    def struct(self) -> "ExprStructNamespace":
        return ExprStructNamespace(self)

    @property
    def map(self) -> "ExprMapNamespace":
        return ExprMapNamespace(self)

    @property
    def float(self) -> "ExprFloatNamespace":
        return ExprFloatNamespace(self)

    @property
    def image(self) -> "ExprImageNamespace":
        from .multimodal import ExprImageNamespace

        return ExprImageNamespace(self)

    @property
    def url(self) -> "ExprUrlNamespace":
        from .multimodal import ExprUrlNamespace

        return ExprUrlNamespace(self)

    @property
    def embedding(self) -> "ExprEmbeddingNamespace":
        return ExprEmbeddingNamespace(self)

    @property
    def partitioning(self) -> "ExprPartitioningNamespace":
        return ExprPartitioningNamespace(self)

    @property
    def json(self) -> "ExprJsonNamespace":
        return ExprJsonNamespace(self)

    def apply(self, fn: Callable, return_dtype: DataType) -> "Expression":
        """Apply a row-wise python function (a convenience UDF)."""
        def batch_fn(s: Series):
            return [fn(v) for v in s.to_pylist()]

        return Expression(PyUdf(batch_fn, return_dtype, [self._node],
                                fn_name=getattr(fn, "__name__", "apply")))

    def __repr__(self) -> str:
        return self._node.display()


class _Namespace:
    __slots__ = ("_e",)

    def __init__(self, e: Expression):
        self._e = e

    def _fn(self, _fname, *args, **kwargs):
        return self._e._fn(_fname, *args, **kwargs)


class ExprStrNamespace(_Namespace):
    def contains(self, pat):
        return self._fn("utf8.contains", pat)

    def startswith(self, pat):
        return self._fn("utf8.startswith", pat)

    def endswith(self, pat):
        return self._fn("utf8.endswith", pat)

    def match(self, pat):
        return self._fn("utf8.match", pat)

    def split(self, pat, regex: bool = False):
        return self._fn("utf8.split", pat, regex=regex)

    def length(self):
        return self._fn("utf8.length")

    def length_bytes(self):
        return self._fn("utf8.length_bytes")

    def lower(self):
        return self._fn("utf8.lower")

    def upper(self):
        return self._fn("utf8.upper")

    def capitalize(self):
        return self._fn("utf8.capitalize")

    def reverse(self):
        return self._fn("utf8.reverse")

    def lstrip(self):
        return self._fn("utf8.lstrip")

    def rstrip(self):
        return self._fn("utf8.rstrip")

    def replace(self, pat, replacement, regex: bool = False):
        return self._fn("utf8.replace", pat, replacement, regex=regex)

    def extract(self, pat, index: int = 0):
        return self._fn("utf8.extract", pat, index=index)

    def extract_all(self, pat, index: int = 0):
        return self._fn("utf8.extract_all", pat, index=index)

    def find(self, substr):
        return self._fn("utf8.find", substr)

    def left(self, n):
        return self._fn("utf8.left", n)

    def right(self, n):
        return self._fn("utf8.right", n)

    def substr(self, start, length=None):
        if length is None:
            return self._fn("utf8.substr", start)
        return self._fn("utf8.substr", start, length)

    def concat(self, *others):
        return self._fn("utf8.concat", *others)

    def like(self, pat):
        return self._fn("utf8.like", pat)

    def ilike(self, pat):
        return self._fn("utf8.ilike", pat)

    def rpad(self, length, ch):
        return self._fn("utf8.rpad", length, ch)

    def lpad(self, length, ch):
        return self._fn("utf8.lpad", length, ch)

    def repeat(self, n):
        return self._fn("utf8.repeat", n)

    def count_matches(self, patterns, whole_words: bool = False, case_sensitive: bool = True):
        return self._fn("utf8.count_matches", patterns, whole_words=whole_words,
                        case_sensitive=case_sensitive)

    def normalize(self, *, remove_punct: bool = False, lowercase: bool = False,
                  nfd_unicode: bool = False, white_space: bool = False):
        return self._fn("utf8.normalize", remove_punct=remove_punct, lowercase=lowercase,
                        nfd_unicode=nfd_unicode, white_space=white_space)


class ExprDtNamespace(_Namespace):
    def year(self):
        return self._fn("dt.year")

    def month(self):
        return self._fn("dt.month")

    def day(self):
        return self._fn("dt.day")

    def hour(self):
        return self._fn("dt.hour")

    def minute(self):
        return self._fn("dt.minute")

    def second(self):
        return self._fn("dt.second")

    def day_of_week(self):
        return self._fn("dt.day_of_week")

    def day_of_year(self):
        return self._fn("dt.day_of_year")

    def date(self):
        return self._fn("dt.date")

    def time(self):
        return self._fn("dt.time")

    def truncate(self, interval: str, relative_to=None):
        return self._fn("dt.truncate", interval=interval, relative_to=relative_to)

    def strftime(self, format: Optional[str] = None):
        return self._fn("dt.strftime", fmt=format)

    def to_unix_epoch(self, unit: str = "s"):
        return self._fn("dt.to_unix_epoch", unit=unit)


class ExprListNamespace(_Namespace):
    def lengths(self):
        return self._fn("list.lengths")

    def length(self):
        return self._fn("list.lengths")

    def get(self, idx, default=None):
        if default is None:
            return self._fn("list.get", idx)
        return self._fn("list.get", idx, default)

    def slice(self, start, end=None):
        if end is None:
            return self._fn("list.slice", start)
        return self._fn("list.slice", start, end)

    def chunk(self, size: int):
        return self._fn("list.chunk", size=size)

    def join(self, sep):
        return self._fn("list.join", sep)

    def sum(self):
        return self._fn("list.sum")

    def mean(self):
        return self._fn("list.mean")

    def min(self):
        return self._fn("list.min")

    def max(self):
        return self._fn("list.max")

    def count(self, mode: str = "valid"):
        return self._fn("list.count", mode=mode)

    def sort(self, desc=None):
        if desc is None:
            return self._fn("list.sort")
        return self._fn("list.sort", desc)

    def unique(self):
        return self._fn("list.unique")

    def distinct(self):
        return self._fn("list.unique")

    def contains(self, item):
        return self._fn("list.contains", item)


class ExprStructNamespace(_Namespace):
    def get(self, name: str):
        return self._fn("struct.get", name=name)


class ExprMapNamespace(_Namespace):
    def get(self, key):
        return self._fn("map.get", key)


class ExprFloatNamespace(_Namespace):
    def is_nan(self):
        return self._fn("float.is_nan")

    def is_inf(self):
        return self._fn("float.is_inf")

    def not_nan(self):
        return self._fn("float.not_nan")

    def fill_nan(self, fill):
        return self._fn("float.fill_nan", fill)


class ExprEmbeddingNamespace(_Namespace):
    def cosine_distance(self, other):
        return self._fn("embedding.cosine_distance", other)


class ExprPartitioningNamespace(_Namespace):
    def days(self):
        return self._fn("partitioning.days")

    def hours(self):
        return self._fn("partitioning.hours")

    def months(self):
        return self._fn("partitioning.months")

    def years(self):
        return self._fn("partitioning.years")

    def iceberg_bucket(self, n: int):
        return self._fn("partitioning.iceberg_bucket", n=n)

    def iceberg_truncate(self, w: int):
        return self._fn("partitioning.iceberg_truncate", w=w)


class ExprJsonNamespace(_Namespace):
    def query(self, q: str):
        return self._fn("json.query", query=q)


def required_columns(e: Union[Expression, ExprNode]) -> List[str]:
    node = e._node if isinstance(e, Expression) else e
    out: List[str] = []

    def walk(n: ExprNode):
        if isinstance(n, Column):
            if n.cname not in out:
                out.append(n.cname)
        for c in n.children():
            walk(c)

    walk(node)
    return out
