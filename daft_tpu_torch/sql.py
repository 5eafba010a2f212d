"""SQL front end: a tokenizer and a recursive-descent planner onto the
DataFrame API (the port's copy of daft_tpu/sql.py, bound to the port's
DataType, Expression, col and lit).

The surface: SELECT [DISTINCT] with aliases, FROM tables and (subquery)
aliases, INNER/LEFT/RIGHT/FULL/CROSS JOIN with ON equi-conditions or
USING(...), WHERE, GROUP BY (expressions, positions or select aliases),
HAVING, ORDER BY [ASC|DESC] [NULLS FIRST|LAST], LIMIT, aggregates with
COUNT(*), COUNT(DISTINCT x) and compound aggregate expressions (SUM(x)*2),
CASE, CAST, BETWEEN, IN, LIKE/ILIKE, IS [NOT] NULL, COALESCE/NULLIF/IF, and
a scalar function library over the numeric, string and temporal
namespaces. The function table is the reference's, APPROX_COUNT_DISTINCT
(the HyperLogLog aggregation) among the aggregates. Joins build in the
text's FROM order, so a SQL text and its DataFrame twin may plan
differently.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from .datatypes import DataType
from .expressions import Expression, col, lit

# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>--[^\n]*)
  | (?P<number>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
  | (?P<string>'(?:[^']|'')*')
  | (?P<qident>"(?:[^"]|"")*")
  | (?P<ident>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<op><=>|<>|!=|<=|>=|\|\||<<|>>|[-+*/%<>=(),.\[\]])
""", re.VERBOSE)


class Token:
    __slots__ = ("kind", "value", "pos")

    def __init__(self, kind: str, value: str, pos: int):
        self.kind = kind
        self.value = value
        self.pos = pos

    def __repr__(self):
        return f"Token({self.kind},{self.value!r})"


def tokenize(text: str) -> List[Token]:
    out: List[Token] = []
    i = 0
    while i < len(text):
        m = _TOKEN_RE.match(text, i)
        if not m:
            raise ValueError(f"SQL syntax error at position {i}: {text[i:i+20]!r}")
        i = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        val = m.group()
        if kind == "ident":
            out.append(Token("ident", val, m.start()))
        elif kind == "string":
            out.append(Token("string", val[1:-1].replace("''", "'"), m.start()))
        elif kind == "qident":
            out.append(Token("ident", val[1:-1].replace('""', '"'), m.start()))
        else:
            out.append(Token(kind, val, m.start()))
    out.append(Token("eof", "", len(text)))
    return out


_TYPE_NAMES = {
    "TINYINT": DataType.int8, "SMALLINT": DataType.int16,
    "INT": DataType.int32, "INTEGER": DataType.int32,
    "BIGINT": DataType.int64, "LONG": DataType.int64,
    "FLOAT": DataType.float32, "REAL": DataType.float32,
    "DOUBLE": DataType.float64,
    "TEXT": DataType.string, "VARCHAR": DataType.string, "STRING": DataType.string,
    "BOOL": DataType.bool, "BOOLEAN": DataType.bool,
    "DATE": DataType.date, "BINARY": DataType.binary, "BYTES": DataType.binary,
}

_AGG_FNS = {"SUM", "AVG", "MEAN", "MIN", "MAX", "COUNT", "STDDEV", "STDDEV_SAMP",
            "ANY_VALUE", "APPROX_COUNT_DISTINCT", "COUNT_DISTINCT", "LIST", "ARRAY_AGG"}

_CLAUSE_KWS = ("FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "UNION",
               "JOIN", "ON", "AND", "OR", "USING", "INNER", "LEFT", "RIGHT",
               "FULL", "CROSS", "AS", "ASC", "DESC", "NULLS")

# words that may never be parsed as a bare column reference
_RESERVED = set(_CLAUSE_KWS) | {"SELECT", "BY", "DISTINCT", "WHEN", "THEN",
                                "ELSE", "END", "IS", "IN", "BETWEEN", "LIKE",
                                "ILIKE", "NOT"}


class Parser:
    """Recursive-descent parser; `catalog` maps table name -> DataFrame."""

    def __init__(self, tokens: List[Token], catalog: Dict[str, "object"]):
        self.toks = tokens
        self.i = 0
        self.catalog = {k.lower(): v for k, v in catalog.items()}
        # qualifier -> {source column -> actual output column} (joins rename
        # right-side duplicates with the "right." suffix)
        self._alias_cols: Dict[str, Dict[str, str]] = {}

    # -- token helpers ------------------------------------------------------
    def peek(self, k: int = 0) -> Token:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "ident" and t.value.upper() in kws

    def eat_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.eat_kw(kw):
            raise ValueError(f"expected {kw} at {self.peek().value!r}")

    def eat_op(self, op: str) -> bool:
        if self.peek().kind == "op" and self.peek().value == op:
            self.next()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.eat_op(op):
            raise ValueError(f"expected {op!r} at {self.peek().value!r}")

    # -- expressions --------------------------------------------------------
    def parse_expr(self) -> Expression:
        return self._or()

    def _or(self) -> Expression:
        e = self._and()
        while self.eat_kw("OR"):
            e = e | self._and()
        return e

    def _and(self) -> Expression:
        e = self._not()
        while self.eat_kw("AND"):
            e = e & self._not()
        return e

    def _not(self) -> Expression:
        if self.eat_kw("NOT"):
            return ~self._not()
        return self._predicate()

    def _predicate(self) -> Expression:
        e = self._additive()
        saw_cmp = False
        while True:
            neg = False
            save = self.i
            if self.eat_kw("NOT"):
                if self.at_kw("IN", "BETWEEN", "LIKE", "ILIKE"):
                    neg = True
                else:
                    self.i = save
                    break
            if self.eat_kw("IS"):
                isnot = self.eat_kw("NOT")
                self.expect_kw("NULL")
                e = e.not_null() if isnot else e.is_null()
            elif self.eat_kw("BETWEEN"):
                lo = self._additive()
                self.expect_kw("AND")
                hi = self._additive()
                e = e.between(lo, hi)
                if neg:
                    e = ~e
            elif self.eat_kw("IN"):
                self.expect_op("(")
                items = [self._literal_value()]
                while self.eat_op(","):
                    items.append(self._literal_value())
                self.expect_op(")")
                e = e.is_in(items)
                if neg:
                    e = ~e
            elif self.at_kw("LIKE", "ILIKE"):
                insensitive = self.next().value.upper() == "ILIKE"
                pat = self.next()
                if pat.kind != "string":
                    raise ValueError("LIKE requires a string literal pattern")
                e = e.str.ilike(pat.value) if insensitive else e.str.like(pat.value)
                if neg:
                    e = ~e
            elif self.peek().kind == "op" and self.peek().value in (
                    "=", "<>", "!=", "<", "<=", ">", ">=", "<=>"):
                if saw_cmp:
                    raise ValueError(
                        "chained comparisons (a < b < c) are not valid SQL; "
                        "use AND")
                saw_cmp = True
                op = self.next().value
                r = self._additive()
                if op == "=":
                    e = e == r
                elif op in ("<>", "!="):
                    e = e != r
                elif op == "<":
                    e = e < r
                elif op == "<=":
                    e = e <= r
                elif op == ">":
                    e = e > r
                elif op == ">=":
                    e = e >= r
                else:
                    e = e.eq_null_safe(r)
            else:
                break
        return e

    def _literal_value(self):
        """IN-list item: a bare python literal."""
        t = self.peek()
        if t.kind == "number":
            self.next()
            return _num(t.value)
        if t.kind == "string":
            self.next()
            return t.value
        if self.eat_kw("NULL"):
            return None
        if self.eat_kw("TRUE"):
            return True
        if self.eat_kw("FALSE"):
            return False
        if self.eat_op("-"):
            tt = self.next()
            if tt.kind != "number":
                raise ValueError("bad IN-list literal")
            return -_num(tt.value)
        raise ValueError(f"IN list supports literals only, got {t.value!r}")

    def _additive(self) -> Expression:
        e = self._mult()
        while True:
            if self.eat_op("+"):
                e = e + self._mult()
            elif self.eat_op("-"):
                e = e - self._mult()
            elif self.eat_op("||"):
                e = e + self._mult()  # string concat
            else:
                return e

    def _mult(self) -> Expression:
        e = self._unary()
        while True:
            if self.eat_op("*"):
                e = e * self._unary()
            elif self.eat_op("/"):
                e = e / self._unary()
            elif self.eat_op("%"):
                e = e % self._unary()
            elif self.eat_op("<<"):
                e = e.shift_left(self._unary())
            elif self.eat_op(">>"):
                e = e.shift_right(self._unary())
            else:
                return e

    def _unary(self) -> Expression:
        if self.eat_op("-"):
            return -self._unary()
        if self.eat_op("+"):
            return self._unary()
        return self._primary()

    def _primary(self) -> Expression:
        t = self.peek()
        if t.kind == "number":
            self.next()
            return lit(_num(t.value))
        if t.kind == "string":
            self.next()
            return lit(t.value)
        if self.eat_op("("):
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind != "ident":
            raise ValueError(f"unexpected token {t.value!r}")
        up = t.value.upper()
        if up == "NULL":
            self.next()
            return lit(None)
        if up == "TRUE":
            self.next()
            return lit(True)
        if up == "FALSE":
            self.next()
            return lit(False)
        if up == "DATE" and self.peek(1).kind == "string":
            self.next()
            import datetime

            return lit(datetime.date.fromisoformat(self.next().value))
        if up == "TIMESTAMP" and self.peek(1).kind == "string":
            self.next()
            import datetime

            return lit(datetime.datetime.fromisoformat(self.next().value))
        if up == "CAST":
            self.next()
            self.expect_op("(")
            e = self.parse_expr()
            self.expect_kw("AS")
            dt = self._type_name()
            self.expect_op(")")
            return e.cast(dt)
        if up == "CASE":
            return self._case()
        if self.peek(1).kind == "op" and self.peek(1).value == "(":
            return self._function_call()
        if up in _RESERVED:
            raise ValueError(f"expected expression, got keyword {t.value!r}")
        # qualified (alias.column) or plain column reference
        self.next()
        name = t.value
        if self.eat_op("."):
            sub = self.next()
            if sub.kind != "ident":
                raise ValueError(f"expected column after {name}.")
            m = self._alias_cols.get(name.lower())
            if m is not None:
                if sub.value not in m:
                    raise ValueError(
                        f"column {sub.value!r} not found in table {name!r}")
                return col(m[sub.value])
            # select list parses before FROM: defer resolution (see
            # _resolve_qualified in _apply_projection)
            return col(f"{name}\x00{sub.value}")
        return col(name)

    def _case(self) -> Expression:
        self.expect_kw("CASE")
        base = None
        if not self.at_kw("WHEN"):
            base = self.parse_expr()
        arms: List[Tuple[Expression, Expression]] = []
        while self.eat_kw("WHEN"):
            c = self.parse_expr()
            if base is not None:
                c = base == c
            self.expect_kw("THEN")
            v = self.parse_expr()
            arms.append((c, v))
        default = lit(None)
        if self.eat_kw("ELSE"):
            default = self.parse_expr()
        self.expect_kw("END")
        out = default
        for c, v in reversed(arms):
            out = c.if_else(v, out)
        return out

    def _type_name(self) -> DataType:
        t = self.next()
        if t.kind != "ident":
            raise ValueError(f"expected type name, got {t.value!r}")
        up = t.value.upper()
        if up in _TYPE_NAMES:
            return _TYPE_NAMES[up]()
        raise ValueError(f"unknown SQL type {t.value!r}")

    def _function_call(self) -> Expression:
        name = self.next().value
        up = name.upper()
        self.expect_op("(")
        if up == "COUNT" and self.eat_op("*"):
            self.expect_op(")")
            # '*' placeholder column is bound to the first input column at
            # planning time (_apply_projection), counting every row.
            return col("*").count(mode="all").alias("count")
        distinct = False
        if up in _AGG_FNS and self.eat_kw("DISTINCT"):
            distinct = True
        args: List[Expression] = []
        if not self.eat_op(")"):
            args.append(self.parse_expr())
            while self.eat_op(","):
                args.append(self.parse_expr())
            self.expect_op(")")
        return _apply_function(up, args, distinct)


def _num(text: str):
    if re.fullmatch(r"\d+", text):
        return int(text)
    return float(text)


_SCALAR_FNS = {
    "ABS": lambda a: a[0].abs(),
    "CEIL": lambda a: a[0].ceil(), "CEILING": lambda a: a[0].ceil(),
    "FLOOR": lambda a: a[0].floor(),
    "SIGN": lambda a: a[0].sign(),
    "ROUND": lambda a: a[0].round(_lit_val(a[1]) if len(a) > 1 else 0),
    "SQRT": lambda a: a[0].sqrt(),
    "CBRT": lambda a: a[0].cbrt(),
    "EXP": lambda a: a[0].exp(),
    "LN": lambda a: a[0].ln(),
    "LOG": lambda a: a[0].log(_lit_val(a[1])) if len(a) > 1 else a[0].log(),
    "LOG2": lambda a: a[0].log2(),
    "LOG10": lambda a: a[0].log10(),
    "SIN": lambda a: a[0].sin(), "COS": lambda a: a[0].cos(), "TAN": lambda a: a[0].tan(),
    "ASIN": lambda a: a[0].arcsin(), "ACOS": lambda a: a[0].arccos(),
    "ATAN": lambda a: a[0].arctan(),
    "RADIANS": lambda a: a[0].radians(), "DEGREES": lambda a: a[0].degrees(),
    "POW": lambda a: a[0] ** a[1], "POWER": lambda a: a[0] ** a[1],
    "UPPER": lambda a: a[0].str.upper(), "LOWER": lambda a: a[0].str.lower(),
    "LENGTH": lambda a: a[0].str.length(),
    "TRIM": lambda a: a[0].str.lstrip().str.rstrip(),
    "LTRIM": lambda a: a[0].str.lstrip(), "RTRIM": lambda a: a[0].str.rstrip(),
    "REVERSE": lambda a: a[0].str.reverse(),
    "CAPITALIZE": lambda a: a[0].str.capitalize(),
    "CONTAINS": lambda a: a[0].str.contains(a[1]),
    "STARTS_WITH": lambda a: a[0].str.startswith(a[1]),
    "ENDS_WITH": lambda a: a[0].str.endswith(a[1]),
    "REGEXP_MATCH": lambda a: a[0].str.match(a[1]),
    "REPLACE": lambda a: a[0].str.replace(a[1], a[2]),
    "SPLIT": lambda a: a[0].str.split(a[1]),
    "SUBSTR": lambda a: a[0].str.substr(a[1] - 1, a[2] if len(a) > 2 else None),
    "SUBSTRING": lambda a: a[0].str.substr(a[1] - 1, a[2] if len(a) > 2 else None),
    "CONCAT": lambda a: _chain_add(a),
    "LPAD": lambda a: a[0].str.lpad(_lit_val(a[1]), _lit_val(a[2])),
    "RPAD": lambda a: a[0].str.rpad(_lit_val(a[1]), _lit_val(a[2])),
    "YEAR": lambda a: a[0].dt.year(), "MONTH": lambda a: a[0].dt.month(),
    "DAY": lambda a: a[0].dt.day(), "HOUR": lambda a: a[0].dt.hour(),
    "MINUTE": lambda a: a[0].dt.minute(), "SECOND": lambda a: a[0].dt.second(),
    "DAY_OF_WEEK": lambda a: a[0].dt.day_of_week(),
    "COALESCE": lambda a: _coalesce(a),
    "IF": lambda a: a[0].if_else(a[1], a[2]),
    "IIF": lambda a: a[0].if_else(a[1], a[2]),
    "NULLIF": lambda a: (a[0] == a[1]).if_else(lit(None), a[0]),
    "HASH": lambda a: a[0].hash(),
    "MURMUR3_32": lambda a: a[0]._fn("murmur3_32"),
}


def _lit_val(e: Expression):
    from .expressions import Literal

    if not isinstance(e._node, Literal):
        raise ValueError("expected a literal argument")
    return e._node.value


def _chain_add(args: List[Expression]) -> Expression:
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


def _coalesce(args: List[Expression]) -> Expression:
    out = args[-1]
    for a in reversed(args[:-1]):
        out = a.fill_null(out)
    return out


def _apply_function(up: str, args: List[Expression], distinct: bool) -> Expression:
    if up in _AGG_FNS:
        if distinct:
            if up != "COUNT":
                raise ValueError(f"DISTINCT not supported for {up}")
            return args[0].count_distinct()
        if up == "SUM":
            return args[0].sum()
        if up in ("AVG", "MEAN"):
            return args[0].mean()
        if up == "MIN":
            return args[0].min()
        if up == "MAX":
            return args[0].max()
        if up == "COUNT":
            return args[0].count()
        if up in ("STDDEV", "STDDEV_SAMP"):
            return args[0].stddev()
        if up == "ANY_VALUE":
            return args[0].any_value()
        if up == "APPROX_COUNT_DISTINCT":
            return args[0].approx_count_distinct()
        if up in ("LIST", "ARRAY_AGG"):
            return args[0].agg_list()
    if up == "COUNT_DISTINCT":
        return args[0].count_distinct()
    if up in _SCALAR_FNS:
        return _SCALAR_FNS[up](args)
    raise ValueError(f"unknown SQL function {up!r}")


# ---------------------------------------------------------------------------
# Query planner
# ---------------------------------------------------------------------------

class _SelectItem:
    __slots__ = ("expr", "alias", "star")

    def __init__(self, expr=None, alias=None, star=False):
        self.expr = expr
        self.alias = alias
        self.star = star


def _is_agg_tree(node) -> bool:
    return node.is_aggregation()


class QueryPlanner(Parser):
    def parse_query(self):
        df = self._select_stmt()
        if self.peek().kind != "eof":
            raise ValueError(f"trailing tokens at {self.peek().value!r}")
        return df

    def _select_stmt(self):
        # parse every clause first, then plan (ORDER BY may reference columns
        # the projection drops, so sort placement depends on the whole query)
        self.expect_kw("SELECT")
        distinct = self.eat_kw("DISTINCT")
        items = self._select_list()
        if self.eat_kw("FROM"):
            df = self._from_clause()
        else:
            from .api import from_pydict

            df = from_pydict({"__no_from__": [0]})
        if self.eat_kw("WHERE"):
            df = df.where(self.parse_expr())
        group_exprs: Optional[List[Expression]] = None
        if self.eat_kw("GROUP"):
            self.expect_kw("BY")
            group_exprs = [self._group_item(items, df)]
            while self.eat_op(","):
                group_exprs.append(self._group_item(items, df))
        having = None
        if self.eat_kw("HAVING"):
            having = self.parse_expr()
        order_keys: List[Expression] = []
        desc: List[bool] = []
        nf: List[Optional[bool]] = []
        if self.eat_kw("ORDER"):
            self.expect_kw("BY")
            while True:
                order_keys.append(self._order_item(items))
                d = False
                if self.eat_kw("DESC"):
                    d = True
                else:
                    self.eat_kw("ASC")
                n = None
                if self.eat_kw("NULLS"):
                    if self.eat_kw("FIRST"):
                        n = True
                    else:
                        self.expect_kw("LAST")
                        n = False
                desc.append(d)
                nf.append(n)
                if not self.eat_op(","):
                    break
        limit = None
        if self.eat_kw("LIMIT"):
            t = self.next()
            if t.kind != "number":
                raise ValueError("LIMIT requires a number")
            limit = int(t.value)
        df = self._apply_projection(df, items, group_exprs, having,
                                    order_keys, desc, nf, distinct)
        if limit is not None:
            df = df.limit(limit)
        return df

    def _select_list(self) -> List[_SelectItem]:
        items = []
        while True:
            if self.eat_op("*"):
                items.append(_SelectItem(star=True))
            else:
                e = self.parse_expr()
                alias = None
                if self.eat_kw("AS"):
                    a = self.next()
                    if a.kind != "ident":
                        raise ValueError("expected alias after AS")
                    alias = a.value
                elif (self.peek().kind == "ident"
                      and self.peek().value.upper() not in _CLAUSE_KWS):
                    alias = self.next().value
                items.append(_SelectItem(expr=e, alias=alias))
            if not self.eat_op(","):
                return items

    def _from_clause(self):
        df, alias = self._table_factor()
        self._register_alias(alias, df)
        while True:
            if self.eat_kw("CROSS"):
                self.expect_kw("JOIN")
                how = "cross"
            elif self.eat_kw("INNER"):
                self.expect_kw("JOIN")
                how = "inner"
            elif self.at_kw("LEFT", "RIGHT", "FULL"):
                side = self.next().value.upper()
                self.eat_kw("OUTER")
                self.expect_kw("JOIN")
                how = {"LEFT": "left", "RIGHT": "right", "FULL": "outer"}[side]
            elif self.eat_kw("JOIN"):
                how = "inner"
            elif self.eat_op(","):
                how = "cross"
            else:
                return df
            right, ralias = self._table_factor()
            self._register_alias(ralias, right)
            pre_left = set(df.column_names)
            if how == "cross":
                df = df.join(right, how="cross")
                self._remap_right_alias(ralias, right, pre_left, {})
                continue
            if self.eat_kw("USING"):
                self.expect_op("(")
                cols = [self.next().value]
                while self.eat_op(","):
                    cols.append(self.next().value)
                self.expect_op(")")
                df = df.join(right, on=cols, how=how)
                self._remap_right_alias(ralias, right, pre_left,
                                        {c: c for c in cols})
                continue
            self.expect_kw("ON")
            left_on, right_on, extra = self._join_condition(df, right)
            if extra is not None and how != "inner":
                raise ValueError(
                    "non-equi conditions in an OUTER JOIN ON clause are not "
                    "supported (a post-join filter would change the join "
                    "semantics); move the condition to WHERE if inner "
                    "semantics are intended")
            df = df.join(right, left_on=left_on, right_on=right_on, how=how)
            self._remap_right_alias(
                ralias, right, pre_left,
                {r.name(): l.name() for l, r in zip(left_on, right_on)})
            if extra is not None:
                df = df.where(extra)

    def _table_factor(self):
        if self.eat_op("("):
            sub = self._select_stmt()
            self.expect_op(")")
            alias = self._opt_alias()
            return sub, alias
        t = self.next()
        if t.kind != "ident":
            raise ValueError(f"expected table name, got {t.value!r}")
        name = t.value.lower()
        if name not in self.catalog:
            raise ValueError(f"unknown table {t.value!r} "
                             f"(catalog: {sorted(self.catalog)})")
        alias = self._opt_alias() or name
        return self.catalog[name], alias

    def _opt_alias(self) -> Optional[str]:
        if self.eat_kw("AS"):
            return self.next().value
        if (self.peek().kind == "ident"
                and self.peek().value.upper() not in _CLAUSE_KWS):
            return self.next().value
        return None

    def _remap_right_alias(self, ralias: Optional[str], right, pre_left: set,
                           key_map: Dict[str, str]) -> None:
        """After a join, the right table's columns may have been renamed
        (key columns take the left name; duplicates get the 'right.' suffix) —
        keep the qualifier map pointing at the actual output columns."""
        if not ralias:
            return
        m: Dict[str, str] = {}
        for c in right.column_names:
            if c in key_map:
                m[c] = key_map[c]
            elif c in pre_left:
                m[c] = f"right.{c}"
            else:
                m[c] = c
        self._alias_cols[ralias.lower()] = m

    def _register_alias(self, alias: Optional[str], df) -> None:
        if alias:
            self.catalog.setdefault(alias.lower(), df)
            self._alias_cols.setdefault(
                alias.lower(), {c: c for c in df.column_names})

    def _join_condition(self, left_df, right_df):
        """Parse `a.x = b.y [AND ...]` into key lists; non-equi terms become a
        post-filter."""
        lcols = set(left_df.column_names)
        rcols = set(right_df.column_names)
        left_on: List[Expression] = []
        right_on: List[Expression] = []
        extra = None
        while True:
            e1 = self._predicate()
            matched = False
            from .expressions import BinaryOp, Column

            n = e1._node
            if isinstance(n, BinaryOp) and n.op == "==" \
                    and isinstance(n.left, Column) and isinstance(n.right, Column):
                a, b = n.left.cname, n.right.cname
                if a in lcols and b in rcols:
                    left_on.append(col(a))
                    right_on.append(col(b))
                    matched = True
                elif b in lcols and a in rcols:
                    left_on.append(col(b))
                    right_on.append(col(a))
                    matched = True
            if not matched:
                extra = e1 if extra is None else (extra & e1)
            if not self.eat_kw("AND"):
                break
        if not left_on:
            raise ValueError("JOIN ON requires at least one equi-condition")
        return left_on, right_on, extra

    def _group_item(self, items: List[_SelectItem], df) -> Expression:
        t = self.peek()
        if t.kind == "number":
            self.next()
            idx = int(t.value) - 1
            if idx < 0 or idx >= len(items) or items[idx].star:
                raise ValueError(f"GROUP BY position {t.value} out of range")
            return items[idx].expr
        e = self.parse_expr()
        from .expressions import Column

        if isinstance(e._node, Column) and e._node.cname not in df.column_names:
            # not an input column: try a select-list alias (input wins, per SQL)
            for it in items:
                if it.alias == e._node.cname and it.expr is not None:
                    return it.expr
        return e

    def _order_item(self, items: List[_SelectItem]) -> Expression:
        t = self.peek()
        if t.kind == "number":
            self.next()
            idx = int(t.value) - 1
            if idx < 0 or idx >= len(items) or items[idx].star:
                raise ValueError(f"ORDER BY position {t.value} out of range")
            it = items[idx]
            return col(it.alias) if it.alias else it.expr
        return self.parse_expr()

    def _resolve_qualified(self, node):
        """Resolve deferred alias.column refs (select list parses before FROM)."""
        from .expressions import Column

        if isinstance(node, Column) and "\x00" in node.cname:
            q, c = node.cname.split("\x00", 1)
            m = self._alias_cols.get(q.lower())
            if m is None:
                raise ValueError(f"unknown table alias {q!r}")
            if c not in m:
                raise ValueError(f"column {c!r} not found in table {q!r}")
            return col(m[c])._node
        kids = node.children()
        if not kids:
            return node
        return node.with_children([self._resolve_qualified(c) for c in kids])

    def _apply_projection(self, df, items: List[_SelectItem],
                          group_exprs: Optional[List[Expression]],
                          having: Optional[Expression],
                          order_keys: List[Expression],
                          desc: List[bool], nf: List[Optional[bool]],
                          distinct: bool = False):
        # expand stars; bind COUNT(*)'s '*' placeholder to the first column;
        # resolve deferred alias.column refs now that FROM is planned
        first_col = df.column_names[0]
        exprs: List[Expression] = []
        alias_map: Dict[str, Expression] = {}
        for it in items:
            if it.star:
                exprs.extend(col(n) for n in df.column_names)
            else:
                e = Expression(self._resolve_qualified(
                    _resolve_star(it.expr._node, first_col)))
                if it.alias:
                    alias_map[it.alias] = e
                    e = e.alias(it.alias)
                exprs.append(e)
        if having is not None:
            having = Expression(self._resolve_qualified(
                _resolve_star(having._node, first_col)))
        order_keys = [Expression(self._resolve_qualified(
            _resolve_star(k._node, first_col))) for k in order_keys]
        nulls_first = nf if any(x is not None for x in nf) else None
        out_names = [e.name() for e in exprs]
        has_agg = any(_is_agg_tree(e._node) for e in exprs) or any(
            _is_agg_tree(k._node) for k in order_keys)
        if group_exprs is None and not has_agg:
            if having is not None:
                raise ValueError("HAVING requires GROUP BY or aggregates")
            if distinct:
                # DISTINCT dedupes the projected rows (hash-shuffled, so the
                # sort must come after); ORDER BY may only use selected columns
                out = df.select(*exprs).distinct()
                if order_keys:
                    keys = [Expression(_subst_aliases(k._node, alias_map, []))
                            for k in order_keys]
                    for k in keys:
                        if not _refs_only_keys(k._node, out_names):
                            raise ValueError(
                                "ORDER BY with DISTINCT must reference "
                                "selected columns")
                    out = out.sort(keys, desc=desc, nulls_first=nulls_first)
                return out
            if order_keys:
                # sort BEFORE projecting: ORDER BY may reference input columns
                # the projection drops; select aliases resolve to their exprs
                keys = [Expression(_subst_aliases(k._node, alias_map, df.column_names))
                        for k in order_keys]
                df = df.sort(keys, desc=desc, nulls_first=nulls_first)
            return df.select(*exprs)
        # aggregate path: pull every AggExpr subtree out as a synthetic agg
        # column, aggregate once, then compute finals/HAVING/ORDER BY as plain
        # arithmetic over synthetic columns (compound items like SUM(x)*2 work).
        keys = group_exprs or []
        key_names = [k.name() for k in keys]
        key_by_key = {k._node._key(): k.name() for k in keys}
        agg_map: Dict = {}
        agg_list: List[Expression] = []

        def rewrite(e: Expression) -> Expression:
            return Expression(_pull_aggs(e._node, key_by_key, agg_map, agg_list))

        finals = [rewrite(e).alias(e.name()) for e in exprs]
        having_final = rewrite(having) if having is not None else None
        order_final = []
        for k in order_keys:
            n = _subst_aliases(k._node, alias_map, [])
            order_final.append(rewrite(Expression(n)))
        for e, f in zip(exprs, finals):
            if not _is_agg_tree(e._node):
                # non-aggregate item must be (derived from) a group key
                from .expressions import Alias

                n = f._node
                while isinstance(n, Alias):
                    n = n.child
                if not _refs_only_keys(n, key_names):
                    raise ValueError(
                        f"non-aggregate select item {e.name()!r} must appear in GROUP BY")
        if keys:
            gdf = df.groupby(*keys).agg(*agg_list) if agg_list else df.distinct(*keys)
        else:
            gdf = df.agg(*agg_list)
        if having_final is not None:
            gdf = gdf.where(having_final)
        if distinct:
            out = gdf.select(*finals).distinct()
            if order_final:
                for k in order_final:
                    if not _refs_only_keys(k._node, out_names):
                        raise ValueError("ORDER BY with DISTINCT must "
                                         "reference selected columns")
                out = out.sort(order_final, desc=desc, nulls_first=nulls_first)
            return out
        if order_final:
            gdf = gdf.sort(order_final, desc=desc, nulls_first=nulls_first)
        return gdf.select(*finals)


def _pull_aggs(node, key_by_key: Dict, agg_map: Dict, agg_list: List[Expression]):
    """Replace group-key subtrees and AggExpr subtrees with column refs,
    recording synthetic agg outputs in agg_list."""
    from .expressions import AggExpr, Expression as E

    if node._key() in key_by_key:
        return col(key_by_key[node._key()])._node
    if isinstance(node, AggExpr):
        k = node._key()
        if k not in agg_map:
            name = f"__agg_{len(agg_map)}"
            agg_map[k] = name
            agg_list.append(E(node).alias(name))
        return col(agg_map[k])._node
    return node.with_children([_pull_aggs(c, key_by_key, agg_map, agg_list)
                               for c in node.children()])


def _subst_aliases(node, alias_map: Dict[str, Expression], input_cols):
    """Resolve a bare column ref to its select-alias definition (input columns
    take precedence when the name exists in the input schema)."""
    from .expressions import Column

    if isinstance(node, Column):
        if node.cname in alias_map and node.cname not in input_cols:
            return alias_map[node.cname]._node
        return node
    kids = node.children()
    if not kids:
        return node
    return node.with_children([_subst_aliases(c, alias_map, input_cols)
                               for c in kids])


def _resolve_star(node, first_col: str):
    from .expressions import Column

    if isinstance(node, Column) and node.cname == "*":
        return col(first_col)._node
    kids = node.children()
    if not kids:
        return node
    return node.with_children([_resolve_star(c, first_col) for c in kids])


def _refs_only_keys(node, key_names: List[str]) -> bool:
    from .expressions import Column

    if isinstance(node, Column):
        return node.cname in key_names
    kids = node.children()
    if not kids:
        return True
    return all(_refs_only_keys(c, key_names) for c in kids)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def sql(query: str, **catalog):
    """Plan a SQL query over registered DataFrames: sql("SELECT ...", tbl=df)."""
    if not catalog:
        raise ValueError("register at least one table: sql(query, name=df)")
    return QueryPlanner(tokenize(query), catalog).parse_query()


def sql_expr(text: str) -> Expression:
    """Parse a single SQL expression to an Expression."""
    p = Parser(tokenize(text), {})
    e = p.parse_expr()
    if p.peek().kind != "eof":
        raise ValueError(f"trailing tokens at {p.peek().value!r}")
    return e
