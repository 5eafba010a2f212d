"""Canonical plan fingerprints: structure and schema, literals masked out
(the port's copy of daft_tpu/adapt/fingerprint.py).

Two queries that differ only in literal values (``WHERE x > 5`` against
``WHERE x > 9``) share a canonical fingerprint, so the plan cache and the
feedback history treat them as one shape; the plan cache's binding key
(``runners.plan_cache_key``) keeps the literals.

Two scopes:

- ``identity`` (``canonical_fingerprint``): stable across processes. An
  in-memory source contributes only its schema and partition count (a
  process-local token would break that).
- ``site`` (``canonical_site_fp``): the process-local key the feedback
  history observes plan subtrees under. An in-memory source adds its
  data-identity token, so that observations of one frame never seed the
  decisions of another frame that merely shares its schema.

The serialization is deterministic: no ``id()``, no ``hash()``, default
object reprs scrubbed of their addresses, callables by ``__qualname__``.
A scan contributes each task's path, format, options, row groups, schema
and pushdowns (the filter's literals masked), not its file's mtime or size:
a rewritten file keeps its shape, and exactness is the binding key's job.
"""

from __future__ import annotations

import hashlib
import re
from typing import Any, List, Optional

__all__ = ["canonical_fingerprint", "canonical_site_fp", "canonical_expr_key",
           "literal_values"]

_ADDR_RE = re.compile(r"0x[0-9a-fA-F]+")

# attributes that are derived or cache state, never identity
_SKIP_ATTRS = ("schema", "_cache_token")


def _scrub(s: str) -> str:
    """Strip memory addresses from default reprs: identity must not depend
    on the process."""
    return _ADDR_RE.sub("0x", s)


def _scalar(v: Any) -> str:
    if callable(v):
        return f"fn:{getattr(v, '__qualname__', getattr(v, '__name__', 'fn'))}"
    return _scrub(repr(v))


def _expr_canon(node, out: List[str], params: Optional[List[Any]]) -> None:
    from ..expressions import Expression, ExprNode, Literal

    if isinstance(node, Expression):
        node = node._node
    if isinstance(node, Literal):
        # the value is masked; its dtype and weakness stay (a weak lit(2)
        # and a strong lit(2, int64) resolve differently in binary contexts)
        if params is not None:
            params.append(node.value)
        out.append(f"lit?:{node.dtype!r}:w{int(node.weak)}")
        return
    out.append(type(node).__name__)
    kids = node.children()
    kid_ids = {id(k) for k in kids}
    for k in sorted(vars(node)):
        if k in _SKIP_ATTRS:
            continue
        v = getattr(node, k)
        if isinstance(v, ExprNode):
            if id(v) in kid_ids:
                continue  # serialized through children() below
            out.append(f"{k}=(")
            _expr_canon(v, out, params)
            out.append(")")
        elif isinstance(v, (list, tuple)) and any(
                isinstance(e, (ExprNode, Expression)) for e in v):
            if all(id(getattr(e, "_node", e)) in kid_ids for e in v):
                continue
            out.append(f"{k}=[")
            for e in v:
                _expr_canon(e, out, params)
            out.append("]")
        else:
            out.append(f"{k}={_scalar(v)}")
    out.append("(")
    for c in kids:
        _expr_canon(c, out, params)
    out.append(")")


def canonical_expr_key(expr) -> str:
    """Canonical (literal-masked) serialization of one expression."""
    out: List[str] = []
    _expr_canon(expr, out, None)
    return "|".join(out)


def _schema_canon(schema) -> str:
    return ",".join(f"{f.name}:{f.dtype!r}" for f in schema)


def _scan_task_canon(t, out: List[str], params) -> None:
    """The shape of one scan task: path, format, options and pushdowns,
    not its file's mtime or size."""
    out.append(f"scan:{getattr(t, 'path', '?')}|{getattr(t, 'format', '?')}")
    # a merged task folds in its children
    for c in getattr(t, "children", ()) or ():
        _scan_task_canon(c, out, params)
    opts = getattr(t, "storage_options", None)
    if opts:
        out.append(";".join(f"{k}={_scalar(v)}" for k, v in sorted(
            opts.items(), key=lambda kv: kv[0])))
    out.append(f"rg={getattr(t, 'row_group_ids', None)!r}"
               f"|pv={_scrub(repr(getattr(t, 'partition_values', None)))}")
    sch = getattr(t, "schema", None)
    if sch is not None:
        out.append(_schema_canon(sch))
    pd = getattr(t, "pushdowns", None)
    if pd is not None:
        out.append(f"cols={getattr(pd, 'columns', None)!r}"
                   f"|limit={getattr(pd, 'limit', None)!r}")
        filt = getattr(pd, "filters", None)
        if filt is not None:
            out.append("filt=(")
            _expr_canon(filt, out, params)
            out.append(")")


def _plan_canon(p, out: List[str], params, scope: str) -> None:
    from ..expressions import Expression
    from ..logical import InMemorySource, ScanSource

    out.append(type(p).__name__)
    if isinstance(p, InMemorySource):
        out.append(f"mem[{len(p.partitions)}]:{_schema_canon(p.schema)}")
        if scope == "site":
            # data identity: observations never cross frames that merely
            # share a schema (process-local by design)
            out.append(f"tok={p._cache_token}")
        return
    if isinstance(p, ScanSource):
        for t in p.tasks:
            _scan_task_canon(t, out, params)
        return
    kids = p.children()
    kid_ids = {id(k) for k in kids}
    for k in sorted(vars(p)):
        if k in _SKIP_ATTRS or k.startswith("_fdo"):
            continue
        v = getattr(p, k)
        if id(v) in kid_ids:
            continue
        if isinstance(v, Expression):
            out.append(f"{k}=(")
            _expr_canon(v, out, params)
            out.append(")")
        elif isinstance(v, (list, tuple)) and any(isinstance(e, Expression) for e in v):
            out.append(f"{k}=[")
            for e in v:
                _expr_canon(e, out, params)
            out.append("]")
        else:
            out.append(f"{k}={_scalar(v)}")
    out.append("(")
    for c in kids:
        _plan_canon(c, out, params, scope)
    out.append(")")


def _digest(parts: List[str]) -> str:
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


def canonical_fingerprint(plan) -> str:
    """Process-stable shape fingerprint of a logical plan, literals masked."""
    out: List[str] = []
    _plan_canon(plan, out, None, "identity")
    return _digest(out)


def canonical_site_fp(plan) -> str:
    """Process-local observation key of one plan subtree: its canonical
    shape plus its in-memory sources' data-identity tokens."""
    out: List[str] = []
    _plan_canon(plan, out, None, "site")
    return _digest(out)


def literal_values(plan) -> List[Any]:
    """The literal values a canonical fingerprint masked, in the walk's
    order (diagnostics; the plan cache keys bindings by the exact
    structural key instead)."""
    params: List[Any] = []
    out: List[str] = []
    _plan_canon(plan, out, params, "identity")
    return params
