"""QueryProfile: the machine-readable artifact built from a Profiler (the
port's copy of daft_tpu/profile/export.py).

One profile is one executed query: the whole span tree, the typed events,
per-op rollups (wall, self, io_wait, queue_wait, device_dispatch and
background time, rows, partitions), the critical path, the RuntimeStats
counters and the memory ledger's snapshot, in a stable JSON schema
(``SCHEMA_VERSION``, the reference's: its ``validate_profile`` accepts the
port's profiles).

Rollup semantics (kept deliberately reconcilable with RuntimeStats):

- ``wall_ns``  sum of the op's span durations (inclusive)
- ``self_ns``  wall minus SAME-THREAD child op spans, the quantity
  ``RuntimeStats.op_wall_ns`` accumulates in the sequential executor, so the
  two agree by construction (within 5 %)
- ``io_wait_ns``/``queue_wait_ns``  phase buckets recorded where the wait
  happened, aggregated to the nearest enclosing op
- ``device_ns``  the ``device_dispatch`` phases under the op: host time
  spent staging and launching on the card (spans.py says what it covers)
- ``background``  bg-span time (async spill writes, prefetch fetches,
  readahead loads) attributed to the op that caused the work through
  captured span tokens; a bg span with no op ancestor counts into
  ``orphan_spans`` (the cross-thread tests hold it to 0)
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from .spans import Profiler, Span

__all__ = ["SCHEMA_VERSION", "QueryProfile", "build_profile",
           "validate_profile"]

SCHEMA_VERSION = 1


def _nearest_op_ancestor(sp: Span, by_id: Dict[int, Span],
                         same_thread: bool = False) -> Optional[Span]:
    seen = set()
    cur = by_id.get(sp.parent) if sp.parent is not None else None
    while cur is not None and cur.sid not in seen:
        seen.add(cur.sid)
        if cur.kind == "op" and (not same_thread or cur.thread == sp.thread):
            return cur
        cur = by_id.get(cur.parent) if cur.parent is not None else None
    return None


class QueryProfile:
    """Built once per profiled query; serializes to the stable JSON schema
    and renders the explain_analyze timeline section."""

    def __init__(self, data: dict, spans: List[Span]):
        self._data = data
        self._spans = spans

    # ----------------------------------------------------------- access
    @property
    def query_id(self) -> str:
        return self._data["query_id"]

    @property
    def wall_ns(self) -> int:
        return self._data["wall_ns"]

    @property
    def ops(self) -> Dict[str, dict]:
        return self._data["ops"]

    @property
    def events(self) -> List[dict]:
        return self._data["events"]

    @property
    def counters(self) -> Dict[str, int]:
        return self._data["counters"]

    @property
    def critical_path(self) -> List[dict]:
        return self._data["critical_path"]

    @property
    def critical_path_op(self) -> Optional[str]:
        return self._data["critical_path_op"]

    @property
    def orphan_spans(self) -> int:
        return self._data["orphan_spans"]

    def spans(self) -> List[Span]:
        return list(self._spans)

    # ---------------------------------------------------------- exports
    def to_dict(self) -> dict:
        return dict(self._data)

    def to_json(self, path: Optional[str] = None, indent: int = 1) -> str:
        text = json.dumps(self._data, indent=indent, sort_keys=True,
                          default=str)
        if path is not None:
            with open(path, "w", encoding="utf-8") as f:
                f.write(text)
        return text

    def render_timeline(self) -> str:
        """Per-op timeline + critical path (the explain_analyze section)."""
        ops = self.ops
        if not ops:
            return "== Profile ==\n(no spans recorded)"
        names = sorted(ops, key=lambda k: -ops[k]["self_ns"])
        w = max([len(n) for n in names] + [8])
        total_self = sum(o["self_ns"] for o in ops.values()) or 1
        lines = [f"== Profile ({self.query_id}, wall "
                 f"{self.wall_ns / 1e6:.1f} ms) ==",
                 f"{'operator':<{w}}  {'wall ms':>9}  {'self ms':>9}"
                 f"  {'io ms':>7}  {'queue ms':>8}  {'bg ms':>7}"
                 f"  {'parts':>5}  self%"]
        for n in names:
            o = ops[n]
            bg = sum(o.get("background", {}).values())
            bar = "#" * max(1, round(14 * o["self_ns"] / total_self)) \
                if o["self_ns"] else ""
            lines.append(
                f"{n:<{w}}  {o['wall_ns'] / 1e6:>9.2f}"
                f"  {o['self_ns'] / 1e6:>9.2f}"
                f"  {o['io_wait_ns'] / 1e6:>7.1f}"
                f"  {o['queue_wait_ns'] / 1e6:>8.1f}"
                f"  {bg / 1e6:>7.1f}  {o['partitions']:>5}"
                f"  {100 * o['self_ns'] / total_self:>4.0f}% {bar}")
        cp = self.critical_path
        if cp:
            path = " -> ".join(step["op"] for step in cp)
            cp_ns = sum(step["self_ns"] for step in cp)
            lines.append("")
            lines.append(f"critical path: {path} "
                         f"({cp_ns / 1e6:.1f} ms self, "
                         f"{100 * cp_ns / total_self:.0f}% of op self time)")
        n_ev = len(self.events)
        if n_ev:
            kinds: Dict[str, int] = {}
            for ev in self.events:
                kinds[ev["kind"]] = kinds.get(ev["kind"], 0) + 1
            lines.append("events: " + ", ".join(
                f"{k}={v}" for k, v in sorted(kinds.items())))
        if self.orphan_spans:
            lines.append(f"WARNING: {self.orphan_spans} orphan background "
                         "span(s) (unattributed work)")
        return "\n".join(lines)


def build_profile(profiler: Profiler, stats=None) -> QueryProfile:
    """Roll a finished Profiler (plus the query's RuntimeStats) up into a
    QueryProfile."""
    if profiler.t_end_ns is None:  # execute_plan normally finished it;
        profiler.finish()          # an already-stamped wall stays as it is
    spans = profiler.spans_snapshot()
    by_id = {s.sid: s for s in spans}

    # same-thread child-op durations (for self time, mirroring the
    # executor's thread-local stack accounting)
    child_op_ns: Dict[int, int] = {}
    for s in spans:
        if s.kind != "op":
            continue
        anc = _nearest_op_ancestor(s, by_id, same_thread=True)
        if anc is not None:
            child_op_ns[anc.sid] = child_op_ns.get(anc.sid, 0) + s.dur_ns

    ops: Dict[str, dict] = {}
    op_edges: Dict[str, Dict[str, int]] = {}  # parent op -> child op -> ns
    root_ops: Dict[str, int] = {}
    orphans = 0

    def op_entry(name: str) -> dict:
        o = ops.get(name)
        if o is None:
            o = ops[name] = {"wall_ns": 0, "self_ns": 0, "io_wait_ns": 0,
                             "queue_wait_ns": 0, "device_ns": 0, "rows": 0,
                             "partitions": 0, "background": {}}
        return o

    for s in spans:
        ph = s.phases or {}
        if s.kind == "op":
            name = s.op or s.name
            o = op_entry(name)
            o["wall_ns"] += s.dur_ns
            o["self_ns"] += max(s.dur_ns - child_op_ns.get(s.sid, 0), 0)
            o["io_wait_ns"] += ph.get("io_wait", 0)
            o["queue_wait_ns"] += ph.get("queue_wait", 0)
            o["device_ns"] += ph.get("device_dispatch", 0)
            o["partitions"] += 1
            if s.attrs:
                o["rows"] += s.attrs.get("rows", 0) or 0
            anc = _nearest_op_ancestor(s, by_id)
            if anc is not None:
                pname = anc.op or anc.name
                if pname != name:
                    edges = op_edges.setdefault(pname, {})
                    edges[name] = edges.get(name, 0) + s.dur_ns
            else:
                root_ops[name] = root_ops.get(name, 0) + s.dur_ns
        else:
            anc = _nearest_op_ancestor(s, by_id)
            if anc is None:
                if s.kind == "bg":
                    orphans += 1
                continue
            o = op_entry(anc.op or anc.name)
            bg = o["background"]
            bg[s.name] = bg.get(s.name, 0) + s.dur_ns
            # waits recorded inside phase and bg sub-spans (a device
            # dispatch inside fuse.segment, a spill's io_wait) belong to the
            # enclosing op's timeline: without this the per-op buckets
            # undercount the RuntimeStats totals
            o["io_wait_ns"] += ph.get("io_wait", 0)
            o["queue_wait_ns"] += ph.get("queue_wait", 0)
            o["device_ns"] += ph.get("device_dispatch", 0)

    # critical path: from the hottest root op, greedily follow the child op
    # with the largest caused wall time
    critical: List[dict] = []
    if root_ops:
        cur = max(root_ops, key=lambda k: root_ops[k])
        seen = set()
        while cur is not None and cur not in seen:
            seen.add(cur)
            critical.append({"op": cur, "self_ns": ops[cur]["self_ns"],
                             "wall_ns": ops[cur]["wall_ns"]})
            nxt = op_edges.get(cur)
            cur = max(nxt, key=lambda k: nxt[k]) if nxt else None
    cp_op = (max(ops, key=lambda k: ops[k]["self_ns"]) if ops else None)

    counters: Dict[str, int] = {}
    op_rows: Dict[str, int] = {}
    if stats is not None:
        snap = stats.snapshot()
        counters = snap["counters"]
        op_rows = snap["op_rows"]
    try:
        from ..spill import MEMORY_LEDGER

        ledger = MEMORY_LEDGER.snapshot()
    except Exception:
        ledger = {}

    data = {
        "schema_version": SCHEMA_VERSION,
        "query_id": profiler.query_id,
        "started_unix": profiler.started_unix,
        "wall_ns": profiler.wall_ns,
        "ops": ops,
        "spans": [s.as_dict() for s in spans],
        "events": profiler.events_snapshot(),
        "critical_path": critical,
        "critical_path_op": cp_op,
        "counters": counters,
        "op_rows": op_rows,
        "unattributed_phases": profiler.unattributed_phases(),
        "ledger": ledger,
        "orphan_spans": orphans,
        "dropped_spans": profiler.dropped_spans,
        "dropped_events": profiler.dropped_events,
    }
    return QueryProfile(data, spans)


# required top-level keys -> type checks for validate_profile
_TOP_KEYS = {
    "schema_version": int,
    "query_id": str,
    "started_unix": (int, float),
    "wall_ns": int,
    "ops": dict,
    "spans": list,
    "events": list,
    "critical_path": list,
    "counters": dict,
    "orphan_spans": int,
    "dropped_spans": int,
    "dropped_events": int,
}
_OP_KEYS = ("wall_ns", "self_ns", "io_wait_ns", "queue_wait_ns",
            "partitions")
_SPAN_KEYS = {"id": int, "name": str, "kind": str, "thread": str,
              "t0_ns": int, "dur_ns": int}


def validate_profile(d: dict) -> List[str]:
    """Schema check for a QueryProfile dict (as loaded from JSON). Returns
    a list of violation strings; empty means valid."""
    errs: List[str] = []
    if not isinstance(d, dict):
        return ["profile is not an object"]
    for key, typ in _TOP_KEYS.items():
        if key not in d:
            errs.append(f"missing key {key!r}")
        elif not isinstance(d[key], typ):
            errs.append(f"{key!r} has type {type(d[key]).__name__}")
    if errs:
        return errs
    if d["schema_version"] != SCHEMA_VERSION:
        errs.append(f"schema_version {d['schema_version']} != "
                    f"{SCHEMA_VERSION}")
    for name, o in d["ops"].items():
        for k in _OP_KEYS:
            if not isinstance(o.get(k), int):
                errs.append(f"ops[{name!r}].{k} missing or non-int")
    ids = set()
    for i, s in enumerate(d["spans"]):
        for k, typ in _SPAN_KEYS.items():
            if not isinstance(s.get(k), typ):
                errs.append(f"spans[{i}].{k} missing or mistyped")
                break
        else:
            ids.add(s["id"])
    if not d["dropped_spans"]:
        # with drops, a surviving child may reference an evicted parent
        for i, s in enumerate(d["spans"]):
            p = s.get("parent")
            if p is not None and p not in ids:
                errs.append(f"spans[{i}] parent {p} not in profile")
    for i, ev in enumerate(d["events"]):
        if not isinstance(ev.get("t_ns"), int) or \
                not isinstance(ev.get("kind"), str):
            errs.append(f"events[{i}] missing t_ns/kind")
    cp = d["critical_path"]
    for i, step in enumerate(cp):
        if step.get("op") not in d["ops"]:
            errs.append(f"critical_path[{i}] names unknown op")
    return errs
