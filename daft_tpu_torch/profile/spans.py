"""Span-tree core of the structured query profiler (the port's copy of
daft_tpu/profile/spans.py).

A :class:`Profiler` records one query. Every physical-op partition opens a
*span* (op name, partition index, parent span), and background work (an
async spill write, a scan prefetch, an unspill readahead, a batch of an
actor pool) opens spans under an explicitly *captured* parent token, so
work that hops threads stays attributed to the op that caused it instead
of becoming an orphan interval.

Span kinds:

- ``op``     one partition's worth of operator work (``execution._traced``
             opens these; their durations reconcile with RuntimeStats)
- ``phase``  a blocking sub-interval inside an op on the same thread (the
             shuffle's fan-out, a join's build, a sort's partition, ...)
- ``bg``     background work on another thread (``spill.write`` on the
             writer thread, ``prefetch.fetch`` on a pool worker,
             ``spill.read`` on the readahead pool), parented through
             ``capture()``/``activate()``

Besides spans the profiler records *typed events* (breaker transitions,
injected faults, throttles, fusion outcomes) on the same clock
(``time.perf_counter_ns``), and *phases*: named nanosecond buckets
(io_wait, queue_wait, device_dispatch) added to the innermost open span of
the calling thread.

``device_dispatch`` on the card. A CUDA launch returns as soon as the
kernel is queued, as a jax dispatch does on a TPU. The phase covers what
the host spends in a device attempt: the fault check, staging the columns
(the host-to-card copies), building or finding the program and queueing
its kernels (K1, K2, the scatter kernel). A synchronous attempt (a sort, a
single projection) includes the wait for its result. The kernels of an
asynchronous launch (an aggregate's dispatch) run after the phase has
closed: their time lands where the resolver fetches the result to the
host, inside the op span that pulls it. No span or phase synchronizes the
card: that would serialize the pipeline being observed.

Cost discipline: every RuntimeStats carries the DISARMED singleton by
default. Its ``armed`` flag is False and every method is a constant-time
no-op returning shared singletons, so the hot path allocates nothing with
profiling off (guard-tested), and hot callers gate on ``prof.armed`` so
not even a kwargs dict is built.

Buffers are bounded: past ``max_spans``/``max_events`` new entries are
dropped and counted (``dropped_spans``/``dropped_events``): a pathological
query degrades its own profile, never the process.

``Profiler.splice`` adopts a worker process's recorded subtree (the
telemetry merge of the distributed runner, obs/cluster.py): the worker's
spans land under the driver's ``dist.remote`` span on a ``worker-N`` lane.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["Span", "Profiler", "DISARMED"]

# default buffer caps: ~100k spans is minutes of SF10 execution; a span is
# a few hundred bytes, so the worst-case buffer stays tens of MB
DEFAULT_MAX_SPANS = 100_000
DEFAULT_MAX_EVENTS = 20_000


class Span:
    """One recorded interval. ``dur_ns`` is set at close; ``phases`` maps a
    phase name to its accumulated ns; ``attrs`` carries small scalars
    (rows, ...)."""

    __slots__ = ("sid", "parent", "name", "op", "part", "kind", "thread",
                 "t0_ns", "dur_ns", "phases", "attrs")

    def __init__(self, sid: int, parent: Optional[int], name: str,
                 op: Optional[str], part: Optional[int], kind: str,
                 thread: str, t0_ns: int):
        self.sid = sid
        self.parent = parent
        self.name = name
        self.op = op
        self.part = part
        self.kind = kind
        self.thread = thread
        self.t0_ns = t0_ns
        self.dur_ns = 0
        self.phases: Optional[Dict[str, int]] = None
        self.attrs: Optional[Dict[str, Any]] = None

    def add_phase(self, key: str, ns: int) -> None:
        ph = self.phases
        if ph is None:
            ph = self.phases = {}
        ph[key] = ph.get(key, 0) + ns

    def set_attr(self, key: str, value: Any) -> None:
        at = self.attrs
        if at is None:
            at = self.attrs = {}
        at[key] = value

    def as_dict(self) -> dict:
        d = {"id": self.sid, "parent": self.parent, "name": self.name,
             "kind": self.kind, "thread": self.thread,
             "t0_ns": self.t0_ns, "dur_ns": self.dur_ns}
        if self.op is not None:
            d["op"] = self.op
        if self.part is not None:
            d["part"] = self.part
        if self.phases:
            d["phases"] = dict(self.phases)
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d

    def __repr__(self) -> str:
        return (f"Span#{self.sid}({self.name!r}, kind={self.kind}, "
                f"dur={self.dur_ns / 1e6:.2f}ms, parent={self.parent})")


class _NoopCtx:
    """Shared do-nothing context manager for the disarmed fast path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoopCtx()


class _SpanCtx:
    """``with prof.span(...)`` handle (armed path)."""

    __slots__ = ("_prof", "_name", "_op", "_part", "_kind", "_attrs", "sp")

    def __init__(self, prof, name, op, part, kind, attrs):
        self._prof = prof
        self._name = name
        self._op = op
        self._part = part
        self._kind = kind
        self._attrs = attrs
        self.sp = None

    def __enter__(self) -> Span:
        self.sp = self._prof.begin(self._name, op=self._op, part=self._part,
                                   kind=self._kind)
        if self._attrs:
            self.sp.attrs = dict(self._attrs)
        return self.sp

    def __exit__(self, *exc):
        self._prof.end(self.sp)
        return False


class _Activation:
    """``with prof.activate(token)``: spans opened on this thread while the
    activation is live parent to ``token`` (the captured span id of the
    thread that caused this work)."""

    __slots__ = ("_prof", "_token", "_prev")

    def __init__(self, prof, token):
        self._prof = prof
        self._token = token
        self._prev = None

    def __enter__(self):
        tl = self._prof._tl
        self._prev = getattr(tl, "base", None)
        tl.base = self._token
        return self

    def __exit__(self, *exc):
        self._prof._tl.base = self._prev
        return False


class Profiler:
    """Per-query span and event recorder. Construct armed; the module-level
    ``DISARMED`` singleton is the always-off default every RuntimeStats
    starts with."""

    def __init__(self, query_id: Optional[str] = None, armed: bool = True,
                 max_spans: int = DEFAULT_MAX_SPANS,
                 max_events: int = DEFAULT_MAX_EVENTS):
        self.armed = armed
        self.query_id = query_id or f"q-{id(self):x}"
        self.max_spans = max_spans
        self.max_events = max_events
        self.t_start_ns = time.perf_counter_ns()
        self.t_end_ns: Optional[int] = None
        self.started_unix = time.time()
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._events: List[dict] = []
        self.dropped_spans = 0
        self.dropped_events = 0
        # phases recorded while NO span was open on the calling thread (a
        # late read after the stream closed): kept so the profile's totals
        # still reconcile with the RuntimeStats counters
        self._unattributed: Dict[str, int] = {}
        self._seq = itertools.count(1)
        self._tl = threading.local()
        # what the chrome renderer has consumed: an AQE query finishes one
        # execute_plan per stage, and each stage renders only ITS spans and
        # events, never an earlier stage's again
        self._chrome_span_mark = 0
        self._chrome_event_mark = 0

    # ------------------------------------------------------------- spans
    def _stack(self) -> List[Span]:
        st = getattr(self._tl, "stack", None)
        if st is None:
            st = self._tl.stack = []
        return st

    def begin(self, name: str, op: Optional[str] = None,
              part: Optional[int] = None, kind: str = "op") -> Optional[Span]:
        """Open a span on this thread (explicit begin/end for executor loops
        where a ``with`` block cannot wrap the measured region)."""
        if not self.armed:
            return None
        st = self._stack()
        if st:
            parent = st[-1].sid
        else:
            parent = getattr(self._tl, "base", None)
        sp = Span(next(self._seq), parent, name, op, part, kind,
                  threading.current_thread().name, time.perf_counter_ns())
        st.append(sp)
        return sp

    def end(self, sp: Optional[Span]) -> None:
        if sp is None:
            return
        sp.dur_ns = time.perf_counter_ns() - sp.t0_ns
        st = self._stack()
        # a span leaked across a generator suspension leaves the stack out
        # of order: search instead of asserting (profiles degrade, queries
        # never fail)
        if st and st[-1] is sp:
            st.pop()
        elif sp in st:
            st.remove(sp)
        with self._lock:
            if len(self._spans) >= self.max_spans:
                self.dropped_spans += 1
            else:
                self._spans.append(sp)

    def cancel(self, sp: Optional[Span]) -> None:
        """Close a begun span WITHOUT recording it (the executor's final empty
        pull, a StopIteration, is not a partition)."""
        if sp is None:
            return
        st = self._stack()
        if st and st[-1] is sp:
            st.pop()
        elif sp in st:
            st.remove(sp)

    def span(self, name: str, op: Optional[str] = None,
             part: Optional[int] = None, kind: str = "phase", **attrs):
        """Context-manager form; disarmed it returns a shared no-op."""
        if not self.armed:
            return _NOOP
        return _SpanCtx(self, name, op, part, kind, attrs)

    def current(self) -> Optional[Span]:
        """This thread's innermost open span (None when idle or disarmed)."""
        st = getattr(self._tl, "stack", None)
        return st[-1] if st else None

    # ------------------------------------------ cross-thread propagation
    def capture(self) -> Optional[int]:
        """A token for the innermost open span of THIS thread (or the
        thread's own activation base). Hand it to background work so that
        its spans attribute to the op that caused them."""
        if not self.armed:
            return None
        st = getattr(self._tl, "stack", None)
        if st:
            return st[-1].sid
        return getattr(self._tl, "base", None)

    def activate(self, token: Optional[int]):
        """Adopt a captured token as this thread's parent context."""
        if not self.armed:
            return _NOOP
        return _Activation(self, token)

    # ------------------------------------------------------------ phases
    def phase(self, key: str, ns: int) -> None:
        """Add ``ns`` to the named phase bucket of this thread's innermost
        open span (io_wait, queue_wait, device_dispatch, ...)."""
        if not self.armed:
            return
        st = getattr(self._tl, "stack", None)
        if st:
            st[-1].add_phase(key, ns)
        else:
            with self._lock:
                self._unattributed[key] = self._unattributed.get(key, 0) + ns

    # --------------------------------------------- cross-process splicing
    def splice(self, spans: List[dict], events: List[dict],
               parent: Optional[int], offset_ns: int,
               thread: Optional[str] = None) -> int:
        """Adopt a remote profiler's recorded subtree (span/event dicts
        from a worker telemetry fragment, obs/cluster.py): span ids are
        remapped into this profiler's sequence, intra-fragment parent
        links are preserved, fragment roots re-parent to ``parent`` (the
        driver-side span that caused the dispatch), and every timestamp
        shifts by ``offset_ns`` (the two processes' perf_counter clocks
        are unrelated). ``thread`` overrides the recorded thread name —
        the chrome trace renders one lane per worker process from it.

        Remote ``op`` spans are demoted to ``bg``: the driver's own op
        span already covers the remote wall, and a second op-kind span
        would double-count the per-op rollup. Buffer caps apply (overflow
        counts into ``dropped_spans``/``dropped_events``). Returns the
        number of spans adopted."""
        if not self.armed:
            return 0
        adopted = 0
        with self._lock:
            budget = self.max_spans - len(self._spans)
            if budget < len(spans):
                self.dropped_spans += len(spans) - max(0, budget)
                spans = spans[:max(0, budget)]
            # two passes: spans arrive in END order (children before their
            # parents), so the id map must exist before links resolve
            idmap = {d["id"]: next(self._seq) for d in spans}
            for d in spans:
                kind = d.get("kind", "bg")
                sp = Span(idmap[d["id"]],
                          idmap.get(d.get("parent"), parent),
                          d["name"], d.get("op"), d.get("part"),
                          "bg" if kind == "op" else kind,
                          thread or d.get("thread", "remote"),
                          int(d["t0_ns"]) + offset_ns)
                sp.dur_ns = int(d.get("dur_ns", 0))
                if d.get("phases"):
                    sp.phases = dict(d["phases"])
                if d.get("attrs"):
                    sp.attrs = dict(d["attrs"])
                self._spans.append(sp)
                adopted += 1
            for ev in events:
                if len(self._events) >= self.max_events:
                    self.dropped_events += 1
                    continue
                self._events.append({
                    "t_ns": int(ev.get("t_ns", 0)) + offset_ns,
                    "kind": str(ev.get("kind", "remote")),
                    "attrs": dict(ev.get("attrs") or {})})
        return adopted

    # ------------------------------------------------------------ events
    def event(self, kind: str, /, **attrs) -> None:
        """A typed instant on the span timeline (breaker transition, fault
        injection, throttle, fusion outcome, spill, ...). ``kind`` is
        positional-only so that an attr may itself be named ``kind``."""
        if not self.armed:
            return
        ev = {"t_ns": time.perf_counter_ns(), "kind": kind, "attrs": attrs}
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped_events += 1
            else:
                self._events.append(ev)

    # --------------------------------------------------------- lifecycle
    def finish(self) -> None:
        """Mark the query's end. The last call wins: an AQE query's shared
        profiler is finished once per stage, and the wall covers the LAST
        stage. Late background spans still record."""
        self.t_end_ns = time.perf_counter_ns()

    @property
    def wall_ns(self) -> int:
        end = self.t_end_ns
        if end is None:
            end = time.perf_counter_ns()
        return end - self.t_start_ns

    def spans_snapshot(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def events_snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def unattributed_phases(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._unattributed)

    def drain_for_chrome(self):
        """(spans, events) not yet handed to the chrome renderer; advances
        the marks so that per-stage flushes never repeat earlier batches."""
        with self._lock:
            spans = self._spans[self._chrome_span_mark:]
            events = self._events[self._chrome_event_mark:]
            self._chrome_span_mark = len(self._spans)
            self._chrome_event_mark = len(self._events)
        return spans, events


# the process-wide "profiling is off" profiler: one shared instance, never
# armed, so the hot path's `stats.profiler.armed` check is one attribute
# load and a bool test, and every method is a no-op
DISARMED = Profiler(query_id="disarmed", armed=False, max_spans=0,
                    max_events=0)
