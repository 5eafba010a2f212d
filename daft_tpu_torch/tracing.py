"""Chrome trace and progress reporting (the port's copy of
daft_tpu/tracing.py).

Events are buffered in a bounded RING (evictions counted and written as
``droppedEvents``) and written as one chrome://tracing JSON document. The
per-op duration events are rendered FROM the structured profiler's span
tree (daft_tpu_torch/profile/) at each query's end: one writer, re-armed
per query, so the trace carries the same cross-thread attribution as the
QueryProfile. A span's phases ride in its ``args`` (``phase.device_dispatch``
is host time spent staging and launching on the card, not kernel time:
profile/spans.py).

Arm it with the environment variable DAFT_TPU_TORCH_CHROME_TRACE=<path>
(read at import; the reference's DAFT_TPU_CHROME_TRACE is its own, so the
two packages never write one file) or in code:

    with daft_tpu_torch.tracing.chrome_trace("/tmp/q1.json"):
        df.collect()

Progress: ``set_progress_callback(cb)`` calls ``cb(op_name, rows)`` for
every partition an operator emits; ``progress_bars()`` (or
DAFT_TPU_TORCH_PROGRESS=1, read by context.py) installs a terminal
``ProgressBar``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Deque, Optional

# Buffer cap: a RING — past it the OLDEST events are evicted and counted
# (dropped_events()), so a long-running armed process keeps the most recent
# window instead of growing without bound. The flush metadata records the
# drop count so a truncated trace is never mistaken for a complete one.
DEFAULT_BUFFER_CAP = 200_000

_lock = threading.Lock()
_events: Deque[dict] = deque(maxlen=DEFAULT_BUFFER_CAP)
_dropped = 0
_path: Optional[str] = None
_t0_us: float = 0.0
# thread name -> chrome tid, stable for the LIFETIME of one armed trace:
# the consolidated multi-query file must keep each real thread on one lane
_tids: dict = {}

_progress_cb: Optional[Callable[[str, int], None]] = None


def active() -> bool:
    return _path is not None


def _now_us() -> float:
    return time.perf_counter_ns() / 1000.0


def set_buffer_cap(cap: int) -> None:
    """Resize the ring, keeping the newest events that fit."""
    global _events, _dropped
    with _lock:
        old = list(_events)
        _events = deque(old[-cap:] if cap else [], maxlen=max(1, cap))
        _dropped += max(0, len(old) - cap)


def dropped_events() -> int:
    with _lock:
        return _dropped


def tail(n: int = 2000) -> list:
    """The newest ``n`` buffered chrome events (oldest first): what the
    diagnostics bundles keep when a trace is armed."""
    with _lock:
        evs = list(_events)
    return evs[-n:]


def enable(path: str) -> None:
    """Start buffering events; flush() writes them to `path`."""
    global _path, _t0_us, _dropped
    with _lock:
        _path = path
        _t0_us = _now_us()
        _events.clear()
        _dropped = 0
        _tids.clear()


def _append_locked(ev: dict) -> None:
    # runs under _lock (every caller holds it)
    global _dropped
    if _events.maxlen is not None and len(_events) == _events.maxlen:
        # the ring evicts its oldest entry on this append
        _dropped += 1
    _events.append(ev)


def add_event(name: str, start_us: float, dur_us: float, tid: int = 0,
              args: Optional[dict] = None) -> None:
    if _path is None:
        return
    ev = {"name": name, "ph": "X", "pid": os.getpid(), "tid": tid,
          "ts": start_us - _t0_us, "dur": dur_us}
    if args:
        ev["args"] = args
    with _lock:
        _append_locked(ev)


def add_instant(name: str, args: Optional[dict] = None) -> None:
    """A zero-duration marker (a chrome-trace 'instant' event) for discrete
    occurrences such as injected faults, which have no wall time but matter
    when a failure is lined up against the pipeline."""
    if _path is None:
        return
    ev = {"name": name, "ph": "i", "s": "g", "pid": os.getpid(), "tid": 0,
          "ts": _now_us() - _t0_us}
    if args:
        ev["args"] = args
    with _lock:
        _append_locked(ev)


def add_span_events(profiler) -> None:
    """Render a finished query's span tree and typed events into the chrome
    buffer (the span tree is the one source of the trace's op events).
    Threads map to chrome tids by first appearance, stable over the armed
    trace's lifetime; span phases and attrs ride in ``args`` so the viewer
    shows the QueryProfile's breakdown. Incremental: only spans and events
    not rendered yet are emitted, so an AQE query's per-stage flushes never
    repeat an earlier stage."""
    if _path is None:
        return
    spans, events = profiler.drain_for_chrome()
    pid = os.getpid()
    with _lock:
        t0 = _t0_us
        for sp in spans:
            tid = _tids.setdefault(sp.thread, len(_tids))
            args = {"span": sp.sid, "kind": sp.kind}
            if sp.parent is not None:
                args["parent"] = sp.parent
            if sp.part is not None:
                args["part"] = sp.part
            if sp.phases:
                args.update({f"phase.{k}": v for k, v in sp.phases.items()})
            if sp.attrs:
                args.update(sp.attrs)
            _append_locked({
                "name": sp.name, "ph": "X", "pid": pid, "tid": tid,
                "ts": sp.t0_ns / 1000.0 - t0, "dur": sp.dur_ns / 1000.0,
                "args": args})
        for ev in events:
            _append_locked({
                "name": ev["kind"], "ph": "i", "s": "g", "pid": pid,
                "tid": 0, "ts": ev["t_ns"] / 1000.0 - t0,
                "args": dict(ev.get("attrs") or {})})


def flush(keep: bool = False) -> Optional[str]:
    """Write the buffered events, atomically against concurrent emits: the
    buffer is copied (and, unless ``keep``, cleared) under the lock in one
    step, then written outside it, so an emit racing the write lands in the
    next flush, never lost or repeated. ``keep=True`` is the per-query mode:
    the file always holds everything so far, and later queries append."""
    global _dropped
    with _lock:
        path = _path
        if path is None:
            return None
        evs = list(_events)
        dropped = _dropped
        if not keep:
            # the written file records this window's drops; the next
            # window starts with a clean count (a later complete batch
            # must not be mislabeled as truncated)
            _events.clear()
            _dropped = 0
    doc = {"traceEvents": evs, "displayTimeUnit": "ms"}
    if dropped:
        doc["droppedEvents"] = dropped
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def flush_query() -> Optional[str]:
    """The query-end flush: rewrite the armed trace file with everything
    buffered so far, KEEPING the buffer: every query re-arms the same
    writer, and the file survives a process kill between queries."""
    return flush(keep=True)


def disable() -> None:
    global _path
    with _lock:
        _path = None
        _events.clear()
        _tids.clear()


@contextmanager
def chrome_trace(path: str):
    """Trace every query run inside the block into one chrome-trace file."""
    enable(path)
    try:
        yield
    finally:
        flush()
        disable()


# armed from the environment once; the atexit hook writes the file even
# though no context manager wraps the process
_env_path = os.environ.get("DAFT_TPU_TORCH_CHROME_TRACE")
if _env_path:
    import atexit

    enable(_env_path)
    atexit.register(flush)


# ---------------------------------------------------------------------------
# progress
# ---------------------------------------------------------------------------

def set_progress_callback(cb: Optional[Callable[[str, int], None]]) -> None:
    """cb(op_name, rows_emitted) fires per produced partition (None clears)."""
    global _progress_cb
    _progress_cb = cb


def report_progress(op_name: str, rows: int) -> None:
    cb = _progress_cb
    if cb is not None:
        cb(op_name, rows)


class ProgressBar:
    """Terminal progress: one tqdm bar per operator when tqdm is importable,
    a plain carriage-return line otherwise. Enable with ``progress_bars()``
    (or DAFT_TPU_TORCH_PROGRESS=1, read in context.py); disable with
    ``progress_bars(False)``."""

    def __init__(self, use_tqdm: Optional[bool] = None):
        if use_tqdm is None:
            try:
                import tqdm  # noqa: F401

                use_tqdm = True
            except ImportError:
                use_tqdm = False
        self._use_tqdm = use_tqdm
        self._bars = {}
        self._counts = {}

    def __call__(self, op_name: str, rows: int) -> None:
        if self._use_tqdm:
            from tqdm import tqdm

            bar = self._bars.get(op_name)
            if bar is None:
                bar = self._bars[op_name] = tqdm(
                    desc=op_name, unit=" rows", position=len(self._bars),
                    leave=False)
            bar.update(rows)
        else:
            import sys

            self._counts[op_name] = self._counts.get(op_name, 0) + rows
            line = " | ".join(f"{k}: {v:,}" for k, v in self._counts.items())
            print("\r" + line[:160], end="", file=sys.stderr, flush=True)

    def close(self) -> None:
        for bar in self._bars.values():
            bar.close()
        self._bars.clear()
        if self._counts:
            import sys

            print("", file=sys.stderr)
        self._counts.clear()


def query_finished() -> None:
    """Close the per-query progress state (bars restart with the next
    query)."""
    cb = _progress_cb
    if isinstance(cb, ProgressBar):
        cb.close()


def progress_bars(enable: bool = True) -> None:
    """Toggle terminal progress reporting for subsequent queries."""
    global _progress_cb
    if isinstance(_progress_cb, ProgressBar):
        _progress_cb.close()
    set_progress_callback(ProgressBar() if enable else None)
