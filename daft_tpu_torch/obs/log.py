"""Structured JSON-lines engine logging with a query id carried across
threads (the port's copy of daft_tpu/obs/log.py).

Every engine log line is a dict record (timestamp, level, logger name,
event, thread, free-form fields) kept in a bounded process ring (the
diagnostics bundles keep its tail), forwarded to the stdlib ``logging``
tree under ``daft_tpu_torch.<name>`` as one JSON line (so existing
handlers and caplog keep working), and optionally appended to a
JSON-lines file (``log_to_file``, or DAFT_TPU_TORCH_LOG_JSON=<path> read
at import). The logger names and the variable are the port's own, so the
two packages never write to one logger or one file.

The query id is ALWAYS bound and costs one thread-local read per record:
``execution.execute_plan`` binds it on the consumer's thread for each
pull, and every background hop the engine makes (the async spill writer,
scan prefetches, unspill readaheads, actor-pool batches) captures
``current_query_id()`` at submit time and binds it again inside the job
through ``query_context``. A line emitted from any of those threads
carries the query that caused the work.

``inject`` relays a worker process's records into the driver's ring as
recorded (the telemetry merge of the distributed runner, obs/cluster.py).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Deque, Dict, List, Optional

__all__ = ["EngineLogger", "get_logger", "current_query_id", "query_context",
           "tail", "clear", "set_ring_cap", "dropped_records", "ring_size",
           "log_to_file", "close_file", "inject", "add_sink", "remove_sink",
           "DEFAULT_RING_CAP"]

# bounded record ring: a record is a small dict, so the worst-case buffer
# stays low-MB; evictions are counted so a truncated tail is never mistaken
# for the whole history
DEFAULT_RING_CAP = 4096

_LEVELS = {"debug": logging.DEBUG, "info": logging.INFO,
           "warning": logging.WARNING, "error": logging.ERROR}

_lock = threading.Lock()
_ring: Deque[dict] = deque(maxlen=DEFAULT_RING_CAP)
_dropped = 0
_sinks: List[Callable[[dict], None]] = []
_file = None  # open JSON-lines file handle (log_to_file)
# writes to the shared file serialize on their own lock (never nested with
# _lock) so concurrent emits can't interleave half-written JSON lines
_file_lock = threading.Lock()

# ---------------------------------------------------------------------------
# query-id context
# ---------------------------------------------------------------------------

_qtl = threading.local()


def current_query_id() -> Optional[str]:
    """The query id bound to THIS thread (None outside any query). Capture
    it before submitting background work and re-bind inside the job with
    ``query_context`` so log lines from worker threads stay attributed."""
    return getattr(_qtl, "qid", None)


@contextmanager
def query_context(qid: Optional[str]):
    """Bind ``qid`` as this thread's current query for the block (nestable;
    restores the previous binding on exit). Passing the ``None`` a capture
    on an unbound thread returned is legal and leaves lines unattributed."""
    prev = getattr(_qtl, "qid", None)
    _qtl.qid = qid
    try:
        yield
    finally:
        _qtl.qid = prev


# ---------------------------------------------------------------------------
# the logger
# ---------------------------------------------------------------------------

def _publish(rec: dict, py_logger: logging.Logger) -> Optional[str]:
    """Ring append, sink dispatch and JSON-lines file write for one record.
    Returns the serialized line when a file is armed."""
    global _dropped
    with _lock:
        if _ring.maxlen is not None and len(_ring) == _ring.maxlen:
            _dropped += 1
        _ring.append(rec)
        sinks = list(_sinks) if _sinks else None
        f = _file
    if sinks is not None:
        for s in sinks:
            try:
                s(rec)
            except Exception:
                py_logger.exception("log sink failed")
    line = None
    if f is not None:
        try:
            line = json.dumps(rec, default=str)
            with _file_lock:
                f.write(line + "\n")
                f.flush()
        except (OSError, ValueError):
            pass  # a full/closed log file must never fail the engine
    return line


class EngineLogger:
    """Named structured logger. ``logger.warning("spill_write_failed",
    path=..., error=...)`` emits one record; the ``event`` is a stable
    machine-readable slug, everything else rides as fields."""

    __slots__ = ("name", "_py")

    def __init__(self, name: str):
        self.name = name
        self._py = logging.getLogger(f"daft_tpu_torch.{name}")

    def _emit(self, level: str, event: str, fields: dict) -> None:
        rec = {"ts": round(time.time(), 6), "level": level,
               "logger": self.name, "event": event,
               "thread": threading.current_thread().name}
        qid = getattr(_qtl, "qid", None)
        if qid is not None:
            rec["query_id"] = qid
        if fields:
            rec.update(fields)
        line = _publish(rec, self._py)
        lvl = _LEVELS[level]
        if self._py.isEnabledFor(lvl):
            self._py.log(lvl, "%s",
                         line if line is not None
                         else json.dumps(rec, default=str))

    def debug(self, event: str, **fields) -> None:
        self._emit("debug", event, fields)

    def info(self, event: str, **fields) -> None:
        self._emit("info", event, fields)

    def warning(self, event: str, **fields) -> None:
        self._emit("warning", event, fields)

    def error(self, event: str, **fields) -> None:
        self._emit("error", event, fields)


_loggers: Dict[str, EngineLogger] = {}


def get_logger(name: str) -> EngineLogger:
    with _lock:
        lg = _loggers.get(name)
        if lg is None:
            lg = _loggers[name] = EngineLogger(name)
        return lg


# ---------------------------------------------------------------------------
# ring access / sinks
# ---------------------------------------------------------------------------

def tail(n: int = 200, query_id: Optional[str] = None,
         level: Optional[str] = None) -> List[dict]:
    """The newest ``n`` records (optionally filtered by query id or minimum
    level), oldest first: what the diagnostics bundles keep."""
    with _lock:
        recs = list(_ring)
    if query_id is not None:
        recs = [r for r in recs if r.get("query_id") == query_id]
    if level is not None:
        floor = _LEVELS[level]
        recs = [r for r in recs if _LEVELS[r["level"]] >= floor]
    return recs[-n:]


def clear() -> None:
    global _dropped
    with _lock:
        _ring.clear()
        _dropped = 0


def set_ring_cap(cap: int) -> None:
    """Resize the ring, keeping the newest records that fit."""
    global _ring, _dropped
    with _lock:
        old = list(_ring)
        _ring = deque(old[-cap:] if cap else [], maxlen=max(1, cap))
        _dropped += max(0, len(old) - cap)


def dropped_records() -> int:
    with _lock:
        return _dropped


def ring_size() -> int:
    with _lock:
        return len(_ring)


def inject(rec: dict) -> None:
    """Publish a finished record to the ring, the sinks and the JSON-lines
    file as recorded: the telemetry merge relays worker-process records
    through here, with their timestamp, level and query id intact. Not
    forwarded to stdlib logging: the record already went through the
    worker's, and forwarding it again would double every worker line."""
    _publish(rec, logging.getLogger("daft_tpu_torch.obs"))


def add_sink(fn: Callable[[dict], None]) -> None:
    """Register a per-record callback (shipping records to a collector)."""
    with _lock:
        _sinks.append(fn)


def remove_sink(fn: Callable[[dict], None]) -> None:
    with _lock:
        if fn in _sinks:
            _sinks.remove(fn)


def log_to_file(path: str) -> None:
    """Append every subsequent record to ``path`` as JSON lines."""
    global _file
    f = open(path, "a", encoding="utf-8")
    with _lock:
        old, _file = _file, f
    if old is not None:
        old.close()


def close_file() -> None:
    global _file
    with _lock:
        f, _file = _file, None
    if f is not None:
        f.close()


_env_path = os.environ.get("DAFT_TPU_TORCH_LOG_JSON")
if _env_path:
    log_to_file(_env_path)
