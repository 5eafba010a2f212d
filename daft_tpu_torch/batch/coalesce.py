"""Partition coalescing for the dynamic-batching executor (the port's copy of
daft_tpu/batch/coalesce.py).

A Coalescer buffers whole input partitions (never splitting one across
batches, so the re-split is a prefix sum) and decides when the buffered run
becomes a batch:

  - ``budget``: buffered rows reach ``max_rows`` or bytes reach ``max_bytes``
  - ``timer``:  the oldest buffered partition has waited at least
                ``flush_ms`` when the next one arrives (no background
                thread: the stream's own cadence bounds the latency, and the
                end flush bounds the tail)
  - ``end``:    the source is exhausted (``finish()``)

Buffered bytes are charged to the ledger's ``batch_inflight`` account at
feed and settled when the flush is handed to the executor: a nonzero
account after a query is a leak.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

from ..micropartition import MicroPartition


def _part_bytes(p: MicroPartition) -> int:
    try:
        return int(p.size_bytes() or 0)
    except Exception:
        return 0


class Flush:
    """One completed batch: the buffered source partitions in feed order and
    the bookkeeping the executor needs to apply and re-split."""

    __slots__ = ("parts", "rows", "bytes", "reason")

    def __init__(self, parts: List[MicroPartition], rows: int, nbytes: int, reason: str):
        self.parts = parts
        self.rows = rows
        self.bytes = nbytes
        self.reason = reason  # "budget" | "timer" | "end"


class Coalescer:
    """Single-producer flush machine (one per op execute); not thread-safe by
    design."""

    def __init__(self, max_rows: int, max_bytes: int, flush_ms: float,
                 ledger=None, clock: Callable[[], float] = time.monotonic):
        self.max_rows = max(1, int(max_rows))
        self.max_bytes = max(1, int(max_bytes))
        self.flush_ms = float(flush_ms)
        self._ledger = ledger
        self._clock = clock
        self._parts: List[MicroPartition] = []
        self._rows = 0
        self._bytes = 0
        self._oldest: Optional[float] = None

    def _take(self, reason: str) -> Flush:
        f = Flush(self._parts, self._rows, self._bytes, reason)
        self._parts, self._rows, self._bytes, self._oldest = [], 0, 0, None
        return f

    def settle(self, f: Flush) -> None:
        """Release the ledger charge of a handed-out flush (once the batch's
        outputs exist, or on the degrade path)."""
        if self._ledger is not None and f.bytes:
            self._ledger.batch_done(f.bytes)

    def feed(self, part: MicroPartition) -> List[Flush]:
        """Buffer one partition; return every batch that became due (a timer
        flush of the old run can precede a budget flush of the new one)."""
        out: List[Flush] = []
        now = self._clock()
        if (self._parts and self.flush_ms >= 0
                and (now - self._oldest) * 1000.0 >= self.flush_ms):
            out.append(self._take("timer"))
        nb = _part_bytes(part)
        if self._ledger is not None and nb:
            self._ledger.batch_started(nb)
        if not self._parts:
            self._oldest = now
        self._parts.append(part)
        self._rows += len(part)
        self._bytes += nb
        if self._rows >= self.max_rows or self._bytes >= self.max_bytes:
            out.append(self._take("budget"))
        return out

    def finish(self) -> List[Flush]:
        """Flush whatever remains (source exhausted)."""
        if not self._parts:
            return []
        return [self._take("end")]
