"""Bounded MPSC morsel channel with backpressure and error propagation.

One channel carries one source partition's mapped morsels from its
producer (a task on the query's pool) to the pipeline's consumer. It is
bounded two ways, by a morsel count and by an optional byte cap carved from
the query's memory budget, and every queued morsel's bytes are charged to
the ledger's ``stream_inflight``, so ``health()`` sees the streaming
working set as it sees the readahead's. One morsel is always admitted
whatever the caps, so a morsel larger than the cap still flows.

Failures: a producer's error is stored and re-raised by ``get()`` on the
consumer's thread, never a hung channel; ``close()`` (a limit, a query
error, the teardown) drops the queue, returns its ledger charge and wakes
every blocked producer with :class:`ChannelClosed`, so upstream work stops
instead of producing output nobody reads.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Optional

from ..errors import DaftError

__all__ = ["BoundedChannel", "ChannelClosed", "channels_snapshot"]

# get(timeout=...) expired without an item (distinct from "stream ended",
# which is None): the consumer re-checks deadline/cancel/producer health
WAIT = object()

_registry_lock = threading.Lock()
# live channels, weakly held: health()'s view of channel occupancy
_channels: "weakref.WeakSet" = weakref.WeakSet()


def channels_snapshot() -> dict:
    """Process-wide channel occupancy for ``health()``: live (not yet
    drained or closed) channels and their queued morsels and bytes."""
    with _registry_lock:
        chans = list(_channels)
    active = morsels = qbytes = 0
    for ch in chans:
        n, b, done = ch._occupancy()
        if done and n == 0:
            continue
        active += 1
        morsels += n
        qbytes += b
    return {"active_channels": active, "queued_morsels": morsels,
            "queued_bytes": qbytes}


class ChannelClosed(DaftError):
    """Raised out of ``put()`` after the consumer closed the channel; the
    producer unwinds (counted as a short-circuit) instead of blocking on a
    queue nobody drains."""


class BoundedChannel:
    """Bounded MPSC channel of ``(morsel, nbytes)`` pairs (see module
    docstring for the backpressure/close/error contract)."""

    def __init__(self, capacity: int, max_bytes: Optional[int] = None,
                 ledger=None, stats=None):
        self._cond = threading.Condition()
        self._q: deque = deque()
        self._qbytes = 0
        self.capacity = max(1, int(capacity))
        self.max_bytes = max_bytes
        self._finished = False
        self._error: Optional[BaseException] = None
        self.closed = False
        # peak queued morsels, read by the driver into the
        # stream_channel_high_water counter at drain time
        self.high_water = 0
        # morsels successfully put (the producer's retry gate: a partition
        # may only re-run while nothing has been handed downstream)
        self.pushed = 0
        self._ledger = ledger
        self._stats = stats
        with _registry_lock:
            _channels.add(self)

    # ------------------------------------------------------------ producer
    def _has_room(self) -> bool:
        if not self._q:
            return True  # one in-flight always allowed
        if len(self._q) >= self.capacity:
            return False
        if self.max_bytes is not None and self._qbytes >= self.max_bytes:
            return False
        return True

    def put(self, item, nbytes: int) -> None:
        """Enqueue a morsel, blocking (backpressure) while the channel is
        at capacity. Blocked time is counted as a backpressure stall."""
        stalled_ns = 0
        with self._cond:
            if not self._has_room() and not self.closed:
                t0 = time.perf_counter_ns()
                while not self._has_room() and not self.closed:
                    self._cond.wait()
                stalled_ns = time.perf_counter_ns() - t0
            if self.closed:
                raise ChannelClosed("stream channel closed by consumer")
            # charge under the channel lock, before the morsel is visible:
            # the consumer (or close()) releases a morsel's bytes only after
            # popping it, so the release never outruns the charge (the
            # ledger would clamp an early release and the charge would leak)
            if self._ledger is not None and nbytes:
                self._ledger.stream_started(nbytes)
            self._q.append((item, nbytes))
            self._qbytes += nbytes
            self.pushed += 1
            if len(self._q) > self.high_water:
                self.high_water = len(self._q)
            self._cond.notify_all()
        if stalled_ns and self._stats is not None:
            self._stats.bump("stream_backpressure_stalls")
            self._stats.bump("stream_backpressure_ns", stalled_ns)

    def finish(self) -> None:
        """Producer completed this partition normally."""
        with self._cond:
            self._finished = True
            self._cond.notify_all()

    def fail(self, exc: BaseException) -> None:
        """Producer died: park the error for the consumer's next get()."""
        with self._cond:
            if self._error is None:
                self._error = exc
            self._finished = True
            self._cond.notify_all()

    # ------------------------------------------------------------ consumer
    def get(self, timeout: Optional[float] = None):
        """Next morsel; ``None`` when the producer finished and the queue
        drained; the module-level ``WAIT`` sentinel when ``timeout``
        expired (caller re-checks deadline/cancel/producer liveness). A
        producer error re-raises HERE, on the consumer thread."""
        with self._cond:
            while True:
                if self._error is not None:
                    err, self._error = self._error, None
                    raise err
                if self._q:
                    item, nbytes = self._q.popleft()
                    self._qbytes -= nbytes
                    self._cond.notify_all()
                    break
                if self._finished or self.closed:
                    return None
                if not self._cond.wait(timeout):
                    return WAIT
        if self._ledger is not None and nbytes:
            self._ledger.stream_done(nbytes)
        return item

    def close(self) -> None:
        """Consumer-side close: drop queued morsels (returning their
        ledger charge) and wake every blocked producer into
        ChannelClosed."""
        with self._cond:
            if self.closed:
                return
            self.closed = True
            dropped = self._qbytes
            self._q.clear()
            self._qbytes = 0
            self._cond.notify_all()
        if self._ledger is not None and dropped:
            self._ledger.stream_done(dropped)

    # ------------------------------------------------------------- misc
    def _occupancy(self):
        with self._cond:
            return len(self._q), self._qbytes, (self._finished or self.closed)

    def __len__(self) -> int:
        with self._cond:
            return len(self._q)

    @property
    def queued_bytes(self) -> int:
        with self._cond:
            return self._qbytes
