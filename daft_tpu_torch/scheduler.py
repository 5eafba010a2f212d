"""Partition-task scheduling (the port's copy of the part of
daft_tpu/scheduler.py the scan readahead reads): the marker of threads that
run a dispatched partition task.

The scan prefetcher (io/prefetch.py) stands down on such a thread: the
dispatch window already overlaps the workers' reads, and io_wait_ns means
the time the consumer's thread waited. The port dispatches no partition
task to a pool yet, so ``on_pool_worker()`` is False on every path. The
rest of the module (``PartitionTask``, the bounded dispatch loop and its
in-flight window) comes with the pooled fan-out (ROADMAP, Queue 1, item 7).
"""

from __future__ import annotations

import threading

# marks threads executing a dispatched partition task
_WORKER_TL = threading.local()


def on_pool_worker() -> bool:
    return getattr(_WORKER_TL, "active", False)
