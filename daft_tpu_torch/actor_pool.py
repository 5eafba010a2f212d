"""Actor pools for stateful UDFs (the port's copy of daft_tpu/actor_pool.py).

A class UDF with ``concurrency=k`` gets k persistent worker threads, each
owning ONE instance of the class (constructed once, reused for every batch
it serves): the pattern for model UDFs whose construction loads weights.

Batches are dispatched as (index, slices) over a shared task queue and the
results re-assembled in order, so the output order does not depend on
which worker served which batch. Threads, not processes: model UDFs spend
their time in torch, numpy or IO, which release the GIL.

Pools are keyed by (class, init args, concurrency) and persist across
queries. ``shutdown_all()`` tears them down, with the pinned model actors
of batch/actors.py. A worker that outlives its pool's shutdown window is
counted (``leaked_thread_count``) and logged (``actor_pool_leak``).

Each batch carries the dispatching thread's query id and, inside a
BatchedUdfOp (batch/device.py ``exec_ctx_scope``), its profiler's captured
span: the worker binds both while it runs the batch, so its log lines and
any span it opens stay attributed to the query and the op.
"""

from __future__ import annotations

import atexit
import queue
import threading
from typing import Any, Dict, List, Optional, Tuple

from .obs.log import current_query_id, get_logger, query_context

logger = get_logger("actor_pool")

_pools: Dict[Tuple, "ActorPool"] = {}
_pools_lock = threading.Lock()

# process-wide count of worker threads that outlived their pool's shutdown
# join window (daemons, so they die with the process, but their instances
# pin memory or the card until then)
_leak_lock = threading.Lock()
_leaked_threads = 0


def leaked_thread_count() -> int:
    return _leaked_threads


class ActorPool:
    def __init__(self, cls: type, init_args: Optional[tuple], concurrency: int):
        self._cls = cls
        self._init_args = init_args
        self._n = max(1, concurrency)
        self._tasks: "queue.Queue" = queue.Queue()
        self._threads: List[threading.Thread] = []
        self._init_errors: List[BaseException] = []
        # no timeout: loading model weights in __init__ may take minutes;
        # every worker reaches the barrier (its init is wrapped)
        self._started = threading.Barrier(self._n + 1)
        for i in range(self._n):
            t = threading.Thread(target=self._worker, name=f"daft-actor-{cls.__name__}-{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        self._started.wait()  # every instance constructed (or failed) before dispatch
        if self._init_errors:
            self.shutdown()  # release the workers that did construct theirs
            raise self._init_errors[0]

    def _worker(self) -> None:
        try:
            a, kw = self._init_args or ((), {})
            instance = self._cls(*a, **kw)
        except BaseException as e:  # noqa: BLE001
            self._init_errors.append(e)
            try:
                self._started.wait()
            except threading.BrokenBarrierError:
                pass
            return
        try:
            self._started.wait()
        except threading.BrokenBarrierError:
            return
        while True:
            item = self._tasks.get()
            if item is None:
                return
            idx, fn_args, results, errors, done, qid, prof, token = item
            try:
                with query_context(qid), prof.activate(token):
                    results[idx] = instance(*fn_args)
            except BaseException as e:  # noqa: BLE001
                errors[idx] = e
            finally:
                done.release()

    def map_batches(self, batches: List[tuple]) -> List[Any]:
        """Run instance(*batch) for each batch across the pool; ordered results."""
        k = len(batches)
        results: List[Any] = [None] * k
        errors: List[Optional[BaseException]] = [None] * k
        done = threading.Semaphore(0)
        from .batch.device import current_exec_ctx
        from .profile.spans import DISARMED

        ctx = current_exec_ctx()
        prof = ctx.stats.profiler if ctx is not None else DISARMED
        qid, token = current_query_id(), prof.capture()
        for i, b in enumerate(batches):
            self._tasks.put((i, b, results, errors, done, qid, prof, token))
        for _ in range(k):
            done.acquire()
        for e in errors:
            if e is not None:
                raise e
        return results

    def shutdown(self, join_timeout_s: float = 5.0) -> None:
        global _leaked_threads
        for _ in self._threads:
            self._tasks.put(None)
        leaked = 0
        for t in self._threads:
            t.join(timeout=join_timeout_s)
            if t.is_alive():
                leaked += 1
        if leaked:
            # a worker wedged mid-batch never saw its sentinel: shutdown does
            # not block on it, but the count keeps the leak visible
            with _leak_lock:
                _leaked_threads += leaked
            logger.warning("actor_pool_leak", actor=self._cls.__name__,
                           leaked=leaked, join_timeout_s=join_timeout_s)


def get_pool(cls: type, init_args: Optional[tuple], concurrency: int) -> ActorPool:
    key = (cls, repr(init_args), concurrency)
    with _pools_lock:
        pool = _pools.get(key)
        if pool is None:
            pool = ActorPool(cls, init_args, concurrency)
            _pools[key] = pool
        return pool


def pool_count() -> int:
    """Live actor pools."""
    with _pools_lock:
        return len(_pools)


def shutdown_all() -> None:
    with _pools_lock:
        pools = list(_pools.values())
        _pools.clear()
    for p in pools:
        p.shutdown()
    # the pinned model actors (batch/actors.py) go down with them, so "engine
    # down" means no resident model either (lazy: batch/ imports this module)
    from .batch.actors import shutdown_all_models

    shutdown_all_models()


atexit.register(shutdown_all)
