"""Pinned model actors for batch-declared class UDFs (the port's copy of
daft_tpu/batch/actors.py).

A ModelActorPool extends actor_pool.ActorPool with what batched inference
needs:

  - ONE instance per process per model fingerprint (class, init args and
    device slot): weights load once and stay resident ACROSS queries.
  - Residency is charged to the process ledger's ``model_cache_bytes``
    account (a class may declare ``weight_bytes``; an undeclared model
    charges 0 and is still LRU-tracked). When resident bytes exceed the
    ``model_cache_bytes`` config budget, least-recently-used pools are
    evicted (shut down, charge released), never the one just admitted.
  - Construction passes the ``actor.load`` fault site; any load failure
    (injected or real) surfaces as a DaftResourceError naming the model,
    with no half-initialized pool left registered.

An eviction logs ``model_pool_evicted``; ``pinned_model_count`` and
``resident_weight_bytes`` feed ``health()["batching"]``.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, List, Optional

from ..actor_pool import ActorPool
from ..errors import DaftResourceError
from ..obs.log import get_logger

logger = get_logger("batch.actors")

_lock = threading.Lock()
# fingerprint -> ModelActorPool, oldest use first (move_to_end on use)
_model_pools: "OrderedDict[str, ModelActorPool]" = OrderedDict()


def model_fingerprint(cls: type, init_args: Optional[tuple], device: int = 0) -> str:
    return f"{cls.__module__}.{cls.__qualname__}|{init_args!r}|dev{device}"


class ModelActorPool:
    """One pinned model instance behind a single-worker ActorPool."""

    def __init__(self, cls: type, init_args: Optional[tuple], device: int = 0):
        from .. import faults

        self.cls = cls
        self.fingerprint = model_fingerprint(cls, init_args, device)
        self.device = device
        self.weight_bytes = int(getattr(cls, "weight_bytes", 0) or 0)
        self.applies = 0
        self.last_used = time.monotonic()
        try:
            faults.check("actor.load")
            self._pool = ActorPool(cls, init_args, concurrency=1)
        except Exception as e:
            raise DaftResourceError(
                f"model load failed for {cls.__qualname__} "
                f"(fingerprint {self.fingerprint}): {e!r}") from e

    def apply(self, args: List[Any], n: int) -> Any:
        """Run instance(*args) on the pinned worker (serialized per model)."""
        self.applies += 1
        self.last_used = time.monotonic()
        return self._pool.map_batches([tuple(args)])[0]

    def torch_callable(self):
        """The model's opt-in torch apply (its ``apply_torch`` attribute), or
        None: the device path (batch/device.py) declines without it."""
        return getattr(self.cls, "apply_torch", None)

    def shutdown(self) -> None:
        self._pool.shutdown()


def _charge(delta: int) -> None:
    if delta:
        from ..spill import MEMORY_LEDGER

        MEMORY_LEDGER.cache_account("model_cache_bytes", delta)


def _budget_bytes() -> int:
    from ..context import get_context

    return int(get_context().execution_config.model_cache_bytes)


def get_model_pool(cls: type, init_args: Optional[tuple], device: int = 0) -> ModelActorPool:
    """The pinned pool for this model, constructed (and the least recently
    used pools evicted past the model_cache_bytes budget) on first use."""
    fp = model_fingerprint(cls, init_args, device)
    evicted: List[ModelActorPool] = []
    with _lock:
        pool = _model_pools.get(fp)
        if pool is not None:
            _model_pools.move_to_end(fp)
            return pool
        pool = ModelActorPool(cls, init_args, device)  # raises typed on failure
        _model_pools[fp] = pool
        _model_pools.move_to_end(fp)
        _charge(pool.weight_bytes)
        budget = _budget_bytes()
        while (len(_model_pools) > 1
               and sum(p.weight_bytes for p in _model_pools.values()) > budget):
            _, lru = _model_pools.popitem(last=False)
            evicted.append(lru)
    for lru in evicted:
        logger.info("model_pool_evicted", fingerprint=lru.fingerprint,
                    weight_bytes=lru.weight_bytes)
        lru.shutdown()
        _charge(-lru.weight_bytes)
    return pool


def pinned_model_count() -> int:
    with _lock:
        return len(_model_pools)


def resident_weight_bytes() -> int:
    with _lock:
        return sum(p.weight_bytes for p in _model_pools.values())


def model_pools_snapshot() -> List[dict]:
    """One entry per pinned pool."""
    with _lock:
        return [{"fingerprint": p.fingerprint, "weight_bytes": p.weight_bytes,
                 "applies": p.applies, "device": p.device}
                for p in _model_pools.values()]


def shutdown_all_models() -> None:
    with _lock:
        pools = list(_model_pools.values())
        _model_pools.clear()
    for p in pools:
        p.shutdown()
        _charge(-p.weight_bytes)
