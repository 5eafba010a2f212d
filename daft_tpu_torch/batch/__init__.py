"""Dynamic-batching UDF executor (the port's copy of daft_tpu/batch/).

Decouples a UDF's batch size from the partition size: whole partitions are
coalesced across their boundaries into batches under a byte/row budget
with a max-latency flush timer, applied once, and re-split to the exact
source boundaries, so outputs equal the per-partition path's.

Modules:
  coalesce.py  the budget/timer flush machine (fault site batch.coalesce)
  actors.py    ModelActorPool: pinned per-process model instances, LRU
               under the ledger's model_cache_bytes account (actor.load)
  executor.py  BatchingExecutor: coalesce, pad, apply, re-split
  device.py    K13: the model's apply_torch on the card, behind the breaker

A flush records the ``batch.coalesce`` and ``actor.apply`` phase spans, a
degraded coalesce logs ``batch_coalesce_degraded``, and the process-wide
flush counts feed ``health()["batching"]``. In a morsel pipeline
(stream/pipeline.py) each producer gives a batch-declared op a
BatchingExecutor of its own, and the outputs re-split to the morsel
boundaries.
"""

from .actors import (ModelActorPool, get_model_pool, model_pools_snapshot, pinned_model_count,
                     shutdown_all_models)
from .coalesce import Coalescer, Flush
from .executor import BatchingExecutor, BatchSettings

__all__ = [
    "BatchSettings",
    "BatchingExecutor",
    "Coalescer",
    "Flush",
    "ModelActorPool",
    "get_model_pool",
    "model_pools_snapshot",
    "pinned_model_count",
    "shutdown_all_models",
]
