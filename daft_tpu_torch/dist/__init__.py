"""The distributed runner (the port's copy of daft_tpu/dist/).

A ``DistributedRunner`` ships map-class partition tasks, serialized, to a
supervised pool of worker processes over a length-prefixed, checksummed
socket transport (transport.py), and treats a worker's death as a tested
path: heartbeats with a deadline, a WorkerHealth breaker per worker,
respawns under a restart budget, re-dispatch with attempt counts and
excluded workers, exactly-once results through a driver-side ledger and a
poison-task DaftError naming the task (supervisor.py). Shuffles can run
peer to peer: workers host their pieces and reducers pull them from each
other (peerplane.py). Every worker runs its tasks under the ``device`` of
the driver's config, so on the card each one launches K1 and K2 itself.
On behind ``distributed_workers`` (0: off); the rows equal NativeRunner's
byte for byte when on. ``peer.py`` is the mesh's host transport between
the processes of a torch.distributed cluster.
"""

from .runner import DistributedRunner
from .supervisor import (WorkerPool, get_worker_pool, live_worker_process_count,
                         shutdown_worker_pool, worker_pool_snapshot)

__all__ = ["DistributedRunner", "WorkerPool", "get_worker_pool",
           "live_worker_process_count", "shutdown_worker_pool", "worker_pool_snapshot"]
