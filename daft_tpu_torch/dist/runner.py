"""DistributedRunner: the runner of worker processes (the port's copy of
daft_tpu/dist/runner.py).

The same plans NativeRunner runs, with the query's dispatch backend pointed
at the supervised WorkerPool (supervisor.py): every eligible map-class
partition task ships to a worker process; sources, exchanges, pipeline
breakers and UDF closures stay in the driver. ``distributed_workers``
sizes the pool; 0 is exactly NativeRunner (no pool, no backend), and the
rows are byte-identical at every worker count.
"""

from __future__ import annotations

from ..runners import NativeRunner


class DistributedRunner(NativeRunner):
    name = "distributed"

    def _context(self, cfg, stats, deadline, health, collective):
        ctx = super()._context(cfg, stats, deadline, health, collective)
        if cfg.distributed_workers > 0:
            from .supervisor import get_worker_pool

            ctx.dist_backend = get_worker_pool(cfg)
        return ctx
