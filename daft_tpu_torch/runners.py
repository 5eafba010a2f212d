"""Runners: plan a query and execute it (the port's copy of the part of
daft_tpu/runners.py this slice runs).

Planning is the reference's cold path: ``optimize``, then ``translate``
(which fuses). Left out of this slice: the plan and result caches,
feedback-directed planning, adaptive execution, and the mesh and
distributed runners.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

from .context import get_context
from .execution import ExecutionContext, RuntimeStats, execute_plan
from .logical import LogicalPlan
from .micropartition import MicroPartition
from .schema import Schema


class PartitionSet:
    """Materialized result: an ordered list of partitions + schema."""

    def __init__(self, schema: Schema, partitions: List[MicroPartition]):
        self.schema = schema
        self.partitions = partitions

    def __len__(self) -> int:
        return sum(len(p) for p in self.partitions)

    def to_micropartition(self) -> MicroPartition:
        if not self.partitions:
            return MicroPartition.empty(self.schema)
        if len(self.partitions) == 1:
            return self.partitions[0]
        return MicroPartition.concat(self.partitions)

    def to_table(self):
        return self.to_micropartition().table().cast_to_schema(self.schema)


class NativeRunner:
    """Single-process runner: optimize, translate, then execute
    sequentially."""

    name = "native"

    def run(self, plan: LogicalPlan, stats: Optional[RuntimeStats] = None) -> PartitionSet:
        return PartitionSet(plan.schema, list(self.run_iter(plan, stats)))

    def run_iter(self, plan: LogicalPlan,
                 stats: Optional[RuntimeStats] = None) -> Iterator[MicroPartition]:
        from .optimizer import optimize
        from .physical import translate

        ctx = ExecutionContext(get_context().execution_config, stats or RuntimeStats())
        return execute_plan(translate(optimize(plan), ctx.cfg, ctx.stats), ctx)
