"""Adaptive query execution: stage-wise planning with real sizes (the port's
copy of daft_tpu/adaptive.py).

The plan is cut at materialization boundaries: each stage is executed, and
the rest of the plan is optimized again with the materialized stage in
place as an in-memory source that carries its real rows and bytes. The
planner's decisions that read size estimates then see the truth:

- the join strategy (broadcast or hash) reads the sides' actual sizes: a
  filter or aggregate that shrank a side under the broadcast threshold
  broadcasts it, though the static estimate was too large;
- a stage under 1 MiB collapses to one partition, and a repartition over a
  source of known size shrinks to ``ceil(bytes /
  shuffle_target_partition_bytes)`` partitions (``adapt_shuffle_counts``).

Stages are join children whose subtree can change cardinality (Filter,
Aggregate, Limit, Join, Distinct, Sample): a bare source's size is already
as good as materializing it.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

from .logical import (Aggregate, Distinct, Filter, InMemorySource, Join, Limit, LogicalPlan,
                      Project, Repartition, Sample)
from .micropartition import MicroPartition
from .optimizer import optimize

_SHRINKING = (Filter, Aggregate, Limit, Join, Distinct, Sample)
_MAX_STAGES = 32  # a safety valve; each stage strictly shrinks the plan


def _subtree_can_shrink(p: LogicalPlan) -> bool:
    if isinstance(p, _SHRINKING):
        return True
    return any(_subtree_can_shrink(c) for c in p.children())


def _find_stage(p: LogicalPlan) -> Optional[LogicalPlan]:
    """The deepest join child worth materializing before the join is
    planned (the child, not the join): deepest first, so that inner joins
    resolve before the joins above them read their sizes."""
    for c in p.children():
        found = _find_stage(c)
        if found is not None:
            return found
    if isinstance(p, Join) and p.strategy is None:
        for side in (p.right, p.left):  # right first: the usual build side
            if not isinstance(side, InMemorySource) and _subtree_can_shrink(side):
                return side
    return None


def _substitute(p: LogicalPlan, target: LogicalPlan, repl: LogicalPlan) -> LogicalPlan:
    if p is target:
        return repl
    kids = p.children()
    if not kids:
        return p
    new_kids = [_substitute(c, target, repl) for c in kids]
    if all(a is b for a, b in zip(kids, new_kids)):
        return p
    return p.with_children(new_kids)


def _known_subtree_size(p: LogicalPlan) -> Optional[int]:
    """The exact bytes of a subtree whose cardinality is known: a
    materialized in-memory source, under size-keeping Projects (a Project
    keeps the row count; its bytes are taken as the source's)."""
    if isinstance(p, InMemorySource):
        total = 0
        for part in p.partitions:
            s = part.size_bytes()
            if s is None:
                return None
            total += s
        return total
    if isinstance(p, Project):
        return _known_subtree_size(p.input)
    return None


def adapt_shuffle_counts(plan: LogicalPlan, cfg, stats=None) -> LogicalPlan:
    """Shrink the fan-out of a repartition whose input size is known to
    ceil(bytes / shuffle_target_partition_bytes); shrink-only, so a user's
    explicit count is never exceeded (``aqe_shuffle_resizes``)."""
    kids = plan.children()
    if kids:
        new_kids = [adapt_shuffle_counts(c, cfg, stats) for c in kids]
        if any(a is not b for a, b in zip(kids, new_kids)):
            plan = plan.with_children(new_kids)
    if (isinstance(plan, Repartition) and plan.scheme != "into"
            and plan.num and plan.num > 1):
        size = _known_subtree_size(plan.input)
        if size is not None:
            target = max(int(cfg.shuffle_target_partition_bytes), 1)
            ideal = max(1, -(-size // target))
            if ideal < plan.num:
                if stats is not None:
                    stats.bump("aqe_shuffle_resizes")
                return Repartition(plan.input, plan.scheme, ideal, plan.by, plan.descending)
    return plan


class AdaptivePlanner:
    """Runs a logical plan stage by stage, optimizing again between stages
    (``aqe_stages`` counts the stages)."""

    def __init__(self, execute_subplan, stats=None, cfg=None):
        # execute_subplan: an optimized LogicalPlan -> Iterator[MicroPartition]
        # (the runner's plain path)
        self._execute = execute_subplan
        self._stats = stats
        self._cfg = cfg
        self.stage_history: List[Tuple[int, int]] = []  # (rows, bytes) per stage

    def _post_optimize(self, plan: LogicalPlan) -> LogicalPlan:
        plan = optimize(plan)
        if self._cfg is not None:
            plan = adapt_shuffle_counts(plan, self._cfg, self._stats)
        return plan

    def run(self, plan: LogicalPlan) -> Iterator[MicroPartition]:
        plan = self._post_optimize(plan)
        for _ in range(_MAX_STAGES):
            stage = _find_stage(plan)
            if stage is None:
                break
            parts = list(self._execute(stage))
            rows = sum(len(p) for p in parts)
            size = sum(p.size_bytes() or 0 for p in parts)
            self.stage_history.append((rows, size))
            if self._stats is not None:
                self._stats.bump("aqe_stages")
            # a tiny stage collapses to one partition, so that the shuffles
            # above it (keyed on the partition count) go away
            if len(parts) > 1 and size < (1 << 20):
                parts = [MicroPartition.concat(parts)]
            plan = _substitute(plan, stage, InMemorySource(stage.schema, parts))
            plan = self._post_optimize(plan)
        return self._execute(plan)
