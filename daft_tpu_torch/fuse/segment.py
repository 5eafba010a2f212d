"""Plan-segment compiler: project -> filter -> agg segments stay on the card
(the port's copy of daft_tpu/fuse/segment.py).

``compile_plan_segments`` (run by ``physical.translate`` after
``fuse_for_device`` and ``fuse_map_chains``, behind ``cfg.device_residency``)
finds each Aggregate (plain or filter-fused) whose child is a fused map
chain or a single Project/Filter, and collapses it into one
``DeviceSegmentOp``. At run time the segment executes as a resident
pipeline (``run_segment_async``):

- ONE host-to-device stage at segment entry (the map program's input
  columns, reused from the partition's stage cache);
- the map program's outputs, every mask lane and every intermediate column
  the aggregation reads, stay on the card and feed the fused aggregation
  program directly, with the mask conjunction as the aggregation predicate
  (and, with ``use_deep_fusion_kernel``, as K2's predicate);
- ONE device-to-host fetch at segment exit (the aggregated partials).

The map -> aggregate handoff that the staged plan round-trips through Arrow
does not happen (``device_handoffs_elided``).

A **decline** sends a partition to the retained staged ops
(``ExecutionContext._eval_segment_staged``): a partition below
``device_min_rows`` (not counted), or a resident attempt that is ineligible
(an empty table, an ineligible column, the int64 wrap guard or the int32
overflow guard; counted as ``segment_fallbacks``). A **failure** (an
exception from staging, the map program or a kernel) propagates to the
caller: the reference's catch in its resolver and the DeviceHealth breaker
are not ported yet. Results equal the staged plan's: exactly for keys,
counts and integer sums; float sums within float32 rounding, because the
staged plan rounds derived float64 columns to float32 at another point.

Left out: buffer donation (torch has none), the ``fuse.segment`` fault site,
the plan cache and the profiler spans. A multi-partition input gathers
before its aggregate, so a segment forms over a single partition.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

from ..datatypes import DataType
from ..errors import DaftError
from ..expressions import Alias, BinaryOp, Column, Expression
from ..micropartition import MicroPartition
from ..physical import AggregateOp, FilterOp, FusedFilterAggregateOp, PhysicalOp, ProjectOp
from ..schema import Field, Schema
from .compile import FusedMapOp, FusedProgram, compile_chain, record_fusion
from .graph import MASK_PREFIX

# process-level counters (RuntimeStats is per query)
_PROC_LOCK = threading.Lock()
_PROC_COUNTERS = {
    "resident_segments": 0,
    "handoffs_elided": 0,
    "segment_fallbacks": 0,
    "segment_compiles": 0,
    "hbm_resident_bytes_high_water": 0,
}


def _proc_bump(key: str, n: int = 1) -> None:
    with _PROC_LOCK:
        _PROC_COUNTERS[key] += n


def _proc_max(key: str, n: int) -> None:
    with _PROC_LOCK:
        _PROC_COUNTERS[key] = max(_PROC_COUNTERS[key], n)


def process_counters() -> dict:
    """Snapshot of the process-wide residency counters."""
    with _PROC_LOCK:
        return dict(_PROC_COUNTERS)


def _peel(node):
    while isinstance(node, Alias):
        node = node.child
    return node


class SegmentProgram:
    """Everything the resident runtime needs, planned once at translate:

    - ``seg_exprs``: the pruned device map program (mask aliases and only
      the intermediate columns the aggregation reads);
    - ``inter_schema``: the schema those outputs form (mask lanes as bool
      fields), which the aggregation's predicate and children normalize
      against;
    - ``specs``/``child_nodes``/``pred_node``/``kinds``/``modes``: the
      planned aggregation, the mask conjunction folded into the predicate;
    - ``gb_inputs``: group keys remapped to the INPUT table's columns. Group
      codes compute over the unfiltered input (rows stay aligned with the
      mask lanes); the pruning output restores the filtered first-occurrence
      group order, as the staged FusedFilterAggregate does."""

    __slots__ = ("seg_exprs", "inter_schema", "specs", "child_nodes", "pred_node",
                 "input_names", "kinds", "modes", "gb_inputs", "has_groupby", "n_masks")

    def __init__(self, seg_exprs, inter_schema, specs, child_nodes, pred_node, input_names,
                 kinds, modes, gb_inputs, n_masks):
        self.seg_exprs = seg_exprs
        self.inter_schema = inter_schema
        self.specs = specs
        self.child_nodes = tuple(child_nodes)
        self.pred_node = pred_node
        self.input_names = tuple(input_names)
        self.kinds = tuple(kinds)
        self.modes = tuple(modes)
        self.gb_inputs = list(gb_inputs)
        self.has_groupby = bool(gb_inputs)
        self.n_masks = n_masks


def _map_program_for(child: PhysicalOp) -> Optional[FusedProgram]:
    """The device map program of the segment's map stage: a FusedMapOp
    carries one; a lone Project/Filter compiles through ``compile_chain``."""
    if isinstance(child, FusedMapOp):
        return child.program
    base = child.children[0]
    if isinstance(child, ProjectOp):
        stages: List[Tuple] = [("project", list(child.exprs))]
    elif isinstance(child, FilterOp):
        stages = [("filter", child.predicate)]
    else:
        return None
    return compile_chain(stages, base.schema, child.schema)


def _try_compile_segment(op, child) -> Optional[SegmentProgram]:
    """One segment compile, or None to keep the staged ops when the segment
    declines. Any other exception is a defect and propagates."""
    from ..kernels.device import device_required_columns, normalize_and_check
    from ..kernels.device_agg import _ExprView, _plan_agg_specs

    try:
        program = _map_program_for(child)
    except (DaftError, ValueError, KeyError):
        return None  # FuseDecline, or an expression that does not type fused
    if program is None:
        return None
    input_schema = child.children[0].schema
    if normalize_and_check(program.device_exprs, input_schema) is None:
        return None

    # the intermediate schema: mask lanes first (bool), then the chain's outputs
    inter_schema = Schema([Field(f"{MASK_PREFIX}{i}", DataType.bool())
                           for i in range(program.n_masks)]
                          + [Field(f.name, f.dtype) for f in child.schema])

    # group keys must be bare passthroughs of input columns: codes are
    # computed over the UNFILTERED input table
    out_nodes = dict(program.graph.device_outputs)
    gb_inputs: List[Expression] = []
    for e in getattr(op, "groupby", None) or []:
        node = _peel(e._node)
        if not isinstance(node, Column):
            return None
        mapped = out_nodes.get(node.cname)
        if mapped is None or not isinstance(_peel(mapped), Column):
            return None
        gb_inputs.append(Expression(Alias(Column(_peel(mapped).cname), e._node.name())))

    # the mask conjunction (and a fused filter's predicate) becomes the
    # aggregation predicate
    pred = None
    for i in range(program.n_masks):
        m = Column(f"{MASK_PREFIX}{i}")
        pred = m if pred is None else BinaryOp("&", pred, m)
    if isinstance(op, FusedFilterAggregateOp):
        pnode = op.predicate._node
        pred = pnode if pred is None else BinaryOp("&", pred, pnode)

    planned = _plan_agg_specs(list(op.aggregations), inter_schema,
                              predicate=_ExprView(pred) if pred is not None else None)
    if planned is None:
        return None
    specs, child_nodes, pred_nodes = planned
    pred_node = pred_nodes[0] if pred_nodes else None

    # the aggregation env holds only the map program's outputs: no string
    # dictionaries reach it, so string intermediates decline
    check_nodes = list(child_nodes) + ([pred_node] if pred_node is not None else [])
    needed = sorted(device_required_columns(check_nodes, inter_schema))
    if not needed or any(inter_schema[nm].dtype.is_string() for nm in needed):
        return None
    seg_exprs = [e for e in program.device_exprs if e.name() in set(needed)]
    return SegmentProgram(seg_exprs, inter_schema, specs, child_nodes, pred_node, needed,
                          tuple(s[1] for s in specs), tuple(s[3] for s in specs), gb_inputs,
                          program.n_masks)


def compile_plan_segments(op: PhysicalOp, cfg, stats=None) -> PhysicalOp:
    """Planner pass: collapse each eligible Aggregate-over-map-chain into one
    DeviceSegmentOp. ``segment_compiles`` counts the compiles."""
    for i, c in enumerate(op.children):
        op.children[i] = compile_plan_segments(c, cfg, stats)
    if isinstance(op, AggregateOp):  # FusedFilterAggregateOp included
        child = op.children[0]
        if isinstance(child, (FusedMapOp, ProjectOp, FilterOp)):
            prog = _try_compile_segment(op, child)
            if prog is not None:
                if stats is not None:
                    stats.bump("segment_compiles")
                _proc_bump("segment_compiles")
                return DeviceSegmentOp(child, op, prog)
    return op


class DeviceSegmentOp(PhysicalOp):
    """A project -> filter -> agg plan segment compiled for device residency.
    Executes the resident pipeline when the partition is device-eligible and
    the retained staged ops (``map_op`` then ``agg_op``) otherwise."""

    def __init__(self, map_op: PhysicalOp, agg_op: PhysicalOp, program: SegmentProgram):
        super().__init__([map_op.children[0]], agg_op.schema, map_op.children[0].num_partitions)
        self.map_op = map_op
        self.agg_op = agg_op
        self.program = program
        self._recorded_for = None  # RuntimeStats of the query that recorded fusion
        self._resident_for = None  # ... and residency

    def _record(self, ctx) -> None:
        """Once per query: the fusion counters the staged plan would have
        bumped, so counters read the same with residency on or off."""
        if self._recorded_for is ctx.stats:
            return
        self._recorded_for = ctx.stats
        if isinstance(self.map_op, FusedMapOp):
            record_fusion(ctx.stats, self.map_op.program.graph)

    def _record_resident(self, ctx) -> None:
        """Once per query, on the first resident execution."""
        if self._resident_for is ctx.stats:
            return
        self._resident_for = ctx.stats
        ctx.stats.bump("device_resident_segments")
        _proc_bump("resident_segments")

    def map_partition_dispatch(self, part, ctx):
        self._record(ctx)
        return ctx.eval_segment_dispatch(part, self)

    def map_partition_declined(self, part, ctx):
        # dispatch found the partition device-ineligible: plain routing to
        # the staged ops, not a degradation
        return ctx._eval_segment_staged(part, self, degraded=False)

    def staged_map(self, part, ctx):
        """The staged map stage, without recording the fusion counters again."""
        if isinstance(self.map_op, FusedMapOp):
            return ctx.eval_fused(part, self.map_op.program)
        return self.map_op.map_partition(part, ctx)

    def staged_agg(self, mid, ctx):
        return ctx.eval_agg(mid, self.agg_op.aggregations, self.agg_op.groupby or None,
                            getattr(self.agg_op, "predicate", None))

    def map_empty(self, ctx):
        # a global agg over zero partitions still yields one row
        if not self.agg_op.groupby:
            yield MicroPartition.empty(self.map_op.schema).agg(self.agg_op.aggregations, None)

    def execute(self, inputs, ctx):
        self._record(ctx)
        return self._map_execute(inputs, ctx)

    def describe(self) -> str:
        p = self.program
        return (f"DeviceSegment[{len(p.seg_exprs)} resident col(s), {p.n_masks} mask(s)]: "
                f"{self.map_op.describe()} => {self.agg_op.describe()}")


def run_segment_async(table, prog: SegmentProgram, stage_cache: Optional[dict], stats=None,
                      cfg=None, device="cuda"):
    """Dispatch one partition through the resident segment pipeline: stage
    the inputs, run the map program, feed its outputs on the card straight
    into the fused aggregation program, and return a zero-arg resolver for
    the ONE result fetch. Returns None when this partition is ineligible
    (the caller takes the staged ops); an exception propagates."""
    import numpy as np
    import torch

    from ..series import Series
    from ..table import Table
    from ..kernels.device import _stage_and_run, int64_wrap_safe, size_bucket
    from ..kernels.device_agg import _compile_agg, _fetch, _finish_agg, group_codes_cached

    n = len(table)
    if n == 0:
        return None
    device = torch.device(device)
    staged = _stage_and_run(table, prog.seg_exprs, stage_cache, device)
    if staged is None:
        return None
    outs, _dts, _nodes, _dcs = staged  # the card computes from here
    env2 = {e.name(): out for e, out in zip(prog.seg_exprs, outs)}

    b = size_bucket(n)
    check_nodes = list(prog.child_nodes) + ([prog.pred_node] if prog.pred_node is not None else [])
    # the wrap guard over the INTERMEDIATE env (no stage cache: these lanes
    # are fresh compute and must not share keys with same-named inputs)
    if not int64_wrap_safe(check_nodes, prog.inter_schema, env2, None, b):
        return None

    codes_dev, uniq, num_groups = group_codes_cached(table, prog.gb_inputs, stage_cache, n, b,
                                                     device, stats)
    gbk = max(16, 1 << (num_groups - 1).bit_length())
    run = _compile_agg(prog.child_nodes, prog.pred_node, prog.inter_schema, prog.input_names,
                       prog.kinds, prog.modes, gbk, bool(cfg.use_segment_sums_kernel),
                       bool(cfg.use_deep_fusion_kernel))

    nkey = ("nrows", n, str(device))
    n_dev = stage_cache.get(nkey) if stage_cache is not None else None
    if n_dev is None:
        n_dev = torch.tensor(n, dtype=torch.int32, device=device)
        if stage_cache is not None:
            stage_cache[nkey] = n_dev

    hbm = sum(int(v.nbytes) + int(m.nbytes) for v, m in env2.values())
    if stats is not None:
        stats.bump_max("hbm_resident_bytes_high_water", hbm)
    _proc_max("hbm_resident_bytes_high_water", hbm)

    outs_dev = run(env2, codes_dev, n_dev, n)  # the card computes from here

    def resolve():
        got = _fetch(outs_dev)
        out_cols = list(uniq._columns) if uniq is not None else []
        out_fields = list(uniq.schema) if uniq is not None else []
        for (alias, kind, agg_node, _mode), out in zip(prog.specs, got[:len(prog.specs)]):
            expected_dt = agg_node.to_field(prog.inter_schema).dtype
            merged = _finish_agg(kind, out, num_groups, expected_dt, n)
            if merged is None:
                return None  # overflow guard tripped: the staged path recomputes
            out_cols.append(merged.rename(alias))
            out_fields.append(Field(alias, expected_dt))
        result = Table(Schema(out_fields), out_cols)
        if prog.pred_node is not None and prog.has_groupby:
            # prune filtered-away groups; order survivors like the host path
            # (first occurrence within the filtered rows)
            sel_cnt, first_idx = (a[:num_groups] for a in got[-1])
            surv = np.nonzero(sel_cnt > 0)[0]
            order = surv[np.argsort(first_idx[surv], kind="stable")]
            if len(order) != num_groups or (order != np.arange(num_groups)).any():
                import pyarrow as pa

                result = result.take(Series.from_arrow(pa.array(order.astype(np.uint64)), "idx"))
        return result

    return resolve
