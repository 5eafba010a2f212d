"""Fused-program emission and the ``FusedMapOp`` physical operator (the
port's copy of daft_tpu/fuse/compile.py).

``compile_chain`` turns a Project/Filter op chain into a ``FusedProgram``:

- **host path** (``run_host``): one pass per partition. Per segment, scratch
  columns (cross-segment CSE carries) append to the working set, the
  segment mask compacts it, and the final projection evaluates every output
  in ONE ``eval_expression_list`` (the table-level structural memo makes the
  hash-consed shared subtrees evaluate once). No intermediate partition is
  materialized.
- **device path**: the WHOLE DAG, every mask and every output, runs as ONE
  projection program on the card (``ExecutionContext.eval_fused_dispatch``);
  the host then ANDs the mask columns and compacts once.

The planner pass ``fuse_map_chains`` (called from ``physical.translate``
behind ``cfg.expr_fusion``) replaces each maximal chain of two or more ops
with a ``FusedMapOp``. A chain that declines (``FuseDecline``, or an
expression that does not type) stays unfused. Results are byte-identical
with fusion on or off.

Left out: the ``fuse.compile`` fault site and the profiler events.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..errors import DaftError
from ..expressions import Alias, Expression, col, required_columns
from ..physical import PhysicalOp, summarize_exprs
from ..schema import Field, Schema
from .graph import MASK_PREFIX, FusedGraph, FuseDecline, build_fused_graph


class FusedProgram:
    """Executable form of a fused map chain (host plan and device plan)."""

    def __init__(self, graph: FusedGraph, out_schema: Schema):
        self.graph = graph
        self.n_masks = len(graph.device_masks)

        aug_fields = list(graph.input_schema)
        host_segments: List[Tuple[List[Expression], Optional[Expression]]] = []
        for seg in graph.segments:
            lets: List[Expression] = []
            for name, body in seg.lets:
                aug_fields.append(Field(name, body.to_field(Schema(aug_fields)).dtype))
                lets.append(Expression(Alias(body, name)))
            mask_expr = None
            if seg.mask is not None:
                mdt = seg.mask.to_field(Schema(aug_fields)).dtype
                if not (mdt.is_boolean() or mdt.is_null()):
                    raise FuseDecline(f"mask resolves to {mdt}, not bool")
                mask_expr = Expression(seg.mask)
            host_segments.append((lets, mask_expr))
        self._host_segments = host_segments

        aug = Schema(aug_fields)
        if [n for n, _ in graph.outputs] != out_schema.field_names():
            raise FuseDecline("fused outputs do not match the chain schema")
        self.output_exprs: List[Expression] = []
        for (name, node), field in zip(graph.outputs, out_schema):
            dt = node.to_field(aug).dtype
            if dt != field.dtype:
                # inlining changed type resolution (e.g. a weak literal
                # adopting a different operand dtype across a stage
                # boundary): byte-identity cannot be guaranteed
                raise FuseDecline(f"output {name!r} resolves to {dt} fused vs "
                                  f"{field.dtype} unfused")
            self.output_exprs.append(Expression(Alias(node, name)))

        # input columns the fused pass reads (dead-column elimination)
        req = set()
        for lets, mask in host_segments:
            for e in lets + ([mask] if mask is not None else []):
                req.update(required_columns(e))
        for e in self.output_exprs:
            req.update(required_columns(e))
        self.required_input_columns = req & set(graph.input_schema.field_names())

        # one-program device plan: masks first, then outputs (the pre-carry
        # roots: the device program evaluates the shared DAG itself)
        self.device_exprs = (
            [Expression(Alias(m, f"{MASK_PREFIX}{i}")) for i, m in enumerate(graph.device_masks)]
            + [Expression(Alias(node, name)) for name, node in graph.device_outputs])

    def run_host(self, table):
        """Single-pass host evaluation: segments of scratch-eval and mask
        compaction over a pruned working set, then one fused projection."""
        cols = table.column_names
        needed = [c for c in cols if c in self.required_input_columns]
        if not needed and cols:
            needed = cols[:1]  # literal-only outputs still broadcast to n
        work = table if needed == cols else table.select_columns(needed)
        for lets, mask_expr in self._host_segments:
            for let_e in lets:
                work = work.eval_expression_list([col(c) for c in work.column_names] + [let_e])
            if mask_expr is not None:
                work = work.filter([mask_expr])
        return work.eval_expression_list(self.output_exprs)

    def assemble_device(self, result_table):
        """Device program result -> output table: AND the mask columns
        (kleene, the null semantics of sequential filters) and compact the
        output columns once."""
        if not self.n_masks:
            return result_table
        mask_cols = result_table._columns[:self.n_masks]
        mask = mask_cols[0]
        for m in mask_cols[1:]:
            mask = mask & m
        out_names = result_table.column_names[self.n_masks:]
        return result_table.select_columns(out_names).filter_with_mask(mask)


def compile_chain(stages, input_schema: Schema, out_schema: Schema) -> FusedProgram:
    """stages (bottom-up ``("project", exprs) | ("filter", pred)``) ->
    FusedProgram. Raises FuseDecline when fusion is unsafe."""
    return FusedProgram(build_fused_graph(stages, input_schema), out_schema)


class FusedMapOp(PhysicalOp):
    """A maximal Project/Filter chain collapsed to one single-pass operator.

    Executes through ExecutionContext.eval_fused_dispatch (the one-program
    device path) or, when that declines, the segmented host pass.
    Byte-identical to the chain it replaced; the ``fused_chains``,
    ``fused_ops_eliminated`` and ``cse_hits`` counters record the collapse
    once per query."""

    def __init__(self, child: PhysicalOp, program: FusedProgram, schema: Schema):
        super().__init__([child], schema, child.num_partitions)
        self.program = program
        self._recorded_for = None  # the RuntimeStats of the query that recorded

    def _record(self, ctx) -> None:
        if self._recorded_for is ctx.stats:
            return
        self._recorded_for = ctx.stats
        record_fusion(ctx.stats, self.program.graph)

    def map_partition_dispatch(self, part, ctx):
        self._record(ctx)
        return ctx.eval_fused_dispatch(part, self.program)

    def map_partition_declined(self, part, ctx):
        # dispatch already proved this partition device-ineligible
        return ctx._eval_fused_host(part, self.program)

    def execute(self, inputs, ctx):
        self._record(ctx)
        return self._map_execute(inputs, ctx)

    def describe(self) -> str:
        g = self.program.graph
        segs = []
        for lets, mask in self.program._host_segments:
            if lets:
                segs.append("let " + summarize_exprs(lets))
            if mask is not None:
                segs.append("where " + summarize_exprs([mask]))
        tail = (" | " + " | ".join(segs)) if segs else ""
        n_exprs = (len(self.program.output_exprs) + self.program.n_masks
                   + sum(len(lets) for lets, _ in self.program._host_segments))
        return (f"FusedMap[{g.n_ops} ops, {n_exprs} exprs, {g.cse_hits} cse]: "
                f"{summarize_exprs(self.program.output_exprs)}{tail}")


def record_fusion(stats, g: FusedGraph) -> None:
    """The chain-level counters of one fused chain, once per query."""
    stats.bump("fused_chains")
    stats.bump("fused_ops_eliminated", g.n_ops - 1)
    if g.cse_hits:
        stats.bump("cse_hits", g.cse_hits)


def fuse_map_chains(op: PhysicalOp, cfg) -> PhysicalOp:
    """Planner pass: collapse every maximal chain of >= 2 map-class ops
    (ProjectOp/FilterOp) into one FusedMapOp. Runs inside
    physical.translate AFTER fuse_for_device, so a filter feeding an
    aggregation has already folded into FusedFilterAggregateOp and only the
    residual map chain fuses here."""
    from ..physical import FilterOp, ProjectOp

    if isinstance(op, (ProjectOp, FilterOp)):
        chain = [op]
        cur = op
        while isinstance(cur.children[0], (ProjectOp, FilterOp)):
            cur = cur.children[0]
            chain.append(cur)
        base = fuse_map_chains(cur.children[0], cfg)
        cur.children[0] = base
        if len(chain) >= 2:
            fused = _try_fuse_chain(chain, base)
            if fused is not None:
                return fused
        return op
    for i, c in enumerate(op.children):
        op.children[i] = fuse_map_chains(c, cfg)
    return op


def _try_fuse_chain(chain: List[PhysicalOp], base: PhysicalOp) -> Optional[FusedMapOp]:
    """Compile one top-down chain, or None to keep it unfused when fusion
    declines. Any other exception is a defect and propagates."""
    from ..physical import ProjectOp

    stages = [("project", list(op.exprs)) if isinstance(op, ProjectOp)
              else ("filter", op.predicate) for op in reversed(chain)]
    try:
        program = compile_chain(stages, base.schema, chain[0].schema)
    except (DaftError, ValueError, KeyError):
        return None  # FuseDecline, or an expression that does not type fused
    return FusedMapOp(base, program, chain[0].schema)
