"""Expression-pipeline fusion (the port's copy of daft_tpu/fuse/).

- ``graph.py``: the column-level dataflow DAG of a map chain (inlining
  through upstream projections, hash-consing CSE, cross-segment carries,
  mask conjoining).
- ``compile.py``: ``FusedProgram`` (host segmented pass and one-program
  device plan), the ``FusedMapOp`` physical operator and the
  ``fuse_map_chains`` planner pass behind ``cfg.expr_fusion``.
- ``segment.py``: the plan-segment compiler that collapses project -> filter
  -> agg segments into device-resident ``DeviceSegmentOp``s behind
  ``cfg.device_residency``.
"""

from .compile import FusedMapOp, FusedProgram, compile_chain, fuse_map_chains
from .graph import FusedGraph, FuseDecline, build_fused_graph
from .segment import DeviceSegmentOp, SegmentProgram, compile_plan_segments, run_segment_async

__all__ = [
    "DeviceSegmentOp",
    "FusedGraph",
    "FusedMapOp",
    "FusedProgram",
    "FuseDecline",
    "SegmentProgram",
    "build_fused_graph",
    "compile_chain",
    "compile_plan_segments",
    "fuse_map_chains",
    "run_segment_async",
]
