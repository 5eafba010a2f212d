"""The approximate aggregations' engine glue (the port's copy of
daft_tpu/sketch/).

``approx_count_distinct`` and ``approx_percentiles`` over several
partitions plan in two stages (physical.populate_aggregation_stages):

  stage 1  one sketch a partition and group (the ``sketch_hll`` and
           ``sketch_quantile`` kinds), a binary column;
  exchange the serialized sketches ride the ShuffleOp or GatherOp, so the
           payload is about sketch size x partitions, never the raw rows;
           on a mesh a global HLL merge is one register max across the slots
           (parallel/collectives.build_register_allmerge);
  stage 2  the sketches merge per group (``merge_sketch_hll``: the register
           max; ``merge_sketch_quantile``: the samples concatenated and
           compressed again);
  final    a projection estimates (``sketch.hll_estimate``,
           ``sketch.quantile_estimate``).

The math is in kernels/sketches.py. Here: the grouped builds, merges and
estimates over Series (hll.py, quantile.py), the register scatter on the
card (device.py, K9) and the kind registry the planner and the Table
kernels share.

Error bounds (held by the tests): an HLL estimate within 2 x 1.04/sqrt(HLL_M)
(about 1.63 % at m = 16384) of the exact count; a percentile's rank within
1/QUANTILE_CAP of the total weight of its target.
"""

from __future__ import annotations

from ..kernels.sketches import (  # noqa: F401  (the subsystem's API)
    HLL_M,
    HLL_P,
    HLL_STANDARD_ERROR,
    QUANTILE_CAP,
    estimate_from_registers,
    register_ranks,
)

#: stage-1 kinds: one serialized sketch a group
STAGE1_KINDS = frozenset({"sketch_hll", "sketch_quantile"})
#: stage-2 kinds: merge serialized sketches a group
MERGE_KINDS = frozenset({"merge_sketch_hll", "merge_sketch_quantile"})
#: every sketch-stage kind (the planner's; users write approx_*)
SKETCH_STAGE_KINDS = STAGE1_KINDS | MERGE_KINDS
#: the user-facing aggregations that decompose into sketch and merge stages
SKETCH_DECOMPOSABLE = frozenset({"approx_count_distinct", "approx_percentiles"})
