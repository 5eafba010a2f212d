"""Planning for repeat-shaped traffic (the port's copy of daft_tpu/adapt/).

Three legs, each behind an ``ExecutionConfig`` knob that is on by default,
each giving the same rows off, each failing open:

- ``plancache``: a bounded, thread-safe, process-level cache keyed by a
  canonical plan fingerprint (structure and schema, literals masked) that
  holds the optimized logical plan and the translated physical plan with
  its compiled fused programs and plan segments, so a repeated shape skips
  ``optimize``, ``translate`` and the fuse and segment compiles;
- ``history``/``fdo``: feedback-directed planning. The rows and bytes that
  crossed an exchange or a broadcast are recorded per plan subtree, and the
  next plan of the same shape reads them: a join side that turned out small
  flips to a broadcast join, an aggregate's exchange shrinks to the
  partitions its payload needs. A runtime mispredict demotes the cached
  plan;
- ``resultcache``: the sub-plan result cache. The partitions of a
  Project/Filter chain over a scan replay in a later query that plans the
  same prefix over the same files.

A failure of the port itself (``errors.PORT_FAILURES``) is never taken by
a fail-open catch of this package: it reaches the caller.
"""

from .fingerprint import canonical_fingerprint, canonical_site_fp
from .history import HISTORY
from .plancache import PLAN_CACHE
from .resultcache import RESULT_CACHE

__all__ = ["canonical_fingerprint", "canonical_site_fp", "HISTORY", "PLAN_CACHE",
           "RESULT_CACHE"]
