"""Structured query profiler: span tree, typed events, machine-readable
QueryProfile artifacts and a process-level metrics registry (the port's
copy of daft_tpu/profile/).

Three layers:

- ``spans``    the per-query :class:`Profiler`: op spans with phase
  sub-timings, cross-thread attribution through capture()/activate(),
  typed events, bounded buffers. Disarmed by default (a no-op that
  allocates nothing).
- ``export``   :class:`QueryProfile`, the stable JSON artifact
  (``df.collect(profile=...)``, ``daft_tpu_torch.last_profile()``), per-op
  rollups, the critical path, schema validation.
- ``metrics``  process-wide counters, gauges and histograms with a
  Prometheus-text dump (``daft_tpu_torch.metrics_text()``).

The chrome trace (``daft_tpu_torch.tracing``) is rendered from the same
span tree: one writer, re-armed per query.
"""

from .export import SCHEMA_VERSION, QueryProfile, build_profile, validate_profile
from .metrics import (METRICS, Counter, Gauge, Histogram, MetricsRegistry,
                      record_query_metrics)
from .spans import DISARMED, Profiler, Span

__all__ = [
    "SCHEMA_VERSION", "QueryProfile", "build_profile", "validate_profile",
    "METRICS", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "record_query_metrics", "DISARMED", "Profiler", "Span",
]
