"""Process-level metrics registry with a Prometheus-text dump (the port's
copy of daft_tpu/profile/metrics.py).

The span tree (spans.py) is per query; this registry is the process-wide
view a serving layer scrapes: counters (monotonic totals), gauges
(last-set values) and histograms (fixed buckets, sum and count).
``METRICS.render_prometheus()`` emits the text exposition format
(``daft_tpu_torch.metrics_text()``).

``record_query_metrics`` folds one finished query's RuntimeStats into the
standard engine metrics. It runs at the end of every plan execution,
profiled or not, so the registry is always live. The metric names are the
reference's (``daft_tpu_*``), so one scrape config reads either package.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "METRICS",
           "record_query_metrics"]

# seconds-scale latency buckets (queries run ms to minutes)
DEFAULT_BUCKETS = (0.005, 0.02, 0.1, 0.5, 1.0, 5.0, 30.0, 120.0, 600.0)

_NAME_OK = set("abcdefghijklmnopqrstuvwxyz"
               "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


def _check_name(name: str) -> str:
    from ..errors import DaftValueError

    if not name or name[0].isdigit() or not set(name) <= _NAME_OK:
        raise DaftValueError(f"invalid metric name {name!r}")
    return name


class Counter:
    """Monotonic total."""

    kind = "counter"

    def __init__(self, name: str, help_text: str = ""):
        self.name = _check_name(name)
        self.help = help_text
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def render(self) -> List[str]:
        return [f"{self.name} {_fmt(self.value)}"]


class Gauge:
    """Last-set value (pool depth, ledger balance, breaker state...)."""

    kind = "gauge"

    def __init__(self, name: str, help_text: str = ""):
        self.name = _check_name(name)
        self.help = help_text
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def render(self) -> List[str]:
        return [f"{self.name} {_fmt(self.value)}"]


class Histogram:
    """Fixed-bucket histogram (cumulative counts, Prometheus semantics)."""

    kind = "histogram"

    def __init__(self, name: str, help_text: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = _check_name(name)
        self.help = help_text
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._counts = [0] * len(self.buckets)
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        with self._lock:
            self._sum += v
            self._count += 1
            for i, le in enumerate(self.buckets):
                if v <= le:
                    self._counts[i] += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def render(self) -> List[str]:
        with self._lock:
            counts, total, s = list(self._counts), self._count, self._sum
        out = []
        for le, c in zip(self.buckets, counts):
            out.append(f'{self.name}_bucket{{le="{_fmt(le)}"}} {c}')
        out.append(f'{self.name}_bucket{{le="+Inf"}} {total}')
        out.append(f"{self.name}_sum {_fmt(s)}")
        out.append(f"{self.name}_count {total}")
        return out


def _fmt(v: float) -> str:
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class MetricsRegistry:
    """Get-or-create registry; a name re-registered with a different metric
    kind is an error (two subsystems silently sharing a counter would
    corrupt both)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get(self, cls, name: str, help_text: str, **kw):
        from ..errors import DaftValueError

        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help_text, **kw)
            elif not isinstance(m, cls):
                raise DaftValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"not {cls.kind}")
            return m

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._get(Counter, name, help_text)

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._get(Gauge, name, help_text)

    def histogram(self, name: str, help_text: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help_text, buckets=buckets)

    def snapshot(self) -> Dict[str, float]:
        """Flat name -> value view (histograms expose _sum/_count)."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: Dict[str, float] = {}
        for m in metrics:
            if isinstance(m, Histogram):
                out[f"{m.name}_sum"] = m.sum
                out[f"{m.name}_count"] = m.count
            else:
                out[m.name] = m.value
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition of every registered metric."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines: List[str] = []
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.render())
        return "\n".join(lines) + ("\n" if lines else "")


METRICS = MetricsRegistry()

# RuntimeStats counter -> process counter folded per finished execution
_FOLDED_COUNTERS = {
    "spilled_partitions": "daft_tpu_spilled_partitions_total",
    "spill_write_bytes": "daft_tpu_spill_write_bytes_total",
    "spill_read_bytes": "daft_tpu_spill_read_bytes_total",
    "prefetch_hits": "daft_tpu_prefetch_hits_total",
    "prefetch_misses": "daft_tpu_prefetch_misses_total",
    "faults_injected": "daft_tpu_faults_injected_total",
    "device_breaker_trips": "daft_tpu_device_breaker_trips_total",
    "degraded_completions": "daft_tpu_degraded_completions_total",
    "deadline_expired": "daft_tpu_deadline_expired_total",
    "fused_chains": "daft_tpu_fused_chains_total",
}


def record_query_metrics(stats, wall_ns: int,
                         registry: Optional[MetricsRegistry] = None) -> None:
    """Fold one finished plan execution into the process registry. ``stats``
    is the query's RuntimeStats — cumulative across AQE stages, so only the
    DELTA since the last fold of this handle is added (the process counters
    stay monotonic without counting a multi-stage query twice)."""
    reg = registry if registry is not None else METRICS
    reg.counter("daft_tpu_queries_total",
                "plan executions completed (AQE stages count "
                "individually)").inc()
    reg.histogram("daft_tpu_query_seconds",
                  "wall time per plan execution").observe(wall_ns / 1e9)
    snap = stats.snapshot()
    counters = snap["counters"]
    prev = getattr(stats, "_metrics_folded", None) or {}
    rows_total = sum(snap["op_rows"].values())
    reg.counter("daft_tpu_io_wait_seconds_total",
                "consumer-thread blocked IO time").inc(max(
        counters.get("io_wait_ns", 0) - prev.get("io_wait_ns", 0), 0) / 1e9)
    reg.counter("daft_tpu_rows_emitted_total",
                "rows emitted by root operators").inc(max(
        rows_total - prev.get("__rows", 0), 0))
    for key, metric in _FOLDED_COUNTERS.items():
        n = counters.get(key, 0) - prev.get(key, 0)
        if n > 0:
            reg.counter(metric).inc(n)
    folded = dict(counters)
    folded["__rows"] = rows_total
    stats._metrics_folded = folded
    try:
        # the health and ledger gauges (breaker state, the ledger's balances
        # with the prefetch and async-spill bytes in flight, pool counts,
        # query-log depth) refresh at every query end: metrics_text()
        # carries memory pressure without any profiled run
        from ..obs.health import refresh_health_gauges

        refresh_health_gauges(reg)
    except Exception as e:
        # observability never fails the query it describes
        from ..obs.log import get_logger

        get_logger("obs").error("health_gauges_failed", error=repr(e))
