"""Always-on flight recorder: the query log, slow and failed query capture,
the engine health snapshot, live query progress and structured JSON-lines
logging (the port's copy of daft_tpu/obs/).

The profiler (profile/) is opt-in and per query; this package is its
always-on counterpart: a bounded record of every query that ran
(``querylog``), diagnostics bundles for the slow and failed ones
(``capture``), one health view of breakers, ledger, pools and running
queries (``health``, ``cluster``) and an engine-wide structured logger whose
records carry the query id across threads (``log``). Everything here is
built from data the stats already collect; the steady-state cost is
guard-tested as the DISARMED profiler's is.
"""

from .health import engine_health, refresh_health_gauges, validate_health
from .log import EngineLogger, current_query_id, get_logger, query_context
from .querylog import (QUERY_LOG, RECORD_SCHEMA_VERSION, QueryLog, build_record,
                       plan_signature, validate_record)

__all__ = [
    "EngineLogger",
    "get_logger",
    "current_query_id",
    "query_context",
    "QueryLog",
    "QUERY_LOG",
    "RECORD_SCHEMA_VERSION",
    "build_record",
    "plan_signature",
    "validate_record",
    "engine_health",
    "refresh_health_gauges",
    "validate_health",
]
