"""Feedback history: what repeated plan shapes did at run time (the port's
copy of daft_tpu/adapt/history.py, without the artifact export and merge).

A bounded, thread-safe, process-level registry with two views:

- site observations (``observe``/``size``): per canonical subtree
  fingerprint (``fingerprint.canonical_site_fp``), the rows and bytes that
  flowed through that subtree, as an EWMA: join sides observed at their
  exchanges or broadcasts, an aggregate's map-side output at its shuffle.
  They seed the broadcast flips and fan-out resizes of the next plan of
  the shape;
- query profiles (``fold``): per canonical query fingerprint, the wall
  time of past runs.

``fold`` runs when a query's stream ends (``execution._rooted``), then asks
the plan cache to revalidate the entries whose decisions consulted the
sites it just updated: a shape cached with a hash join is planned again,
and flips, once history says its build side is small.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Tuple

__all__ = ["QueryHistory", "HISTORY"]

# the EWMA's weight of a new observation: one outlier run must not whipsaw
# the planner
_ALPHA = 0.5


class _SiteStats:
    __slots__ = ("rows", "bytes", "count", "last_rows", "last_bytes", "mispredicts")

    def __init__(self):
        self.rows = 0.0
        self.bytes = 0.0
        self.count = 0
        self.last_rows = 0
        self.last_bytes = 0
        self.mispredicts = 0


class QueryHistory:
    """Bounded history registry (see the module docstring)."""

    def __init__(self, max_sites: int = 4096, max_queries: int = 1024):
        self._lock = threading.Lock()
        self._sites: "OrderedDict[str, _SiteStats]" = OrderedDict()
        self._queries: "OrderedDict[str, dict]" = OrderedDict()
        self._max_sites = max_sites
        self._max_queries = max_queries
        # a monotone count of writes (the dirty marker of a later artifact leg)
        self._mutations = 0

    # ----------------------------------------------------------------- sites
    def observe(self, site_fp: str, rows: int, nbytes: int) -> None:
        with self._lock:
            st = self._sites.get(site_fp)
            if st is None:
                st = self._sites[site_fp] = _SiteStats()
                st.rows = float(rows)
                st.bytes = float(nbytes)
            else:
                st.rows = (1 - _ALPHA) * st.rows + _ALPHA * rows
                st.bytes = (1 - _ALPHA) * st.bytes + _ALPHA * nbytes
            st.count += 1
            st.last_rows = rows
            st.last_bytes = nbytes
            self._mutations += 1
            self._sites.move_to_end(site_fp)
            while len(self._sites) > self._max_sites:
                self._sites.popitem(last=False)

    def size(self, site_fp: str) -> Optional[Tuple[int, int, int]]:
        """(EWMA rows, EWMA bytes, observation count) or None."""
        with self._lock:
            st = self._sites.get(site_fp)
            if st is None:
                return None
            return int(st.rows), int(st.bytes), st.count

    def note_mispredict(self, site_fp: str) -> None:
        """A decision seeded from this site was wrong at run time (a side
        history called small arrived big). The caller also observes the true
        size, so the next plan returns to the static decision by itself;
        this keeps the event countable."""
        with self._lock:
            st = self._sites.get(site_fp)
            if st is not None:
                st.mispredicts += 1

    # --------------------------------------------------------------- queries
    def query_profile(self, canonical_fp: str) -> Optional[dict]:
        with self._lock:
            p = self._queries.get(canonical_fp)
            return dict(p) if p is not None else None

    def fold(self, canonical_fp: str, stats, rec: dict) -> None:
        """Fold one finished execution in: the site observations the tagged
        exchanges and joins accumulated (``stats.fdo_obs``) and the query's
        profile, then revalidate the plan-cache entries that depend on them.

        Only a run whose outcome is ``ok`` contributes site observations.
        The observation points record only after draining their input, but
        an errored or abandoned run is drained here and discarded all the
        same: sizes biased low by a partly consumed path must never seed a
        broadcast flip."""
        obs = stats.take_fdo_obs()
        if rec.get("outcome") != "ok":
            obs = {}
        for site_fp, (rows, nbytes) in obs.items():
            self.observe(site_fp, rows, nbytes)
        if canonical_fp and rec.get("outcome") == "ok":
            counters = rec.get("counters", {})
            prof = {"wall_s": rec.get("wall_s", 0.0),
                    "ttfr_ms": counters.get("time_to_first_row_ns", 0) / 1e6,
                    "stream_morsels": counters.get("stream_morsels", 0),
                    "backpressure_ms": counters.get("stream_backpressure_ns", 0) / 1e6,
                    "runs": 1}
            with self._lock:
                prev = self._queries.get(canonical_fp)
                if prev is not None:
                    for k in ("wall_s", "ttfr_ms", "backpressure_ms"):
                        prof[k] = (1 - _ALPHA) * prev[k] + _ALPHA * prof[k]
                    prof["stream_morsels"] = max(prev["stream_morsels"],
                                                 prof["stream_morsels"])
                    prof["runs"] = prev["runs"] + 1
                self._queries[canonical_fp] = prof
                self._mutations += 1
                self._queries.move_to_end(canonical_fp)
                while len(self._queries) > self._max_queries:
                    self._queries.popitem(last=False)
        if obs:
            # new facts may flip a decision a cached plan baked in: drop the
            # entries whose recorded expectations no longer hold
            from .plancache import PLAN_CACHE

            PLAN_CACHE.revalidate(set(obs))

    # ----------------------------------------------------------------- admin
    @property
    def mutations(self) -> int:
        with self._lock:
            return self._mutations

    def snapshot(self) -> dict:
        with self._lock:
            return {"sites": len(self._sites), "queries": len(self._queries),
                    "mispredicts": sum(s.mispredicts for s in self._sites.values())}

    def clear(self) -> None:
        """Tests only."""
        with self._lock:
            self._sites.clear()
            self._queries.clear()
            self._mutations += 1  # a clear is a change of state


HISTORY = QueryHistory()
