"""The port's peer-to-peer shuffle plane and elastic pool
(daft_tpu_torch/dist/peerplane.py, dist/supervisor.py) held against the
reference's on the CPU: the cases of tests/test_peer_plane.py through the
port, at ``device="cpu"``.

- The identity matrix over scan-backed data: the rows of every plan shape
  at 2 and 3 workers, with ``peer_shuffle`` on and off, equal NativeRunner's
  byte for byte and the reference's.
- The peer path engaged (``peer_fetches``) and the driver's payload bytes
  below the star path's; exactly-once on a clean run.
- The fault sites: ``peer.fetch`` recovers through lineage
  (``peer_refetches``), ``worker.drain`` degrades to the kill path.
- A piece-hosting worker SIGKILLed mid-query and a graceful drain mid-query
  leave the rows unchanged; the elastic pool grows under demand and drains
  back to its floor.
- The location map (a stale, a corrupt and an unrecomputable piece) and the
  plane's accounting, as units, against the reference's plane.
- The health sections and gauges of the peer plane.
"""

import json
import os
import pickle
import signal
import threading
import time
import zlib

import pytest

import daft_tpu
import daft_tpu_torch as dtt
from daft_tpu_torch import col, faults
from daft_tpu_torch.context import get_context, set_execution_config
from daft_tpu_torch.dist import supervisor as sup
from daft_tpu_torch.dist.peerplane import (PeerPieceTask, PieceRef, PieceServer, _PeerPlane,
                                           peer_preference, plane)
from daft_tpu_torch.errors import DaftTransientError


@pytest.fixture(autouse=True)
def _reset():
    ctx = get_context()
    cfg_before, runner_name = ctx.execution_config, ctx._runner_name
    faults.disarm()
    yield
    faults.disarm()
    ctx.execution_config = cfg_before
    ctx.set_runner(runner_name)


@pytest.fixture(scope="module", autouse=True)
def _module_teardown():
    yield
    sup.shutdown_worker_pool()
    assert sup.live_worker_process_count() == 0


@pytest.fixture(scope="module")
def pq_glob(tmp_path_factory):
    """Scan-backed data: a partition fans out on a worker only when its
    source is re-readable (the recomputability rule)."""
    import pyarrow as pa
    import pyarrow.parquet as papq

    root = tmp_path_factory.mktemp("peerdata")
    n = 3000
    for i in range(4):
        lo = i * n
        papq.write_table(pa.table({"a": list(range(lo, lo + n)),
                                   "b": [v % 13 for v in range(lo, lo + n)],
                                   "g": [v % 5 for v in range(lo, lo + n)]}),
                         str(root / f"f{i}.parquet"))
    return str(root / "*.parquet")


def _shapes(pkg, pat):
    c = pkg.col
    df = pkg.read_parquet(pat)
    other = pkg.from_pydict({"b": list(range(13)), "w": [i * 10 for i in range(13)]})
    return {
        "hash_groupby": (df.repartition(5, "b").groupby("b")
                         .agg(c("a").sum().alias("s"), c("a").count().alias("c")).sort("b")),
        "random_filter": (df.repartition(4).where(c("a") % 7 == 0)
                          .select(c("a"), c("b")).sort("a")),
        "join": df.repartition(3, "b").join(other, on="b").select(c("a"), c("w")).sort("a"),
        "two_stage": (df.repartition(6, "g").groupby("g").agg(c("a").sum().alias("sg"))
                      .repartition(2, "g").sort("g")),
        "mixed_range": df.sort("a", desc=True).select(c("a"), c("g")),
        "distinct": df.select(c("b"), c("g")).distinct().sort("b"),
    }


def _dist_cfg(**kw):
    set_execution_config(**{"device": "cpu", "enable_result_cache": False,
                            "scan_tasks_min_size_bytes": 0, **kw})


def _rows(d: dict) -> list:
    return sorted(zip(*d.values()), key=lambda r: tuple((v is None, repr(v)) for v in r))


@pytest.fixture(scope="module")
def reference_rows(pq_glob):
    """The reference's rows of every shape (its NativeRunner), once."""
    from daft_tpu.context import get_context as ref_ctx
    from daft_tpu.context import set_execution_config as ref_set

    saved = ref_ctx().execution_config
    try:
        ref_set(enable_result_cache=False, scan_tasks_min_size_bytes=0)
        return {k: q.collect().to_pydict() for k, q in _shapes(daft_tpu, pq_glob).items()}
    finally:
        ref_ctx().execution_config = saved


@pytest.fixture(scope="module")
def local_rows(pq_glob):
    """The port's NativeRunner results of every shape, once."""
    ctx = get_context()
    saved = ctx.execution_config
    try:
        _dist_cfg()
        return {k: q.collect().to_arrow() for k, q in _shapes(dtt, pq_glob).items()}
    finally:
        ctx.execution_config = saved


class TestByteIdentityMatrix:
    def test_matrix_across_workers_knob_and_shapes(self, pq_glob, local_rows, reference_rows):
        for name, tbl in local_rows.items():
            assert _rows(tbl.to_pydict()) == _rows(reference_rows[name]), name
        for workers, p2p in ((2, True), (3, True), (2, False)):
            sup.shutdown_worker_pool()
            _dist_cfg(distributed_workers=workers, peer_shuffle=p2p)
            got = {k: q.collect().to_arrow() for k, q in _shapes(dtt, pq_glob).items()}
            for name, tbl in local_rows.items():
                assert got[name].equals(tbl), (workers, p2p, name)
        sup.shutdown_worker_pool()

    def test_peer_path_engaged_and_driver_bytes_drop(self, pq_glob):
        sup.shutdown_worker_pool()
        _dist_cfg(distributed_workers=2)
        res = _shapes(dtt, pq_glob)["hash_groupby"].collect()
        c = res.stats.snapshot()["counters"]
        assert c.get("peer_fetches", 0) >= 1, c
        assert res.last_query_record()["events"].get("peer_fetches", 0) >= 1
        p2p_bytes = c.get("dist_driver_bytes", 0)
        # the knob off: the same plan, no peer fetch, the payloads through
        # the driver
        _dist_cfg(distributed_workers=2, peer_shuffle=False)
        c2 = _shapes(dtt, pq_glob)["hash_groupby"].collect().stats.snapshot()["counters"]
        assert c2.get("peer_fetches", 0) == 0, c2
        assert c2.get("dist_driver_bytes", 0) > p2p_bytes
        sup.shutdown_worker_pool()

    def test_exactly_once_on_a_clean_run(self, pq_glob):
        sup.shutdown_worker_pool()
        # speculation off: a duplicate of a task slowed by the host's load
        # is a dispatch no completion answers
        _dist_cfg(distributed_workers=2, speculative_execution=False)
        res = _shapes(dtt, pq_glob)["hash_groupby"].collect()
        # nothing failed: every piece pulled once, none re-derived
        assert res.stats.snapshot()["counters"].get("peer_refetches", 0) == 0
        snap = sup.get_worker_pool(get_context().execution_config).snapshot()
        assert snap["tasks_dispatched_total"] == snap["tasks_completed_total"]
        sup.shutdown_worker_pool()


class TestFaultSites:
    def test_sites_registered(self):
        from daft_tpu import faults as ref_faults

        for site in ("peer.fetch", "worker.drain"):
            assert site in faults.SITES and site in ref_faults.SITES

    def test_peer_fetch_fault_recovers_through_lineage(self, pq_glob, local_rows):
        sup.shutdown_worker_pool()
        # the plans bind at the workers' spawn (ENV_FAULT_SPEC): the pulls
        # happen at the workers' read sites
        os.environ[faults.ENV_FAULT_SPEC] = json.dumps(
            {"site": "peer.fetch", "mode": "rate", "rate": 0.4, "seed": 7})
        t0 = time.monotonic()
        try:
            _dist_cfg(distributed_workers=2)
            res = _shapes(dtt, pq_glob)["hash_groupby"].collect()
        finally:
            os.environ.pop(faults.ENV_FAULT_SPEC, None)
        assert time.monotonic() - t0 < 90, "the peer-fetch recovery hung"
        assert res.to_arrow().equals(local_rows["hash_groupby"])
        assert res.last_query_record()["events"].get("peer_refetches", 0) >= 1
        assert res.stats.snapshot()["counters"].get("peer_refetches", 0) >= 1
        sup.shutdown_worker_pool()

    def test_drain_fault_degrades_to_kill_never_hang(self):
        sup.shutdown_worker_pool()
        _dist_cfg(distributed_workers=2, worker_drain_grace_s=0.2)
        _ = dtt.from_pydict({"a": [1]}).select(col("a")).collect()
        pool = sup.get_worker_pool(get_context().execution_config)
        wid = sorted(pool.worker_pids())[0]
        losses_before = pool.snapshot()["worker_losses_total"]
        faults.arm("worker.drain", "always")
        t0 = time.monotonic()
        try:
            ok = pool.drain_worker(wid)
        finally:
            faults.disarm()
        assert ok is False
        assert time.monotonic() - t0 < 30, "the faulted drain hung"
        # the slot was killed, not drained: a loss, never a graceful exit
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and \
                pool.snapshot()["worker_losses_total"] <= losses_before:
            time.sleep(0.05)
        snap = pool.snapshot()
        assert snap["worker_losses_total"] > losses_before, snap
        assert snap["workers_drained_total"] == 0
        res = dtt.from_pydict({"a": list(range(2000))}).repartition(3) \
            .select((col("a") + 1).alias("c")).collect()
        assert sorted(res.to_pydict()["c"]) == [v + 1 for v in range(2000)]
        sup.shutdown_worker_pool()


class TestPeerDeathAndDrain:
    def test_sigkill_peer_mid_query_byte_identical(self, pq_glob, local_rows):
        sup.shutdown_worker_pool()
        _dist_cfg(distributed_workers=2)
        _ = dtt.from_pydict({"a": [1]}).select(col("a")).collect()
        pool = sup.get_worker_pool(get_context().execution_config)
        killed = []

        def killer():
            # a piece-hosting peer dies shortly into the query: whatever phase
            # it lands in, the query completes through re-dispatch and lineage
            time.sleep(0.05)
            pids = pool.worker_pids()
            if pids:
                wid = sorted(pids)[-1]
                try:
                    os.kill(pids[wid], signal.SIGKILL)
                    killed.append(pids[wid])
                except OSError:
                    pass

        t = threading.Thread(target=killer)
        t.start()
        res = _shapes(dtt, pq_glob)["hash_groupby"].collect()
        t.join(timeout=30)
        assert res.to_arrow().equals(local_rows["hash_groupby"])
        assert killed, "the killer found no live worker"
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and pool.snapshot()["worker_losses_total"] < 1:
            time.sleep(0.05)
        assert pool.snapshot()["worker_losses_total"] >= 1
        sup.shutdown_worker_pool()

    def test_drain_while_serving_byte_identical(self, pq_glob, local_rows):
        sup.shutdown_worker_pool()
        _dist_cfg(distributed_workers=2, worker_drain_grace_s=0.3, worker_drain_timeout_s=8)
        _ = dtt.from_pydict({"a": [1]}).select(col("a")).collect()
        pool = sup.get_worker_pool(get_context().execution_config)
        wid = sorted(pool.worker_pids())[0]
        drained = []

        def _drain():
            time.sleep(0.05)
            drained.append(pool.drain_worker(wid))

        t = threading.Thread(target=_drain)
        t.start()
        res = _shapes(dtt, pq_glob)["hash_groupby"].collect()
        t.join(timeout=30)
        assert res.to_arrow().equals(local_rows["hash_groupby"])
        assert drained == [True], drained
        snap = pool.snapshot()
        assert snap["workers_drained_total"] >= 1 and snap["elastic"]["workers_drained_total"] >= 1
        assert snap["worker_losses_total"] == 0, snap  # a drain is never a loss
        assert _shapes(dtt, pq_glob)["hash_groupby"].collect().to_arrow().equals(
            local_rows["hash_groupby"])
        sup.shutdown_worker_pool()


class TestElasticPool:
    def test_scale_up_under_demand_then_drain_at_idle(self, pq_glob, local_rows):
        sup.shutdown_worker_pool()
        _dist_cfg(distributed_workers=1, distributed_workers_min=1,
                  distributed_workers_max=3, elastic_scale_interval_s=0.1,
                  elastic_idle_scale_down_s=0.6, worker_heartbeat_interval_s=0.1,
                  worker_drain_grace_s=0.1, worker_drain_timeout_s=5)
        results = []

        def _run():
            results.append(_shapes(dtt, pq_glob)["hash_groupby"].collect().to_arrow())

        _ = dtt.from_pydict({"a": [1]}).select(col("a")).collect()
        pool = sup.get_worker_pool(get_context().execution_config)
        assert pool.snapshot()["elastic"]["enabled"] == 1
        threads = [threading.Thread(target=_run) for _ in range(3)]
        for t in threads:
            t.start()
        # concurrent demand grows the fleet above its floor (scale_ups_total
        # is sticky: the poll cannot miss a growth between snapshots)
        grew = False
        deadline = time.monotonic() + 40
        while time.monotonic() < deadline and not grew:
            grew = pool.snapshot()["elastic"]["scale_ups_total"] >= 1
            time.sleep(0.05)
        for t in threads:
            t.join(timeout=90)
        assert grew, pool.snapshot()["elastic"]
        assert len(results) == 3
        for r in results:
            assert r.equals(local_rows["hash_groupby"])
        # sustained idleness drains the fleet back to its floor, never below
        # and never as a loss
        shrunk = False
        deadline = time.monotonic() + 45
        while time.monotonic() < deadline and not shrunk:
            snap = pool.snapshot()
            shrunk = snap["elastic"]["scale_downs_total"] >= 1 and snap["workers_alive"] == 1
            time.sleep(0.1)
        assert shrunk, pool.snapshot()["elastic"]
        snap = pool.snapshot()
        assert snap["elastic"]["workers_min"] == 1 and snap["elastic"]["workers_max"] == 3
        assert snap["workers_drained_total"] >= 1
        assert snap["worker_losses_total"] == 0, snap
        assert _shapes(dtt, pq_glob)["hash_groupby"].collect().to_arrow().equals(
            local_rows["hash_groupby"])
        sup.shutdown_worker_pool()


class _SrcTask:
    """A minimal re-readable scan-task surface over an in-test table."""

    def __init__(self, tbl):
        self._tbl = tbl
        self.schema = tbl.schema
        self.stats = None

    @property
    def materialized_schema(self):
        return self._tbl.schema

    def num_rows(self):
        return len(self._tbl)

    def size_bytes(self):
        return self._tbl.size_bytes()

    def read(self):
        return self._tbl

    def read_chunks(self):
        return [self._tbl]


_SID = 987_654  # far above any pool-issued shuffle id


class TestLocationMapUnit:
    @pytest.fixture()
    def server(self):
        srv = PieceServer("tok")
        srv.start()
        yield srv
        srv.close()
        plane().drop_shuffles([_SID, _SID + 1])

    def _hosted_piece(self):
        """Bucket 1 of a seeded 3-way random split of a re-readable source,
        stored in the process plane as execute_fanout stores it; returns it
        beside the reference's bucket 1 of the same split."""
        from daft_tpu.micropartition import MicroPartition as RefMP
        from daft_tpu.table import Table as RefTable
        from daft_tpu_torch.micropartition import MicroPartition
        from daft_tpu_torch.table import Table

        data = {"a": list(range(1200)), "b": [i % 9 for i in range(1200)]}
        task = _SrcTask(Table.from_pydict(data))
        piece = MicroPartition.from_scan_task(task).partition_by_random(3, seed=0)[1]
        ref_piece = RefMP.from_pydict(data).partition_by_random(3, seed=0)[1]
        assert piece.to_pydict() == ref_piece.to_pydict()
        payload = pickle.dumps(piece, protocol=pickle.HIGHEST_PROTOCOL)
        rows = piece.num_rows_or_none() or 0
        plane().put((_SID, 1, 0), payload, rows)
        del RefTable
        return task, piece.table(), payload, rows

    def _ref(self, server, payload, rows, sid=_SID, crc=None):
        return PieceRef(wid=99, host="127.0.0.1", port=server.port, sid=sid, bucket=1, src=0,
                        rows=rows, nbytes=len(payload), crc=crc)

    def test_fresh_map_serves_the_piece(self, server):
        task, expect, payload, rows = self._hosted_piece()
        before = plane().snapshot()
        ref = self._ref(server, payload, rows, crc=zlib.crc32(payload))
        out = PeerPieceTask(task.schema, [ref], "tok", ([], "random", 3), {0: task}).read()
        assert out.to_pydict() == expect.to_pydict()
        after = plane().snapshot()
        assert after["pieces_fetched_total"] == before["pieces_fetched_total"] + 1
        assert after["pieces_served_total"] == before["pieces_served_total"] + 1
        assert after["pieces_refetched_total"] == before["pieces_refetched_total"]

    def test_stale_map_recomputes_from_lineage(self, server):
        task, expect, payload, rows = self._hosted_piece()
        before = plane().snapshot()
        # the map names a shuffle the peer no longer hosts: recomputed, the
        # same rows
        stale = self._ref(server, payload, rows, sid=_SID + 1)
        out = PeerPieceTask(task.schema, [stale], "tok", ([], "random", 3), {0: task}).read()
        assert out.to_pydict() == expect.to_pydict()
        after = plane().snapshot()
        assert after["pieces_refetched_total"] == before["pieces_refetched_total"] + 1
        # a failed pull is not a fetch
        assert after["pieces_fetched_total"] == before["pieces_fetched_total"]

    def test_corrupt_payload_recomputes_from_lineage(self, server):
        task, expect, payload, rows = self._hosted_piece()
        before = plane().snapshot()
        bad = self._ref(server, payload, rows, crc=zlib.crc32(payload) ^ 0xFFFFFFFF)
        out = PeerPieceTask(task.schema, [bad], "tok", ([], "random", 3), {0: task}).read()
        assert out.to_pydict() == expect.to_pydict()
        after = plane().snapshot()
        assert after["pieces_refetched_total"] == before["pieces_refetched_total"] + 1

    def test_truncated_lineage_raises_typed_transient(self, server):
        task, _, payload, rows = self._hosted_piece()
        stale = self._ref(server, payload, rows, sid=_SID + 1)
        pt = PeerPieceTask(task.schema, [stale], "tok", ([], "random", 3), {})
        with pytest.raises(DaftTransientError, match="truncated lineage"):
            pt.read()

    def test_foreign_token_reads_as_a_dead_peer(self, server):
        task, expect, payload, rows = self._hosted_piece()
        before = plane().snapshot()
        ref = self._ref(server, payload, rows)
        out = PeerPieceTask(task.schema, [ref], "not-the-token", ([], "random", 3),
                            {0: task}).read()
        assert out.to_pydict() == expect.to_pydict()
        assert plane().snapshot()["pieces_refetched_total"] == \
            before["pieces_refetched_total"] + 1

    def test_preferred_wids_rank_by_hosted_bytes(self):
        from daft_tpu_torch.micropartition import MicroPartition
        from daft_tpu_torch.table import Table

        schema = Table.from_pydict({"a": [1]}).schema
        refs = [PieceRef(3, "h", 1, 1, 0, 0, 10, 500, None),
                PieceRef(1, "h", 1, 1, 0, 1, 10, 2000, None),
                PieceRef(1, "h", 1, 1, 0, 2, 10, 1500, None)]
        pt = PeerPieceTask(schema, refs, "t", ([], "random", 4), {})
        assert pt.preferred_wids() == [1, 3]
        assert peer_preference(MicroPartition.from_scan_task(pt)) == {1, 3}
        # a loaded partition carries no hint
        assert peer_preference(MicroPartition.from_pydict({"a": [1]})) is None


class TestPlaneAccounting:
    def _steps(self, p):
        p.put((1, 0, 0), b"abcd", 2)
        p.put((1, 0, 0), b"abcdef", 2)  # a re-dispatched fanout re-stores
        out = [p.snapshot()]
        p.put((1, 1, 0), b"xy", 1)
        hit = p.get((1, 0, 0), serving=True)
        out.append((hit, p.snapshot()))
        out.append((p.get((9, 9, 9), serving=True), p.snapshot()["pieces_served_total"]))
        out.append((p.drop_shuffles([1]), p.snapshot()))
        return out

    def test_restore_never_double_counts(self):
        from daft_tpu.dist.peerplane import _PeerPlane as RefPlane

        got = self._steps(_PeerPlane())
        assert got == self._steps(RefPlane())
        first, (hit, served), (miss, n_served), (dropped, last) = got
        assert first["pieces_hosted"] == 1 and first["piece_bytes_hosted"] == 6
        assert first["pieces_stored_total"] == 2
        assert hit[0] == b"abcdef" and served["pieces_served_total"] == 1
        assert served["peer_bytes_served_total"] == 6
        assert miss is None and n_served == 1  # a miss serves nothing
        assert dropped == 2 and last["pieces_hosted"] == 0
        assert last["piece_bytes_hosted"] == 0 and last["shuffles_dropped_total"] == 1


class TestObservability:
    def test_health_sections_and_gauges(self, pq_glob):
        from daft_tpu.obs.health import validate_health as ref_validate
        from daft_tpu_torch.obs.health import validate_health

        sup.shutdown_worker_pool()
        _dist_cfg(distributed_workers=2, worker_heartbeat_interval_s=0.1)
        _ = _shapes(dtt, pq_glob)["hash_groupby"].collect()
        # the workers' piece-store snapshots ride their pongs
        pool = sup.get_worker_pool(get_context().execution_config)
        deadline = time.monotonic() + 10
        stored = 0
        while time.monotonic() < deadline and stored < 1:
            stored = pool.snapshot()["peer_plane"]["pieces_stored_total"]
            time.sleep(0.05)
        assert stored >= 1
        h = dtt.health()
        assert validate_health(h) == [] and ref_validate(h) == []
        clu = h["cluster"]
        assert clu["peer_plane"]["pieces_stored_total"] >= 1
        assert clu["elastic"]["enabled"] == 0  # the fixed-size pool
        mt = dtt.metrics_text()
        for g in ("daft_tpu_cluster_peer_pieces_served_total",
                  "daft_tpu_cluster_peer_bytes_fetched_total",
                  "daft_tpu_cluster_elastic_workers_max",
                  "daft_tpu_cluster_elastic_workers_drained_total"):
            assert g in mt
        sup.shutdown_worker_pool()
        h2 = dtt.health()
        assert validate_health(h2) == [] and ref_validate(h2) == []
        assert h2["cluster"]["peer_plane"]["pieces_hosted"] == 0
