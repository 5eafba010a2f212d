"""Peer-to-peer shuffle data plane: workers host shuffle pieces, reducers
pull them directly from peers (the port's copy of
daft_tpu/dist/peerplane.py).

The star-topology DistributedRunner (dist/supervisor.py) moves every
partition payload through the driver, so driver NIC/memcpy is an
O(cluster) bottleneck. With ``cfg.peer_shuffle`` on, a hash/random
ShuffleOp instead dispatches **fanout tasks**: each source partition ships
to a worker (as its scan task when unloaded — the worker reads the file
itself), the worker runs the deterministic split and parks the pieces in
its process-local :class:`_PeerPlane` store, and only tiny piece METADATA
returns to the driver. The reduce side is a :class:`PeerPieceTask`-backed
unloaded partition carrying the piece-location map; whichever process
materializes it — a worker running the downstream map task (the true
peer-to-peer hop), or the driver for driver-side ops — pulls the pieces
over the token-authenticated crc-framed transport (dist/transport.py)
from the peers that hold them. Driver payload bytes stay flat as the
worker count grows; results are byte-identical to the star path at every
worker count (same pieces, same source order, same concat).

Robustness is the contract, not an afterthought:

- every fetch fires the ``peer.fetch`` fault site and verifies the
  piece's store-time crc32; a dead/draining peer, a severed link, or a
  corrupt payload all degrade the same way — the fetcher falls over to
  the piece's LINEAGE recipe (integrity/lineage.fanout_piece_recipe):
  re-read the scan-backed source, re-run the deterministic split, keep
  the one lost piece (``peer_refetches``). Only a piece with truncated
  lineage (loaded source, no recipe) raises DaftTransientError for the
  task-retry machinery — a typed error at worst, never a hung query;
- pieces live until the driver broadcasts the shuffle drop at query end
  (ExecutionContext.finish_query), so speculation losers and re-reads
  stay serveable; a worker draining (dist/supervisor.drain_worker) keeps
  serving pieces through its grace window, after which fetchers of its
  pieces re-source via the same recipe path.

The module-level :data:`_PLANE` is the process-wide piece store and
counter account (one per process, like the worker pool itself), surfaced by
``health()["cluster"]["peer_plane"]``. A piece is the pickled
MicroPartition: arrow tables, never a tensor staged on the card.
"""

from __future__ import annotations

import pickle
import socket
import threading
import zlib
from typing import Dict, List, NamedTuple, Optional, Tuple

from ..errors import DaftCorruptionError, DaftError, DaftTransientError
from ..obs.log import get_logger

logger = get_logger("dist.peer")

# one fetch round-trip's socket budget; a peer slower than this reads as
# dead and the recipe path owns recovery
FETCH_TIMEOUT_S = 30.0


class PieceRef(NamedTuple):
    """Location-map row for one hosted shuffle piece: where it lives
    (worker slot + piece-server address), which piece it is (shuffle id,
    reduce bucket, source sequence), and what must arrive (rows, payload
    bytes, store-time crc32 — None when integrity is off)."""

    wid: int
    host: str
    port: int
    sid: int
    bucket: int
    src: int
    rows: int
    nbytes: int
    crc: Optional[int]


class _PeerPlane:
    """Process-wide piece store + peer-plane counters (driver and worker
    alike run exactly one). Workers put fanout pieces here and the
    :class:`PieceServer` serves them; every process counts the fetches it
    performs, and pong piggybacks ship worker-side snapshots to the
    driver's health aggregation."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pieces: Dict[Tuple[int, int, int], Tuple[bytes, int]] = {}
        # the worker slot this process IS (None on the driver): fetches of
        # self-hosted pieces short-circuit the socket
        self.worker_id: Optional[int] = None
        # worker-side per-query stats hook (the worker's RuntimeStats —
        # counter bumps ride telemetry fragments back to the driver query)
        self.stats = None
        self.piece_bytes_hosted = 0
        self.pieces_stored_total = 0
        self.pieces_served_total = 0
        self.peer_bytes_served_total = 0
        self.pieces_fetched_total = 0
        self.pieces_refetched_total = 0
        self.peer_bytes_fetched_total = 0
        self.shuffles_dropped_total = 0

    def configure(self, worker_id: Optional[int], stats) -> None:
        with self._lock:
            self.worker_id = worker_id
            self.stats = stats

    def put(self, key: Tuple[int, int, int], payload: bytes,
            rows: int) -> None:
        with self._lock:
            old = self._pieces.get(key)
            if old is not None:
                # a re-dispatched fanout re-stored the same deterministic
                # piece: replace, never double-account
                self.piece_bytes_hosted -= len(old[0])
            self._pieces[key] = (payload, rows)
            self.piece_bytes_hosted += len(payload)
            self.pieces_stored_total += 1

    def get(self, key: Tuple[int, int, int],
            serving: bool = False) -> Optional[Tuple[bytes, int]]:
        with self._lock:
            hit = self._pieces.get(key)
            if hit is not None and serving:
                self.pieces_served_total += 1
                self.peer_bytes_served_total += len(hit[0])
            return hit

    def count_fetch(self, nbytes: int) -> None:
        with self._lock:
            self.pieces_fetched_total += 1
            self.peer_bytes_fetched_total += nbytes

    def count_refetch(self) -> None:
        with self._lock:
            self.pieces_refetched_total += 1

    def drop_shuffles(self, sids) -> int:
        """Drop every piece of the given shuffle ids (query-end broadcast,
        speculation-loser cleanup); returns pieces dropped."""
        sids = set(sids)
        with self._lock:
            doomed = [k for k in self._pieces if k[0] in sids]
            for k in doomed:
                payload, _ = self._pieces.pop(k)
                self.piece_bytes_hosted -= len(payload)
            self.shuffles_dropped_total += len(sids)
            return len(doomed)

    def clear(self) -> None:
        with self._lock:
            self._pieces.clear()
            self.piece_bytes_hosted = 0

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "pieces_hosted": len(self._pieces),
                "piece_bytes_hosted": self.piece_bytes_hosted,
                "pieces_stored_total": self.pieces_stored_total,
                "pieces_served_total": self.pieces_served_total,
                "peer_bytes_served_total": self.peer_bytes_served_total,
                "pieces_fetched_total": self.pieces_fetched_total,
                "pieces_refetched_total": self.pieces_refetched_total,
                "peer_bytes_fetched_total": self.peer_bytes_fetched_total,
                "shuffles_dropped_total": self.shuffles_dropped_total,
            }


_PLANE = _PeerPlane()


def plane() -> _PeerPlane:
    return _PLANE


# ---------------------------------------------------------------------------
# worker side: piece server + fanout execution
# ---------------------------------------------------------------------------

class PieceServer:
    """Worker-side piece server: a listener bound BEFORE the worker's
    hello (the supervisor learns the port from the handshake, so there is
    no window where a dispatched reduce task holds an address that was
    never bound). Each accepted connection is one peer's fetch channel:
    token-checked per request, framed/checksummed by dist/transport.py —
    the same integrity contract as the driver link. Read-only by design:
    drops and lifecycle arrive over the supervised driver channel, never
    from peers."""

    def __init__(self, token: str, checksum: bool = True):
        self.token = token
        self.checksum = checksum
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(64)
        self.port = self._listener.getsockname()[1]
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._accept_loop, name="daft-torch-peer-server", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed: server is done
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="daft-torch-peer-conn", daemon=True)
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        from .transport import TransportClosed, recv_msg, send_msg

        try:
            conn.settimeout(FETCH_TIMEOUT_S)
            while True:
                msg = recv_msg(conn)
                if msg.get("type") != "fetch" \
                        or msg.get("token") != self.token:
                    # unauthenticated or foreign frame: drop the link (the
                    # fetcher degrades through its recipe path)
                    return
                key = tuple(msg["key"])
                hit = _PLANE.get(key, serving=True)
                reply = {"type": "piece", "found": hit is not None}
                if hit is not None:
                    reply["payload"], reply["rows"] = hit
                send_msg(conn, reply, checksum=self.checksum)
        except (TransportClosed, OSError):
            pass  # peer went away mid-fetch: its recovery is not ours
        except Exception as e:
            logger.warning("peer_server_conn_failed", error=repr(e))
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        self._closed.set()
        try:
            # close() alone does not wake a thread parked in accept();
            # shutdown() does
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        if (self._thread.ident is not None
                and self._thread is not threading.current_thread()):
            self._thread.join(timeout=2.0)


def execute_fanout(part, spec: dict, exec_ctx) -> List[Tuple]:
    """Run one fanout task worker-side: deterministic split of the source
    partition, pieces parked in the process piece store, piece metadata
    (bucket, rows, payload bytes, crc) returned — the ONLY bytes that
    travel back to the driver. Empty pieces are neither stored nor
    reported: concat skips them identically on the star path."""
    n = int(spec["num"])
    sid = int(spec["sid"])
    src = int(spec["src"])
    prof = exec_ctx.stats.profiler
    sp = prof.begin("worker.fanout", part=src, kind="bg") if prof.armed \
        else None
    try:
        if spec["scheme"] == "hash":
            pieces = part.partition_by_hash(spec["by"], n)
        else:
            pieces = part.partition_by_random(n, seed=int(spec["seed"]))
        metas: List[Tuple] = []
        for i, piece in enumerate(pieces):
            rows = piece.num_rows_or_none() or 0
            if not rows:
                continue
            payload = pickle.dumps(piece,
                                   protocol=pickle.HIGHEST_PROTOCOL)
            crc = zlib.crc32(payload) if spec.get("crc") else None
            _PLANE.put((sid, i, src), payload, rows)
            metas.append((i, rows, len(payload), crc))
        return metas
    finally:
        if sp is not None:
            prof.end(sp)


# ---------------------------------------------------------------------------
# fetch side: location-map-backed scan task with lineage failover
# ---------------------------------------------------------------------------

def _fetch_over(conns: dict, ref: PieceRef, token: str,
                checksum: bool) -> Tuple[bytes, int]:
    """Pull one piece from its hosting peer (connection cached per
    address for the materialization's lifetime). Raises on any transport
    or not-found defect — the caller owns degradation."""
    from .transport import dial, recv_msg, send_msg

    if _PLANE.worker_id is not None and _PLANE.worker_id == ref.wid:
        # self-hosted piece: the "fetch" is a local store read
        hit = _PLANE.get((ref.sid, ref.bucket, ref.src), serving=True)
        if hit is None:
            raise DaftTransientError(
                f"peer piece {ref.sid}/{ref.bucket}/{ref.src} missing "
                "from the local store")
        return hit
    addr = (ref.host, ref.port)
    conn = conns.get(addr)
    if conn is None:
        conn = conns[addr] = dial(ref.host, ref.port,
                                  timeout=FETCH_TIMEOUT_S)
    send_msg(conn, {"type": "fetch", "token": token,
                    "key": (ref.sid, ref.bucket, ref.src)},
             checksum=checksum)
    reply = recv_msg(conn)
    if not reply.get("found"):
        # a stale location map: the peer restarted, drained past its
        # grace window, or the piece was dropped — transient by contract
        raise DaftTransientError(
            f"peer {ref.wid} no longer hosts piece "
            f"{ref.sid}/{ref.bucket}/{ref.src}")
    return reply["payload"], reply.get("rows", 0)


class PeerPieceTask:
    """Scan-task-shaped holder for one reduce bucket of a peer shuffle:
    an ordered location map (PieceRefs, plus inline driver-local pieces
    from fanout fallbacks) and the recovery spec that re-derives any lost
    piece from its scan-backed source. ``read_chunks()`` is the pull —
    it runs in whichever process materializes the bucket, which is what
    makes the data plane peer-to-peer."""

    def __init__(self, schema, entries: List, token: str,
                 split: Tuple, sources: Dict[int, object],
                 checksum: bool = True, stats=None):
        self.schema = schema
        # PieceRef rows and inline loaded MicroPartitions, in source order
        # — the exact order the star path's bucket concat uses
        self.entries = entries
        self.token = token
        # (by-expressions, scheme, num-buckets): with a source task this
        # reconstructs integrity/lineage.fanout_piece_recipe on demand
        self.split = split
        self.sources = sources
        self.checksum = checksum
        self._rt_stats = stats
        self.stats = None  # scan-task TableStats surface (none)
        self.rows = sum(e.rows if isinstance(e, PieceRef)
                        else (e.num_rows_or_none() or 0)
                        for e in entries)
        self.nbytes = sum(e.nbytes if isinstance(e, PieceRef)
                          else (e.size_bytes() or 0)
                          for e in entries)

    # location maps cross process boundaries (the reduce-side partition
    # ships to workers as this task): the per-query RuntimeStats handle
    # holds thread locks and must not ride along — worker-side fetch
    # counters come from the process plane instead
    def __getstate__(self):
        state = dict(self.__dict__)
        state["_rt_stats"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)

    def _stats(self):
        return self._rt_stats if self._rt_stats is not None else _PLANE.stats

    # --- ScanTask metadata surface used by MicroPartition ----------------
    @property
    def materialized_schema(self):
        return self.schema

    def num_rows(self) -> Optional[int]:
        return self.rows

    def size_bytes(self) -> Optional[int]:
        return self.nbytes

    def preferred_wids(self) -> List[int]:
        """Worker slots hosting this bucket's bytes, heaviest first — the
        dispatch-locality hint (scheduler.py): running the reduce task
        where its pieces already live turns those fetches into local
        store reads."""
        weights: Dict[int, int] = {}
        for e in self.entries:
            if isinstance(e, PieceRef):
                weights[e.wid] = weights.get(e.wid, 0) + e.nbytes
        return sorted(weights, key=lambda w: -weights[w])

    def _recompute(self, ref: PieceRef, cause: BaseException) -> List:
        """Lineage failover for one lost/corrupt piece: rebuild the exact
        fanout recipe (integrity/lineage.py) from the recovery spec and
        re-derive just this piece at the read site."""
        from ..integrity.lineage import fanout_piece_recipe

        src_task = self.sources.get(ref.src)
        if src_task is None:
            raise DaftTransientError(
                f"peer piece {ref.sid}/{ref.bucket}/{ref.src} lost "
                f"({cause!r}) and its source is not recomputable "
                "(truncated lineage)") from cause
        by, scheme, num = self.split
        stats = self._stats()
        _PLANE.count_refetch()
        if stats is not None:
            stats.bump("peer_refetches")
        logger.warning("peer_piece_recomputed", sid=ref.sid,
                       bucket=ref.bucket, src=ref.src, peer=ref.wid,
                       cause=repr(cause))
        recipe = fanout_piece_recipe(src_task, by, scheme, num, ref.src,
                                     ref.bucket)
        chunks = recipe()
        got = sum(len(t) for t in chunks)
        if got != ref.rows:
            # the recompute disagreeing with the recorded piece meta is a
            # REAL defect (nondeterministic source?), not a transient
            raise DaftError(
                f"peer piece recompute returned {got} rows, location map "
                f"recorded {ref.rows} (sid={ref.sid} bucket={ref.bucket} "
                f"src={ref.src})")
        return chunks

    def read_chunks(self) -> List:
        from .. import faults

        stats = self._stats()
        chunks: List = []
        conns: dict = {}
        try:
            for e in self.entries:
                if not isinstance(e, PieceRef):
                    chunks.extend(e.chunk_tables())
                    continue
                try:
                    faults.check("peer.fetch", stats)
                    payload, _rows = _fetch_over(conns, e, self.token,
                                                 self.checksum)
                    if e.crc is not None:
                        got = zlib.crc32(payload)
                        if got != e.crc:
                            raise DaftCorruptionError(
                                f"peer piece failed its integrity check "
                                f"(crc {got:#010x} != {e.crc:#010x}, "
                                f"sid={e.sid} bucket={e.bucket})")
                    piece = pickle.loads(payload)
                    _PLANE.count_fetch(len(payload))
                    if stats is not None:
                        stats.bump("peer_fetches")
                        stats.bump("peer_bytes_fetched", len(payload))
                    chunks.extend(piece.chunk_tables())
                except (DaftTransientError, DaftCorruptionError, OSError,
                        EOFError, pickle.UnpicklingError) as err:
                    # a dead/draining/slow peer, a severed or corrupt
                    # link, a stale location map: all the same failover —
                    # drop the cached connection (it may be the broken
                    # half) and recompute this one piece from lineage
                    stale = conns.pop((e.host, e.port), None)
                    if stale is not None:
                        try:
                            stale.close()
                        except OSError:
                            pass
                    chunks.extend(self._recompute(e, err))
        finally:
            for c in conns.values():
                try:
                    c.close()
                except OSError:
                    pass
        return chunks

    def read(self):
        from ..table import Table

        chunks = [t for t in self.read_chunks() if len(t)]
        if not chunks:
            return Table.empty(self.schema)
        if len(chunks) == 1:
            return chunks[0]
        return Table.concat(chunks)

    # head()/select on unloaded partitions route through pushdowns; reduce
    # buckets never see them in practice, but keep the surface total
    @property
    def pushdowns(self):
        from ..io.scan import Pushdowns

        return Pushdowns()

    def with_pushdowns(self, pd):
        from ..spill import _SpillSlotView

        return _SpillSlotView(self, pd)

    def __repr__(self) -> str:
        remote = sum(1 for e in self.entries if isinstance(e, PieceRef))
        return (f"PeerPieceTask(rows={self.rows}, pieces={len(self.entries)}"
                f" remote={remote})")


def is_peer_backed(part) -> bool:
    """Is this partition's materialization a peer pull? (Root outputs are
    forced local before the query's finish drops their shuffles.)"""
    if part.is_loaded():
        return False
    task = part.scan_task()
    return isinstance(getattr(task, "_task", task), PeerPieceTask)


def ensure_local(part):
    """Force a peer-backed partition local (idempotent, cheap for
    everything else): execute_plan's root stream calls this per output so
    no result partition outlives its shuffle's pieces."""
    if is_peer_backed(part):
        part.table()
    return part


def peer_preference(part):
    """Dispatch-locality hint for the supervisor: the worker slots hosting
    most of this partition's piece bytes (top two), or None when the
    partition is not peer-backed. Best-effort — any surprise shape means
    no preference, never a failed dispatch."""
    try:
        if part.is_loaded():
            return None
        task = part.scan_task()
        task = getattr(task, "_task", task)
        if not isinstance(task, PeerPieceTask):
            return None
        wids = task.preferred_wids()[:2]
        return set(wids) if wids else None
    except Exception:
        return None
