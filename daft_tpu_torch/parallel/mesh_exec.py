"""Mesh execution context: partition shuffles ride the slot exchange (the
port's copy of daft_tpu/parallel/mesh_exec.py).

The fan-out and reduce of a shuffle become one exchange
(collectives.build_exchange) over a ``Mesh`` of slots. The host keeps the
control plane: bucket assignment (the host hash kernels, so every dtype
hashes as on the host path; range buckets from the same aligned-boundary
ranking the host path uses, so a range exchange and a per-partition sort are
a global sort), capacity agreement and re-chunking the input onto the
slots.

- hash, random and range schemes ship their payload; any fan-out works:
  ``num`` < n leaves trailing slots idle, ``num`` > n packs bucket b onto
  slot b % n and ships the bucket id as an extra lane that receivers split
  their slab by;
- a grouped aggregate's stage-2 merge (``combine``) folds this process's
  rows before they cross (the hierarchical exchange's mesh leg);
- string columns ride as int32 codes into one GLOBAL sorted dictionary, the
  union of every process's distinct values; a dictionary above
  ``_STRING_DICT_CAP`` values or ``_STRING_DICT_BYTES_CAP`` bytes declines
  to the host shuffle (past that point, syncing dictionaries costs more than
  shipping the bytes). Columns that are neither device dtypes nor strings
  force the host path;
- each output partition's rows pack to the front on its slot's device and
  seed the partition's ``device_stage_cache()``, so a device op over a
  co-partitioned output (a join probe, a grouped aggregate through K1)
  stages nothing again.

Multi-process (a mesh whose slots span processes, multihost.py): process p
contributes only the partitions it owns (``owner_process``, else index %
processes), so each host reads only its share of a scan; the capacity, the
slab length, the row count and the staging outcome are agreed by
``all_gather`` before the collective; the exchanged slabs all-gather back so
that every process holds every output (the SPMD control plane goes on
identically everywhere).

The collective breaker (``DeviceHealth(kind="collective")``, one per query)
takes ``execution.DEVICE_FAILURES`` and torch.distributed's link errors
(``DistBackendError``, ``DistNetworkError``) and hands the shuffle to the
host path; every other exception (``DaftKernelError``,
``torch.AcceleratorError``, a defect) reaches the caller. Fault site:
``collective.exchange``, also the phase span of the whole exchange; its
child phase spans are the steps: ``collective.bucket`` (the control plane),
``collective.stage`` (host staging and the copies onto the slots),
``collective.scatter`` (the send slabs and the exchange),
``collective.counts`` and ``collective.unstage`` (the pack and the copy
back). No span synchronizes the card.

A global ``merge_sketch_hll`` stage (approx_count_distinct over several
partitions) merges its sketches' registers on the mesh
(``try_sketch_register_merge``: one register max over the slots,
collectives.build_register_allmerge; ``collective_sketch_merges``) behind
the same breaker, with the fault site ``collective.sketch``; a failure
leaves the merge to the host. Several processes keep the host merge, as the
reference does.

Across processes, a failed exchange or an open collective breaker takes
the host transport of dist/peer.py (``_transport_shuffle``,
``transport_shuffles``): each process contributes the partitions it owns to
one allgather over TCP and buckets the whole input as the host shuffle
does. One process falls to the host shuffle, as before. With ``gloo`` the
collective exchange works, so the transport engages only after a failure.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..errors import DaftKernelError
from ..execution import DEVICE_FAILURES, DeviceHealth, ExecutionContext, RuntimeStats
from ..kernels.device import DeviceColumn, size_bucket, stage_np, stageable_dtype, unstage
from ..micropartition import MicroPartition
from .collectives import Mesh, build_exchange, comm_device, exchange_capacity, my_rank

# global-dictionary caps for string exchange columns: above them the host
# shuffle takes over (every process agrees: the caps read all-gathered sizes)
_STRING_DICT_CAP = 1 << 18
_STRING_DICT_BYTES_CAP = 16 << 20


# what the collective breaker takes (see the module docstring)
COLLECTIVE_FAILURES = DEVICE_FAILURES + (dist.DistBackendError, dist.DistNetworkError)


def process_allgather(arr: np.ndarray) -> np.ndarray:
    """[P, *arr.shape]: every process's ``arr`` (equal shapes), by rank."""
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(comm_device())
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return np.stack([o.cpu().numpy() for o in out])


def _gather_global_dictionaries(local_dicts, multiproc: bool):
    """One sorted GLOBAL dictionary (pa.Array, large_string) per string
    column, or None when a cap trips. One process: sort the local distinct
    values. Several: every column's distinct values pack into one byte buffer
    with length and count arrays, all-gathered (one size round, three data
    rounds), and every process merges them identically (UTF-8 byte order is
    code-point order, so python's sorted and pyarrow's agree)."""
    import pyarrow as pa

    if not multiproc:
        import pyarrow.compute as pc

        out = []
        total_vals = 0
        total_bytes = 0
        for d in local_dicts:
            srt = d.take(pc.sort_indices(d)) if len(d) else d
            total_vals += len(srt)
            total_bytes += int(pc.binary_length(srt.cast(pa.large_binary()))
                               .cast(pa.int64()).sum().as_py() or 0) if len(srt) else 0
            out.append(srt)
        if total_vals > _STRING_DICT_CAP or total_bytes > _STRING_DICT_BYTES_CAP:
            return None
        return out
    enc: List[bytes] = []
    counts = []
    for d in local_dicts:
        vals = d.to_pylist()
        counts.append(len(vals))
        enc.extend(v.encode("utf-8") for v in vals)
    lens = np.array([len(b) for b in enc], dtype=np.int64)
    buf = np.frombuffer(b"".join(enc), dtype=np.uint8) if enc else np.zeros(0, np.uint8)
    sizes = process_allgather(np.array([len(buf), len(lens)], dtype=np.int64))  # [P, 2]
    if (int(sizes[:, 1].sum()) > _STRING_DICT_CAP
            or int(sizes[:, 0].sum()) > _STRING_DICT_BYTES_CAP):
        return None  # agreed everywhere: the sizes are global
    maxb = max(int(sizes[:, 0].max()), 1)
    maxn = max(int(sizes[:, 1].max()), 1)
    pb = np.zeros(maxb, np.uint8)
    pb[:len(buf)] = buf
    pl = np.full(maxn, -1, np.int64)
    pl[:len(lens)] = lens
    gb = process_allgather(pb)
    gl = process_allgather(pl)
    gc = process_allgather(np.array(counts, dtype=np.int64))
    per_col = [set() for _ in local_dicts]
    for p in range(gb.shape[0]):
        pos = item = 0
        pbuf = gb[p].tobytes()
        for cidx in range(len(local_dicts)):
            for _ in range(int(gc[p, cidx])):
                ln = int(gl[p, item])
                item += 1
                per_col[cidx].add(pbuf[pos:pos + ln].decode("utf-8"))
                pos += ln
    return [pa.array(sorted(s), type=pa.large_string()) for s in per_col]


def _stage_global_codes(series, global_dict, r: int):
    """(codes int32 [r], valid bool [r]) of a string column into the GLOBAL
    sorted dictionary (every value is in it by construction)."""
    import pyarrow as pa
    import pyarrow.compute as pc

    arr = series.to_arrow()
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    codes = pc.index_in(arr.cast(pa.large_string()), value_set=global_dict)
    vals = np.zeros(r, dtype=np.int32)
    valid = np.zeros(r, dtype=bool)
    n = len(arr)
    vals[:n] = np.asarray(pc.fill_null(codes, 0), dtype=np.int32)
    valid[:n] = np.asarray(pc.is_valid(codes), dtype=bool)
    return vals, valid


def _pack_order(sel):
    """(order, live): a received slab's positions with its selected rows
    first, in slab order, and whether each position is selected."""
    order = torch.argsort((~sel).to(torch.uint8), stable=True)
    return order, sel[order]


def _pack_slab(vals, nulls, order, live, out_rows: int):
    """A received slab's column with its selected rows packed to the front
    (``_pack_order``), on the slab's device: (values [out_rows, *trailing],
    validity [out_rows]) in the DeviceColumn layout (validity False past the
    rows)."""
    pv = vals[order]
    pn = nulls[order] & live
    r = pv.shape[0]
    if out_rows <= r:
        return pv[:out_rows], pn[:out_rows]
    pad = out_rows - r
    return (torch.cat([pv, pv.new_zeros((pad,) + tuple(pv.shape[1:]))]),
            torch.cat([pn, pn.new_zeros(pad)]))


def default_mesh(n: Optional[int] = None) -> Mesh:
    """A one-process mesh over the config's device kind: one slot per visible
    card for ``cuda`` (one slot for ``cpu``), or ``n`` slots with slot i on
    device i % count (8 slots on one card, or on the CPU)."""
    from .multihost import local_devices

    devs = local_devices()
    k = len(devs) if n is None else int(n)
    me = my_rank()
    return Mesh([(me, devs[i % len(devs)]) for i in range(k)])


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True

    def idx(d):
        return d.index if d.index is not None else torch.cuda.current_device()

    return idx(a) == idx(b)


class MeshExecutionContext(ExecutionContext):
    """An ExecutionContext whose shuffles use the slot exchange when
    eligible, behind the query's collective breaker."""

    def __init__(self, cfg, stats: Optional[RuntimeStats] = None, mesh: Optional[Mesh] = None,
                 deadline: Optional[float] = None, device_health=None,
                 collective_health=None):
        super().__init__(cfg, stats, deadline=deadline, device_health=device_health,
                         collective_health=collective_health)
        self.mesh = mesh if mesh is not None else default_mesh()
        if any(d.type == "cuda" for d in self.mesh.devices) and not torch.cuda.is_available():
            raise DaftKernelError("the mesh has CUDA slots but torch sees no CUDA device")
        # one per query (the runner builds it beside the device breaker): K
        # consecutive exchange failures trip it, and every later shuffle goes
        # to the host until the cooldown probe proves the link again
        self.collective_health = (collective_health if collective_health is not None
                                  else DeviceHealth(cfg.device_breaker_threshold,
                                                    cfg.device_breaker_cooldown_s,
                                                    kind="collective"))

    partitions_pinned = True

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    @property
    def _multiproc(self) -> bool:
        return self.mesh.multiprocess

    def scan_owner(self, idx: int) -> Optional[int]:
        """The process that reads scan task ``idx`` in a multi-process run
        (each host reads only its share); None in one process."""
        if not self._multiproc:
            return None
        return idx % dist.get_world_size()

    def foreign_owned(self, part: MicroPartition) -> bool:
        return (part.owner_process is not None and self._multiproc
                and part.owner_process != my_rank())

    def prepare_broadcast(self, part: MicroPartition, on_exprs,
                          how: str = "inner") -> MicroPartition:
        """Stage a broadcast join's build-side key once and copy it onto
        every distinct device of the mesh, so that each partition's probe
        reads the copy on its own device (``broadcast_replications``). A
        decline or one of ``DEVICE_FAILURES`` leaves the join to its usual
        path; every other exception reaches the caller."""
        if (self.cfg.use_device_kernels and self.n_devices > 1
                and how in ("inner", "left", "semi", "anti")
                and on_exprs and len(on_exprs) == 1
                and (part.num_rows_or_none() or 0) > 0):
            from ..kernels.device_join import replicate_join_key

            try:
                ok = replicate_join_key(part, on_exprs[0], self.mesh, self._device())
            except DEVICE_FAILURES:
                ok = False
            if ok:
                self.stats.bump("broadcast_replications")
        return part

    def _shard_onto_devices(self, shards: List[np.ndarray], slots: List[int]) -> List:
        """Each staged shard onto its slot's device: the per-slot list the
        exchange takes (no host-side global matrix)."""
        devs = self.mesh.devices
        return [torch.from_numpy(np.ascontiguousarray(s)).to(devs[i])
                for s, i in zip(shards, slots)]

    def try_device_shuffle(self, parts: List[MicroPartition], by, num: int, scheme: str,
                           descending=None, nulls_first=None, boundaries=None,
                           combine=None) -> Optional[List[MicroPartition]]:
        """The shuffle over the mesh; None when ineligible (scheme, payload
        dtype, empty input, no boundaries, a string dictionary over its cap,
        a staging decline), when the collective breaker is open
        (``degraded_shuffles``) or when the exchange failed with one of
        ``COLLECTIVE_FAILURES`` (counted against the breaker and as
        ``device_attempt_failures``): the caller's host shuffle takes over."""
        from .. import faults

        if not self.collective_health.allow(self.stats):
            self.stats.bump("degraded_shuffles")
            return self._try_transport_shuffle(parts, by, num, scheme, descending,
                                               nulls_first, boundaries)
        try:
            faults.check("collective.exchange", self.stats)
            # staging, exchange and unstage are one phase on the timeline
            with self.stats.profiler.span("collective.exchange", kind="phase"):
                out = self._device_shuffle_impl(parts, by, num, scheme, descending,
                                                nulls_first, boundaries, combine)
        except COLLECTIVE_FAILURES:
            self.stats.bump("device_attempt_failures")
            self.collective_health.record_failure(self.stats)
            # several processes still have dist/peer.py's host transport;
            # one process falls to the host shuffle
            return self._try_transport_shuffle(parts, by, num, scheme, descending,
                                               nulls_first, boundaries)
        if out is None:
            self.collective_health.release_probe()
        else:
            self.collective_health.record_success(self.stats)
        return out

    def _try_transport_shuffle(self, parts, by, num, scheme, descending, nulls_first,
                               boundaries) -> Optional[List[MicroPartition]]:
        """The transport exchange of a multi-process mesh, or None (the host
        shuffle takes over): one process, or the transport itself failed.
        Never raises."""
        if not self._multiproc:
            return None
        try:
            return self._transport_shuffle(parts, by, num, scheme, descending,
                                           nulls_first, boundaries)
        except Exception as e:
            from ..obs.log import get_logger

            get_logger("mesh").warning("transport_shuffle_failed", error=repr(e))
            return None

    def _transport_shuffle(self, parts, by, num, scheme, descending, nulls_first,
                           boundaries) -> Optional[List[MicroPartition]]:
        """The exchange over dist/peer.py's allgather: each process reads only
        the partitions it owns (the same rule as the collective exchange, so
        that replicated in-memory inputs count once and foreign scan
        partitions stay unread), allgathers them pickled, and every process
        rebuilds the whole input and buckets it as the host shuffle does
        (piece i of every partition, in partition order). None without a
        peer group or for a scheme it cannot serve."""
        import pickle

        from ..dist.peer import get_peer_group

        if scheme not in ("hash", "random", "range"):
            return None
        if scheme == "range" and boundaries is None:
            return None
        peer = get_peer_group()
        if peer is None:
            return None
        nproc = dist.get_world_size()
        me = my_rank()
        local = []
        sent_rows = sent_bytes = 0
        for i, p in enumerate(parts):
            owner = p.owner_process if p.owner_process is not None else i % nproc
            if owner == me:
                t = p.table()
                local.append((i, t))
                sent_rows += len(t)
                sent_bytes += t.size_bytes()
        datas = peer.allgather(pickle.dumps(local, protocol=pickle.HIGHEST_PROTOCOL))
        full = {}
        for d in datas:
            for i, t in pickle.loads(d):
                full[i] = t
        schema = parts[0].schema
        buckets: List[List[MicroPartition]] = [[] for _ in range(num)]
        for pi in range(len(parts)):
            t = full.get(pi)
            mp = MicroPartition.from_table(t) if t is not None else MicroPartition.empty(schema)
            if scheme == "hash":
                pieces = mp.partition_by_hash(by, num)
            elif scheme == "random":
                pieces = mp.partition_by_random(num, seed=pi)
            else:
                pieces = mp.partition_by_range(by, boundaries, descending, nulls_first)
            for i, piece in enumerate(pieces):
                if len(piece):
                    buckets[min(i, num - 1)].append(piece)
        self.stats.bump("transport_shuffles")
        if sent_rows:
            self.stats.bump("exchange_rows", sent_rows)
        if sent_bytes:
            self.stats.bump("exchange_bytes", sent_bytes)
        return [MicroPartition.concat(b) if b else MicroPartition.empty(schema)
                for b in buckets]

    def _seed_key_device(self, dev: torch.device) -> str:
        """The device string a staged column on ``dev`` is cached under: the
        config's device where it is the same card (the key later device ops
        look up), else the slot's own."""
        cfg_dev = torch.device(self.cfg.device)
        return str(cfg_dev) if _same_device(dev, cfg_dev) else str(dev)

    def _device_shuffle_impl(self, parts: List[MicroPartition], by, num: int, scheme: str,
                             descending=None, nulls_first=None, boundaries=None,
                             combine=None) -> Optional[List[MicroPartition]]:
        from ..context import x64_enabled
        from ..schema import Schema
        from ..table import Table, _composite_rank

        n = self.n_devices
        if scheme not in ("hash", "random", "range"):
            return None
        if scheme == "range" and boundaries is None:
            return None
        schema = parts[0].schema
        if any(not stageable_dtype(f.dtype) for f in schema):
            return None
        str_idx = [j for j, f in enumerate(schema) if f.dtype.is_string()]
        mesh = self.mesh
        devs = mesh.devices
        me = my_rank()
        multiproc = mesh.multiprocess
        chunk_slots = mesh.local_indices(me)
        if not chunk_slots:
            raise ValueError(f"process {me} holds no slot of {mesh!r}")
        prof = self.stats.profiler
        with prof.span("collective.bucket"):
            if multiproc:
                # ownership by part index over the globally consistent part
                # list: every row is contributed exactly once, and a foreign
                # unloaded scan partition is never read here
                nproc = dist.get_world_size()
                tables = [p.table() for i, p in enumerate(parts)
                          if (p.owner_process if p.owner_process is not None
                              else i % nproc) == me]
            else:
                tables = [p.table() for p in parts]
            total = sum(len(t) for t in tables)
            if not multiproc and total == 0:
                return None
            # re-chunk onto the slots this process stages
            nchunks = len(chunk_slots)
            if tables:
                merged = Table.concat(tables) if len(tables) != 1 else tables[0]
            else:
                merged = Table.empty(schema)
            precombined = 0
            if combine is not None and len(merged):
                # the hierarchical exchange's mesh leg: this process's rows
                # fold through the stage-2 merge before they cross; a fold that
                # changes the schema declines
                try:
                    folded = merged.agg(list(combine[0]), list(combine[1]))
                except Exception:
                    folded = None
                if folded is not None and folded.schema == merged.schema:
                    # counted only once the exchange succeeded (see the end)
                    precombined = len(merged) - len(folded)
                    merged = folded
                    total = len(merged)
            step = -(-total // nchunks) if total else 0
            chunks = [merged.slice(min(i * step, total), min((i + 1) * step, total))
                      for i in range(nchunks)]
            fields = list(schema)
            global_dicts = {}
            if str_idx:
                import pyarrow as pa
                import pyarrow.compute as pc

                local_dicts = []
                for j in str_idx:
                    arr = merged.get_column(fields[j].name).to_arrow()
                    if isinstance(arr, pa.ChunkedArray):
                        arr = arr.combine_chunks()
                    local_dicts.append(pc.unique(arr.drop_null()).cast(pa.large_string()))
                gds = _gather_global_dictionaries(local_dicts, multiproc)
                if gds is None:
                    return None  # a cap tripped (agreed everywhere)
                global_dicts = dict(zip(str_idx, gds))
            # the control plane: each row's destination partition, by the host
            # kernels (the host shuffle's assignment)
            k = len(by or [])
            desc = list(descending) if descending is not None else [False] * k
            nf = list(nulls_first) if nulls_first is not None else [None] * k
            part_buckets, dev_buckets = [], []
            for ci, c in enumerate(chunks):
                if scheme == "hash":
                    h = c.hash_rows(by)
                    b = (h % np.uint64(num)).astype(np.int32)
                elif scheme == "random":
                    # seeded by the GLOBAL slot: local chunk indices repeat
                    # across processes and would correlate the draws
                    rng = np.random.RandomState(chunk_slots[ci])
                    b = rng.randint(0, num, size=len(c)).astype(np.int32)
                else:
                    bnds = boundaries._columns
                    if not bnds or len(bnds[0]) == 0:
                        b = np.zeros(len(c), dtype=np.int32)
                    else:
                        keys = c.eval_expression_list(by)._columns
                        b = np.minimum(_composite_rank(keys, bnds, desc, nf),
                                       num - 1).astype(np.int32)
                part_buckets.append(b)
                dev_buckets.append((b % n).astype(np.int32) if num > n else b)
            cap = exchange_capacity(dev_buckets, [None] * len(dev_buckets), n)
            maxlen = max((len(c) for c in chunks), default=1)
            if multiproc:
                # the exchange's shape is agreed everywhere: capacity and slab
                # length are maxima over every source, and a zero GLOBAL row
                # count skips
                agreed = process_allgather(np.array([cap, maxlen, total], dtype=np.int64))
                cap = int(agreed[:, 0].max())
                maxlen = int(agreed[:, 1].max())
                if int(agreed[:, 2].sum()) == 0:
                    return None
        r = size_bucket(max(maxlen, 1))
        names = [f.name for f in schema]
        ncols = len(names)
        ship_lane = num > n  # receivers split their slab by the partition id
        with prof.span("collective.stage"):
            b_np, v_np, lane_np = [], [], []
            col_np = [[] for _ in range(ncols)]
            null_np = [[] for _ in range(ncols)]
            ok = True
            try:
                for i, c in enumerate(chunks):
                    bm = np.zeros(r, dtype=np.int32)
                    vm = np.zeros(r, dtype=bool)
                    bm[:len(c)] = dev_buckets[i]
                    vm[:len(c)] = True
                    b_np.append(bm)
                    v_np.append(vm)
                    if ship_lane:
                        lm = np.zeros(r, dtype=np.int32)
                        lm[:len(c)] = part_buckets[i]
                        lane_np.append(lm)
                    for j, name in enumerate(names):
                        if j in global_dicts:
                            vals, valid = _stage_global_codes(c.get_column(name),
                                                              global_dicts[j], r)
                        else:
                            vals, valid, _ = stage_np(c.get_column(name), r)
                        col_np[j].append(vals)
                        null_np[j].append(valid)
            except ValueError:
                # a staging decline (an int64 past int32 in the 32-bit mode, a
                # uint64 past 2**63 in the 64-bit one): the host shuffle, as
                # every other device route
                ok = False
            if multiproc:
                # staging is data-dependent and contributions are disjoint: one
                # process declining while the others go on would deadlock the
                # collective, so the outcome is agreed first
                oks = process_allgather(np.array([1 if ok else 0], dtype=np.int64))
                if int(oks.min()) == 0:
                    return None
            if not ok:
                return None
            args = [self._shard_onto_devices(b_np, chunk_slots),
                    self._shard_onto_devices(v_np, chunk_slots)]
            args += [self._shard_onto_devices(col_np[j], chunk_slots) for j in range(ncols)]
            args += [self._shard_onto_devices(null_np[j], chunk_slots) for j in range(ncols)]
            if ship_lane:
                args.append(self._shard_onto_devices(lane_np, chunk_slots))
        lane_at = 1 + 2 * ncols
        with prof.span("collective.scatter"):
            out = build_exchange(mesh, cap)(*args)
            if multiproc:
                # every process needs every output partition (the duplicated
                # host control plane goes on), so the received slabs all-gather
                slab_of = self._allgather_slabs(out, chunk_slots)
            else:
                def slab_of(idx: int, d: int):
                    return out[idx][d]
        with prof.span("collective.counts"):
            # each slot's row counts on the slot's device: one small fetch
            cnt_t = []
            for d in range(n):
                v = slab_of(0, d).reshape(-1)
                if ship_lane:
                    lanes = torch.where(v, slab_of(lane_at, d).reshape(-1).to(torch.int64), num)
                    cnt_t.append(torch.bincount(lanes, minlength=num + 1)[:num])
                else:
                    cnt_t.append(v.sum(dtype=torch.int64).reshape(1))
            dev0 = cnt_t[0].device
            cnts = torch.stack([c.to(dev0) for c in cnt_t]).cpu().numpy()
        self.stats.bump("device_shuffles")
        x64 = x64_enabled()
        results: List[MicroPartition] = []
        with prof.span("collective.unstage"):
            for b in range(num):
                # output b lives on slot b % n (b itself when num <= n)
                d = b % n
                cnt = int(cnts[d, b]) if ship_lane else int(cnts[b, 0])
                bucket = size_bucket(max(cnt, 1))
                sel = slab_of(0, d).reshape(-1)
                if ship_lane:
                    sel = sel & (slab_of(lane_at, d).reshape(-1) == b)
                order, live = _pack_order(sel)
                series_out = []
                staged: List[DeviceColumn] = []
                for j, f in enumerate(fields):
                    slab = slab_of(1 + j, d)
                    flat = slab.reshape((-1,) + tuple(slab.shape[2:]))
                    nulls = slab_of(1 + ncols + j, d).reshape(-1)
                    pv, pn = _pack_slab(flat, nulls, order, live, bucket)
                    # string columns arrive as codes into the global
                    # dictionary: decoded here, and the seeded column hands
                    # later device string ops the sorted-dictionary shape they
                    # expect
                    dc = DeviceColumn(pv, pn, cnt, f.dtype, dictionary=global_dicts.get(j))
                    staged.append(dc)
                    series_out.append(unstage(dc).rename(f.name))
                part = MicroPartition.from_table(Table(Schema(fields), series_out))
                cache = part.device_stage_cache()
                key_dev = self._seed_key_device(devs[d])
                for f, dc in zip(fields, staged):
                    cache[(f.name, bucket, key_dev, x64)] = dc
                results.append(part)
        # the rows and bytes this process put on the exchange (after the
        # fold), counted only here, once it all succeeded: the host fallback
        # of a late failure counts them itself
        if total:
            self.stats.bump("exchange_rows", total)
            mb = merged.size_bytes()
            if mb:
                self.stats.bump("exchange_bytes", mb)
        if precombined:
            self.stats.bump("exchange_precombined_rows", precombined)
        return results

    def _allgather_slabs(self, out, chunk_slots: List[int]):
        """The received slabs of every slot on every process: each process's
        fields of its slots, packed as bytes (padded to the most slots a
        process holds), all-gathered; returns slab_of(field, slot)."""
        from .collectives import _as_bytes, _from_bytes

        mesh = self.mesh
        world = dist.get_world_size()
        cdev = comm_device()
        nf = len(out)
        meta = [(out[f][0].dtype, tuple(out[f][0].shape)) for f in range(nf)]
        per_rank = [mesh.local_indices(q) for q in range(world)]
        most = max(len(s) for s in per_rank)
        rows = [torch.cat([_as_bytes(out[f][k].to(cdev), 1) for f in range(nf)], dim=1)
                for k in range(len(chunk_slots))]
        width = rows[0].shape[1]
        mine = torch.zeros((most, width), dtype=torch.uint8, device=cdev)
        mine[:len(rows)] = torch.cat(rows, dim=0)
        got = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(got, mine)
        by_slot = {}
        for q in range(world):
            for k, s in enumerate(per_rank[q]):
                by_slot[s] = got[q][k]
        dev_of = {s: mesh.devices[s] if mesh.ranks[s] == my_rank() else cdev
                  for s in range(mesh.size)}
        cache = {}

        def slab_of(idx: int, d: int):
            key = (idx, d)
            if key not in cache:
                off = sum(int(np.prod(shape)) * torch.empty(0, dtype=dt).element_size()
                          for dt, shape in meta[:idx])
                dt, shape = meta[idx]
                w = int(np.prod(shape)) * torch.empty(0, dtype=dt).element_size()
                cache[key] = _from_bytes(by_slot[d][off:off + w].reshape(1, -1), dt,
                                         shape).to(dev_of[d])
            return cache[key]

        return slab_of

    # ------------------------------------------------------------------
    # the sketch subsystem: a global stage-2 HLL merge as one register max
    # over the slots instead of the host merge of the gathered sketches
    # ------------------------------------------------------------------

    def try_sketch_register_merge(self, regs: np.ndarray) -> Optional[np.ndarray]:
        """[k, m] uint8 HLL register rows merged into one [m] row by the
        mesh's register merge (collectives.build_register_allmerge): the
        rows fold onto the slots (row i onto slot i % n, the surplus by a
        host max first, as the reference folds them) and the slots reduce
        by a max. None when not eligible (several processes, no rows), when
        the collective breaker is open (``degraded_sketch_merges``) or when
        the merge failed with one of ``COLLECTIVE_FAILURES`` (counted
        against the breaker and as ``device_attempt_failures``): the
        caller's host merge takes over. Fault site: ``collective.sketch``."""
        from .. import faults
        from .collectives import build_register_allmerge

        n = self.n_devices
        if self._multiproc or regs.ndim != 2 or regs.shape[0] == 0:
            # a stage-2 input of several processes is local to each after
            # the gather: the merge stays within one process, as the
            # reference's does
            return None
        if not self.collective_health.allow(self.stats):
            self.stats.bump("degraded_sketch_merges")
            return None
        try:
            faults.check("collective.sketch", self.stats)
            k, m = regs.shape
            if k > n:
                pad = (-k) % n
                regs = np.concatenate([regs, np.zeros((pad, m), np.uint8)])
                regs = regs.reshape(-1, n, m).max(axis=0)
            elif k < n:
                regs = np.concatenate([regs, np.zeros((n - k, m), np.uint8)])
            rows = self._shard_onto_devices([regs[i] for i in range(n)], list(range(n)))
            out = build_register_allmerge(self.mesh, m)(rows).cpu().numpy()
        except COLLECTIVE_FAILURES:
            self.stats.bump("device_attempt_failures")
            self.collective_health.record_failure(self.stats)
            return None
        self.collective_health.record_success(self.stats)
        self.stats.bump("collective_sketch_merges")
        return out

    def _collective_merge_eligible(self, groupby, predicate) -> bool:
        # no min-rows gate: a stage-2 input holds one sketch row a partition
        # by design. Several processes decline here, before the partition
        # materializes and its sketches decode
        return (not groupby and predicate is None and self.cfg.use_device_kernels
                and not self._multiproc)

    def eval_agg(self, part, aggregations, groupby, predicate=None):
        """A global ``merge_sketch_hll`` stage (the gathered stage 2 of a
        multi-partition approx_count_distinct) merges on the mesh when
        eligible; everything else takes the base routing."""
        if self._collective_merge_eligible(groupby, predicate):
            out = self._sketch_merge_collective(part, aggregations)
            if out is not None:
                return out
        return super().eval_agg(part, aggregations, groupby, predicate=predicate)

    def eval_agg_dispatch(self, part, aggregations, groupby, predicate=None):
        """As eval_agg; the register merge resolves at once, so its resolver
        hands back the merged partition."""
        if self._collective_merge_eligible(groupby, predicate):
            out = self._sketch_merge_collective(part, aggregations)
            if out is not None:
                return lambda: out
        return super().eval_agg_dispatch(part, aggregations, groupby, predicate=predicate)

    def _sketch_merge_collective(self, part, aggregations) -> Optional[MicroPartition]:
        """The partition's ``merge_sketch_hll`` aggregations (all of them,
        else None) through the register merge, one binary sketch column
        each."""
        from ..datatypes import DataType
        from ..expressions import AggExpr, Alias
        from ..schema import Field, Schema
        from ..series import Series
        from ..sketch.hll import binary_to_registers, registers_to_binary
        from ..table import Table

        nodes = []
        for e in aggregations:
            node = e._node
            while isinstance(node, Alias):
                node = node.child
            if not (isinstance(node, AggExpr) and node.kind == "merge_sketch_hll"):
                return None
            nodes.append((e.name(), node))
        if not nodes:
            return None
        tbl = part.table()
        cols, fields = [], []
        for alias, node in nodes:
            merged = self.try_sketch_register_merge(
                binary_to_registers(node.child.evaluate(tbl)))
            if merged is None:
                return None
            cols.append(Series.from_arrow(registers_to_binary(merged[None]), alias,
                                          DataType.binary()))
            fields.append(Field(alias, DataType.binary()))
        return MicroPartition.from_table(Table(Schema(fields), cols))
