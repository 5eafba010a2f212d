"""The exchange behind every mesh shuffle (K12), as torch code on the slots'
devices (the port's copy of daft_tpu/parallel/collectives.py).

A mesh is an ordered list of slots, each a (process rank, torch.device)
pair (``Mesh``). Each source slot scatters its rows into per-destination
send slabs and one exchange moves every (source, destination) slab: between
two slots of one process a tensor copy (an index when both sit on one
device), between processes ``torch.distributed.all_to_all_single`` over the
cluster's group (``nccl`` for CUDA slots, ``gloo`` for CPU slots), all
columns packed into one byte buffer.

The exchange is capacity-padded, as the reference's: rows scatter into
``[n, capacity]`` send slabs with a validity mask, ``capacity`` is agreed on
the host from exact bucket counts (``exchange_capacity``) and rounded up to a
power of two. A received slab's rows sit in the reference's positions bit
for bit: a row's slab position is its rank within its destination bucket
after a stable sort by destination, rows beyond the capacity and invalid
rows are dropped.

``build_exchange_groupby_sum`` fuses the exchange with a per-destination
segment sum: float sums go through the deterministic scatter-sums kernel
(kernels/scatter_sums.py; float32, or float64 in the 64-bit mode), counts
are exact integers. No hand-written kernel stands behind the exchange
itself: every op keeps the contract, and no Pallas kernel lies behind K12.

``build_register_allmerge`` is the sketch subsystem's global merge: the
slots' HLL register rows reduce by an elementwise max (a stack and an
``amax`` on the card in one process, an ``all_gather`` and a max across
processes). A max is exact and order-free, so the merged registers equal
the host merge's.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

MIN_CAPACITY = 128


def my_rank() -> int:
    """This process's rank in the cluster (0 without one)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Mesh:
    """An ordered list of slots, each a (process rank, torch.device) pair;
    slot i holds partition i's share of an exchange."""

    def __init__(self, slots: Sequence[Tuple[int, object]]):
        if not slots:
            raise ValueError("a mesh needs at least one slot")
        self.slots = tuple((int(r), torch.device(d)) for r, d in slots)

    @property
    def size(self) -> int:
        return len(self.slots)

    @property
    def devices(self) -> List[torch.device]:
        return [d for _, d in self.slots]

    @property
    def ranks(self) -> List[int]:
        return [r for r, _ in self.slots]

    def local_indices(self, rank: Optional[int] = None) -> List[int]:
        """The slots of process ``rank`` (default: this one), in mesh order."""
        rank = my_rank() if rank is None else rank
        return [i for i, (r, _) in enumerate(self.slots) if r == rank]

    @property
    def multiprocess(self) -> bool:
        return len(set(self.ranks)) > 1

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.slots == other.slots

    def __hash__(self) -> int:
        return hash(self.slots)

    def __repr__(self) -> str:
        return f"Mesh({[f'{r}:{d}' for r, d in self.slots]})"


def _scatter_to_slabs(bucket, valid, cols, n: int, capacity: int):
    """One source slot's send side: route each row to its destination slab.

    Rows sort stably by destination; a row's slab position is its rank within
    its bucket. Invalid rows go to a virtual overflow bucket n, and they and
    the rows beyond ``capacity`` land in one spare slot past the slabs, which
    is cut off (the reference's mode="drop"). Returns (send_valid [n, capacity]
    bool, [slab [n, capacity, *trailing] per column])."""
    dev = bucket.device
    r = bucket.shape[0]
    b = torch.where(valid, bucket.to(torch.int32), n).to(torch.int32)
    order = torch.argsort(b, stable=True)
    sb = b[order]
    pos = torch.arange(r, device=dev, dtype=torch.int64) - torch.searchsorted(sb, sb)
    keep = (sb < n) & (pos < capacity)
    spare = n * capacity
    idx = torch.where(keep, sb.to(torch.int64) * capacity + pos, spare)
    send_valid = torch.zeros(spare + 1, dtype=torch.bool, device=dev)
    send_valid[idx] = keep
    slabs = []
    for c in cols:
        trailing = tuple(c.shape[1:])
        slab = torch.zeros((spare + 1,) + trailing, dtype=c.dtype, device=dev)
        slab[idx] = c[order]
        slabs.append(slab[:spare].view((n, capacity) + trailing))
    return send_valid[:spare].view(n, capacity), slabs


def exchange_capacity(buckets: Sequence[np.ndarray], valids: Sequence[Optional[np.ndarray]],
                      n_dev: int) -> int:
    """The most rows any (source, destination) pair exchanges, rounded up to a
    power of two of at least MIN_CAPACITY."""
    worst = 0
    for b, v in zip(buckets, valids):
        bb = b[v] if v is not None else b
        if bb.size:
            worst = max(worst, int(np.bincount(bb, minlength=n_dev).max()))
    cap = MIN_CAPACITY
    while cap < worst:
        cap <<= 1
    return cap


def comm_device() -> torch.device:
    """The device the cluster's collectives run on: the current card under
    ``nccl``, the CPU under ``gloo``."""
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _as_bytes(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` (leading dim ``rows``) as a [rows, k] uint8 view of its bytes."""
    x = x.contiguous().reshape(rows, -1)
    return x.view(torch.uint8) if x.dtype != torch.uint8 else x


def _from_bytes(b: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    b = b.contiguous()
    return (b if dtype == torch.uint8 else b.view(dtype)).reshape(shape)


def exchange_slabs(mesh: Mesh, sends: List[List[torch.Tensor]]) -> List[List[torch.Tensor]]:
    """Move every (source, destination) slab. ``sends[k]`` holds the fields of
    this process's k-th slot (each [n, capacity, ...] on that slot's device);
    returns, per local destination slot, its fields as [n sources, capacity,
    ...] on that slot's device, sources in mesh order."""
    n = mesh.size
    local = mesh.local_indices()
    nf = len(sends[0]) if sends else 0
    if not mesh.multiprocess:
        devs = mesh.devices
        if len(set(devs)) == 1:
            # one device: one stack and one transpose, destinations are views
            out_f = [torch.stack([s[f] for s in sends]).transpose(0, 1).contiguous()
                     for f in range(nf)]
            return [[out_f[f][d] for f in range(nf)] for d in range(n)]
        return [[torch.stack([s[f][d].to(devs[d]) for s in sends]) for f in range(nf)]
                for d in range(n)]
    return _exchange_multiprocess(mesh, sends, local)


def _exchange_multiprocess(mesh: Mesh, sends, local: List[int]):
    """The cross-process leg: every field of every (local source, destination)
    slab packs into one byte buffer, and one ``all_to_all_single`` moves it."""
    import torch.distributed as dist

    world = dist.get_world_size()
    me = my_rank()
    per_rank = [mesh.local_indices(q) for q in range(world)]
    cdev = comm_device()
    meta = [(t.dtype, tuple(t.shape[1:])) for t in sends[0]] if sends else []
    nl = len(local)
    if not nl:
        raise ValueError(f"process {me} holds no slot of {mesh!r}")
    # block (q, d, s): the slab local source s sends to destination d of rank q
    blocks = []
    for q in range(world):
        for d in per_rank[q]:
            for s in sends:
                blocks.append(torch.cat([_as_bytes(f[d].to(cdev), 1) for f in s], dim=1))
    row_bytes = blocks[0].shape[1]
    inp = torch.cat(blocks, dim=0)
    in_splits = [len(per_rank[q]) * nl for q in range(world)]
    out_splits = [nl * len(per_rank[q]) for q in range(world)]
    out = torch.empty((sum(out_splits), row_bytes), dtype=torch.uint8, device=cdev)
    dist.all_to_all_single(out, inp, out_splits, in_splits)
    # from rank q: for each local destination d, q's sources in its order
    src_order = [s for q in range(world) for s in per_rank[q]]
    perm = torch.as_tensor(np.argsort(np.asarray(src_order), kind="stable"))
    chunks = torch.split(out, out_splits, dim=0)
    result = []
    for di, d in enumerate(local):
        dev = mesh.devices[d]
        rows = torch.cat([chunks[q].view(nl, len(per_rank[q]), row_bytes)[di]
                          for q in range(world)], dim=0)[perm]
        fields, off = [], 0
        for dtype, shape in meta:
            width = int(np.prod(shape)) * torch.empty(0, dtype=dtype).element_size()
            fields.append(_from_bytes(rows[:, off:off + width], dtype,
                                      (mesh.size,) + shape).to(dev))
            off += width
        result.append(fields)
    return result


def build_exchange(mesh: Mesh, capacity: int):
    """The exchange for this mesh and capacity.

    Returned fn: (buckets, valids, *cols), each a list over this process's
    slots of [R] (cols [R, *trailing]) tensors on the slot's device ->
    (recv_valid, *recv_cols), each a list over this process's slots of
    [n, capacity] ([n, capacity, *trailing]) tensors, where recv[d][s] holds
    the rows slot s sent to slot d."""
    n = mesh.size

    def fn(buckets, valids, *cols):
        sends = []
        for k, (b, v) in enumerate(zip(buckets, valids)):
            sv, slabs = _scatter_to_slabs(b, v, [c[k] for c in cols], n, capacity)
            sends.append([sv] + slabs)
        recv = exchange_slabs(mesh, sends)
        return tuple([r[f] for r in recv] for f in range(1 + len(cols)))

    return fn


def shard_to_mesh(arr: np.ndarray, mesh: Mesh) -> List[torch.Tensor]:
    """Row i of a [n, ...] host array onto slot i's device, for this
    process's slots."""
    return [torch.from_numpy(np.ascontiguousarray(arr[i])).to(mesh.devices[i])
            for i in mesh.local_indices()]


def build_exchange_groupby_sum(mesh: Mesh, capacity: int, num_segments: int):
    """The hash exchange of (codes, values) fused with a per-destination
    segment sum.

    fn(buckets, valids, codes, values), each a list over this process's slots
    of [R] tensors -> (sums, counts), each a list over this process's slots of
    [num_segments] tensors. ``codes`` are global group codes and ``buckets``
    must equal ``codes % n``, so that a group's rows all land on one slot:
    slot d's row is authoritative for the codes it owns. Float sums run the
    deterministic scatter-sums kernel on the card (its plain version on the
    CPU), integer sums an exact ``index_add_``; counts are exact int32."""
    n = mesh.size
    g = num_segments

    def fn(buckets, valids, codes, values):
        from ..kernels.scatter_sums import scatter_sum_kahan

        sends = []
        for k, (b, v) in enumerate(zip(buckets, valids)):
            sv, (sc, sx) = _scatter_to_slabs(b, v, [codes[k], values[k]], n, capacity)
            sends.append([sv, sc, sx])
        sums, cnts = [], []
        for rv, rc, rx in exchange_slabs(mesh, sends):
            rv, rc, rx = rv.reshape(-1), rc.reshape(-1), rx.reshape(-1)
            seg = torch.where(rv, rc.to(torch.int32), g).to(torch.int32)
            contrib = torch.where(rv, rx, torch.zeros_like(rx))
            if rx.is_floating_point():
                # the kernel's rows: a power of two of at least 128 (the
                # received n * capacity rows padded with rows that add nowhere)
                rows = 1 << max(7, (seg.shape[0] - 1).bit_length())
                pad = rows - seg.shape[0]
                if pad:
                    seg = torch.cat([seg, seg.new_full((pad,), g)])
                    contrib = torch.cat([contrib, contrib.new_zeros(pad)])
                sums.append(scatter_sum_kahan(contrib, seg, g))
            else:
                acc = torch.zeros(g + 1, dtype=contrib.dtype, device=contrib.device)
                sums.append(acc.index_add_(0, seg.to(torch.int64), contrib)[:g])
            cnts.append(torch.bincount(seg.to(torch.int64), minlength=g + 1)[:g]
                        .to(torch.int32))
        return sums, cnts

    return fn


# ---------------------------------------------------------------------------
# the sketch register merge: the global stage 2 of an approx_count_distinct
# as one elementwise max of the slots' HLL register rows
# ---------------------------------------------------------------------------

#: register merges launched on a CUDA device (under _MERGE_LOCK)
REGISTER_MERGE_LAUNCHES = 0
_MERGE_LOCK = threading.Lock()


def build_register_allmerge(mesh: Mesh, m: int):
    """The register merge for this mesh and register width.

    Returned fn: (rows), a list over this process's slots of [m] uint8
    tensors, each on its slot's device -> the [m] uint8 elementwise max of
    every slot's row, on this process's first slot's device. Within one
    process the rows stack on that device and reduce by a max; across
    processes each process's max is all-gathered over the cluster's group
    and reduced again, so every process holds the same row."""
    import torch.distributed as dist

    home = mesh.devices[mesh.local_indices()[0]]

    def fn(rows: List[torch.Tensor]) -> torch.Tensor:
        global REGISTER_MERGE_LAUNCHES
        if any(tuple(r.shape) != (m,) for r in rows):
            raise ValueError(f"register rows must be [{m}]")
        merged = torch.stack([r.to(home) for r in rows]).amax(dim=0)
        if mesh.multiprocess:
            cdev = comm_device()
            mine = merged.to(cdev)
            every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
            dist.all_gather(every, mine)
            merged = torch.stack(every).amax(dim=0).to(home)
        if home.type == "cuda":
            with _MERGE_LOCK:
                REGISTER_MERGE_LAUNCHES += 1
        return merged

    return fn
