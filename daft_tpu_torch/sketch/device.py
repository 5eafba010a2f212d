"""The HLL register scatter on the card, K9 (the port's copy of
daft_tpu/sketch/device.py).

The host keeps the control plane: the murmur hashes and the group codes, as
every shuffle has them. The data plane, the segment max of the ranks into
[num_groups * HLL_M] register slots, is one ``scatter_reduce_`` ("amax") on
the config's device into int32 slots that start at 0 (the reference's floor
at 0), cast to uint8. A max does not depend on the order of its updates, so
the registers equal the host build's bit for bit, and no hand-written kernel
is needed. On a CUDA tensor the scatter runs on the card or raises; on a CPU
tensor it is the same torch code on the host.

Callers go through ExecutionContext._device_attempt, so the scatter sits
behind the DeviceHealth breaker and the ``device.kernel`` fault site like
every other device kernel. The launch stages and dispatches; the resolver
copies the registers back and assembles the stage-1 table.

``LAUNCHES`` counts the scatters launched on a CUDA device (under
``COUNT_LOCK``: pool threads build partitions at once).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..kernels.sketches import HLL_M

#: the register-slot ceiling of the device path: past it the [G, HLL_M]
#: int32 slots stop being a sensible tenant of the card's memory
MAX_DEVICE_REGISTERS = 1 << 24

LAUNCHES = 0
COUNT_LOCK = threading.Lock()


def register_scatter(seg: torch.Tensor, rank: torch.Tensor, total: int) -> torch.Tensor:
    """K9: uint8 registers [total], each the largest ``rank`` (uint8) of
    the rows whose ``seg`` (int32 slot, group * HLL_M + register) points at
    it, 0 where none does. Runs on the tensors' device."""
    global LAUNCHES
    regs = torch.zeros(total, dtype=torch.int32, device=seg.device)
    regs.scatter_reduce_(0, seg.to(torch.int64), rank.to(torch.int32), "amax")
    if seg.device.type == "cuda":
        with COUNT_LOCK:
            LAUNCHES += 1
    return regs.to(torch.uint8)


def stage_operands(codes: np.ndarray, idx: np.ndarray, rank: np.ndarray, device):
    """K9's operands on ``device``: the int32 slots (group * HLL_M +
    register) and the uint8 ranks. The slots stage as int32, half the bytes
    of the int64 index ``scatter_reduce_`` takes; ``register_scatter`` widens
    them on the device, where it is cheaper than on the host and the bus.
    Callers hold the slots under 2**31."""
    seg = codes.astype(np.int32)
    seg *= HLL_M
    seg += idx.astype(np.int32, copy=False)
    dev = torch.device(device)
    return (torch.from_numpy(seg).to(dev),
            torch.from_numpy(np.ascontiguousarray(rank, dtype=np.uint8)).to(dev))


def aggs_all_sketch_hll(aggregations) -> bool:
    """Every aggregation is a stage-1 ``sketch_hll``. A host-side gate that
    callers check before they touch the breaker or the device fault site, so
    that a declined partition of another kind consumes no probe and shifts
    no fault plan."""
    from ..expressions import AggExpr, Alias

    if not aggregations:
        return False
    for e in aggregations:
        node = e._node
        while isinstance(node, Alias):
            node = node.child
        if not (isinstance(node, AggExpr) and node.kind == "sketch_hll"):
            return False
    return True


def hll_scatter_device_launch(codes: np.ndarray, idx: np.ndarray, rank: np.ndarray,
                              num_groups: int, device):
    """Stage the scatter's operands onto ``device`` and launch K9 without
    waiting for it; returns a zero-arg resolver giving [num_groups, HLL_M]
    uint8 rows, or None when the slots pass MAX_DEVICE_REGISTERS."""
    total = num_groups * HLL_M
    if total > MAX_DEVICE_REGISTERS or total >= (1 << 31):
        return None
    out = register_scatter(*stage_operands(codes, idx, rank, device), total)

    def resolve() -> np.ndarray:
        return out.cpu().numpy().reshape(num_groups, HLL_M)

    return resolve


def hll_build_table_device_launch(table, aggregations, groupby, device):
    """Stage 1 of ``sketch_hll`` aggregations over one partition with K9 on
    ``device``: the hashing, the group codes and the launches happen now;
    the returned resolver copies the registers back and assembles the table
    (the group keys, then one binary sketch column an aggregation). None
    when not eligible (another kind, too many groups). The group codes are
    the host path's (_group_codes), so the groups come in the same order."""
    from ..datatypes import DataType
    from ..expressions import Alias
    from ..schema import Field, Schema
    from ..series import Series
    from ..table import Table, _group_codes
    from .hll import registers_to_binary, scatter_operands

    if not aggs_all_sketch_hll(aggregations):
        return None
    nodes = []
    for e in aggregations:
        node = e._node
        while isinstance(node, Alias):
            node = node.child
        nodes.append((e.name(), node))
    n = len(table)
    if groupby:
        codes, uniq = _group_codes(table.eval_expression_list(list(groupby)))
        num_groups = len(uniq)
        out_cols = list(uniq._columns)
        out_fields = list(uniq.schema)
    else:
        codes = np.zeros(n, dtype=np.int64)
        num_groups = 1
        out_cols = []
        out_fields = []
    if num_groups * HLL_M > MAX_DEVICE_REGISTERS:
        return None
    pending = []
    for alias, node in nodes:
        child = node.child.evaluate(table)
        if child.is_python():
            child = child.cast(DataType.string())
        gcodes, idx, rank = scatter_operands(child.to_arrow(), codes)
        resolve = hll_scatter_device_launch(gcodes, idx, rank, num_groups, device)
        if resolve is None:
            return None
        pending.append((alias, resolve))

    def finish() -> Table:
        cols = list(out_cols)
        fields = list(out_fields)
        for alias, resolve in pending:
            cols.append(Series.from_arrow(registers_to_binary(resolve()), alias,
                                          DataType.binary()))
            fields.append(Field(alias, DataType.binary()))
        return Table(Schema(fields), cols)

    return finish
