"""Device key staging and mixed-radix key packing (the port's copy of the part
of daft_tpu/kernels/device_join.py the grouped aggregation uses).

A grouped aggregation over two keys (TPC-H Q1 groups by l_returnflag and
l_linestatus) packs the keys into ONE int lane, so the single-key group-code
kernel applies unchanged. Left out of this slice: the device join itself
(the sorted range probe, primary-key outputs, joint string dictionaries and
key replication).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .device import (compile_projection, int64_wrap_safe, normalize_and_check,
                     size_bucket, stage_table_columns)


def _stage_key(table, key_expr, cache, device) -> Optional[Tuple]:
    """Stage one integer or date key expression -> (values, valid), or None
    when the key is not an integer/date expression the device compiles."""
    from ..datatypes import TypeKind
    from ..expressions import required_columns

    schema = table.schema
    nodes = normalize_and_check([key_expr], schema)
    if nodes is None:
        return None
    node = nodes[0]
    dt = node.to_field(schema).dtype
    if not (dt.is_integer() or dt.kind == TypeKind.DATE):
        return None
    cols = required_columns(node)
    if not cols:
        return None
    b = size_bucket(len(table))
    staged = stage_table_columns(table, cols, b, cache, device)
    if staged is None:
        return None
    env, _dcs = staged
    if not int64_wrap_safe([node], schema, env, cache, b):
        return None  # a computed int64 key could wrap in int32 lanes
    run, _ = compile_projection([node], schema, tuple(sorted(cols)))
    (vals, valid), = run(env)
    if vals.is_floating_point() or vals.dtype == torch.bool:
        return None
    # padding lanes stay invalid whatever the key expression does
    n = len(table)
    if valid.shape[0] > n:
        valid = valid & (torch.arange(valid.shape[0], device=valid.device) < n)
    return vals, valid


def _masked_min_max_multi(vs, ms):
    """Per-column masked min/max for a tuple of key columns, fetched with
    one host sync."""
    mins = torch.stack([torch.where(m, v, torch.iinfo(v.dtype).max).min().to(torch.int64)
                        for v, m in zip(vs, ms)])
    maxs = torch.stack([torch.where(m, v, torch.iinfo(v.dtype).min).max().to(torch.int64)
                        for v, m in zip(vs, ms)])
    both = torch.stack([mins, maxs]).cpu().numpy()
    return both[0], both[1]


def _pack_kernel(vs, ms, mins, strides):
    """Mixed-radix composite-key packing into int32 lanes (the 32-bit mode)."""
    packed = torch.zeros(vs[0].shape, dtype=torch.int32, device=vs[0].device)
    valid = torch.ones(ms[0].shape, dtype=torch.bool, device=ms[0].device)
    for v, m, lo, st in zip(vs, ms, mins, strides):
        packed = packed + (v.to(torch.int32) - int(lo)) * int(st)
        valid = valid & m
    # clamp invalid lanes so padding garbage stays in range
    return torch.where(valid, packed, 0), valid


def _pack_composite_keys(sides):
    """Pack N integer key columns into ONE surrogate key column per side
    (exact mixed-radix packing: collision-free by construction).

    ``sides`` is a list of [(vals, valid), ...] per side, all with the same
    key count. Offsets and strides come from the min/max over every side, so
    equal keys pack identically. Returns [(packed, valid), ...] per side, or
    None when the combined key space overflows int32. A row's composite key
    is valid only if every component is."""
    nkeys = len(sides[0])
    per_side = [_masked_min_max_multi(tuple(v for v, _ in side), tuple(m for _, m in side))
                for side in sides]
    mins = []
    spans = []
    for j in range(nkeys):
        lo = min(int(mns[j]) for mns, _ in per_side)
        hi = max(int(mxs[j]) for _, mxs in per_side)
        if hi < lo:  # an all-null column on every side
            lo, hi = 0, 0
        mins.append(lo)
        spans.append(hi - lo + 1)
    if int(np.prod(spans, dtype=object)) > 2 ** 31 - 1:
        return None
    strides = []
    acc = 1
    for s in reversed(spans):
        strides.append(acc)
        acc *= s
    strides = tuple(reversed(strides))
    return [_pack_kernel(tuple(v for v, _ in side), tuple(m for _, m in side),
                         mins, strides) for side in sides]
