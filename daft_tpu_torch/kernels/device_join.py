"""Device join probe (K7) and key packing (the port's copy of
daft_tpu/kernels/device_join.py), as torch code.

The build side is SORTED once and every probe row is a vectorized
``torch.searchsorted`` over the sorted build keys: no hash table. The probe
keeps the reference's exact-int contract (int32 lanes in the 32-bit mode),
so no hand-written kernel is needed. Null keys never match. The probe
direction adapts:

- build = RIGHT side (right keys unique): inner/left/semi/anti with the probe
  over the left rows; the output is already in host order (left row, right row);
- build = LEFT side (left keys unique, inner only): the output is re-sorted
  stably by left row;
- duplicate keys on both sides (N:M): the range probe computes each probe
  row's span of matches on the card; the data-dependent expansion to
  (left row, right row) pairs runs on the host (side "expanded").

Join keys: 1-4 integer or date expressions; several keys pack into one
surrogate lane by exact mixed-radix packing (``_pack_composite_keys``, also
used by the grouped aggregation). A composite key space that overflows int32
declines to the host join. Left out of this slice, and declined to the host
join by the reference's own eligibility rule: string keys through the joint
dictionary (``_string_code_side``, ``_joint_remaps``, ``_recode``) and the
mesh replicas of a broadcast build side (``replicate_join_key``,
``join_key_replicas``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .device import (compile_projection, int64_wrap_safe, normalize_and_check,
                     size_bucket, stage_table_columns, string_literal_env)


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
    env, dcs = staged
    if not int64_wrap_safe([node], schema, env, cache, b):
        return None  # a computed int64 key could wrap in int32 lanes
    # an integer key may embed a string-literal comparison
    # ((col("s") == "a").cast(int)): its closure reads the literal's code
    # bounds in this partition's dictionary
    env = string_literal_env([node], schema, dcs, env)
    if env is None:
        return None
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


def _range_probe_kernel(build_vals, build_valid, probe_vals, probe_valid):
    """Per-probe-row match RANGE over the sorted build keys: (lo [P],
    counts [P], perm [B], dup). ONE sort serves both probe flavours: when
    ``dup`` (duplicate valid build keys) is False every count is at most 1,
    so the primary-key outputs are hit = counts > 0 and build row perm[lo]
    (``_pk_outputs``); otherwise probe row i matches perm[lo[i] : lo[i] +
    counts[i]], expanded on the host.

    Valid lanes sort before null and padding lanes within a run of equal
    keys (the lexsort's secondary key), so each run's valid matches are a
    contiguous prefix and the running count of valid lanes turns [lo, hi)
    into an exact count of valid matches. torch has no lexsort: chained
    stable sorts, least significant key first. ``dup`` stays on the card
    (a 0-d bool tensor)."""
    big = torch.iinfo(build_vals.dtype).max
    k = torch.where(build_valid, build_vals, big)
    perm = torch.argsort((~build_valid).to(torch.int8), stable=True)
    perm = perm[torch.argsort(k[perm], stable=True)]
    sk = k[perm].contiguous()
    sorted_valid = build_valid[perm]
    dup = ((sk[1:] == sk[:-1]) & sorted_valid[1:] & sorted_valid[:-1]).any()
    vp = torch.cat([torch.zeros(1, dtype=torch.int32, device=sk.device),
                    torch.cumsum(sorted_valid.to(torch.int32), 0, dtype=torch.int32)])
    probe = probe_vals.contiguous()
    lo = torch.searchsorted(sk, probe, right=False)
    hi = torch.searchsorted(sk, probe, right=True)
    counts = torch.where(probe_valid, vp[hi] - vp[lo], 0)
    return lo.to(torch.int32), counts, perm.to(torch.int32), dup


def _pk_outputs(lo, counts, perm):
    """Primary-key view of the range probe (dup is False): per-probe-row
    (hit, build row), computed on the card."""
    b = perm.shape[0]
    return counts > 0, perm[lo.clamp_max(b - 1).long()]


def _range_join(lo_d, counts_d, perm_d, ln: int, how: str):
    """N:M join (duplicate build keys): the host expansion of the device
    range probe. Returns ("right_build", hit, _) for semi/anti (only the hit
    mask is read), or ("expanded", lidx, ridx) index pairs for inner/left
    (ridx == -1 marks a left-outer miss). Rows come out left-row-major with
    the matches in sorted-build-key order; join output order is unspecified
    engine-wide (Table.hash_join), only the multiset of rows is fixed."""
    lo = lo_d[:ln].cpu().numpy().astype(np.int64)
    counts = counts_d[:ln].cpu().numpy().astype(np.int64)
    perm = perm_d.cpu().numpy().astype(np.int64)
    hit = counts > 0
    if how in ("semi", "anti"):
        return "right_build", hit, np.zeros(ln, dtype=np.int64)
    # a miss keeps one output row under left-outer
    ce = counts if how == "inner" else np.where(hit, counts, 1)
    total = int(ce.sum())
    lidx = np.repeat(np.arange(ln, dtype=np.int64), ce)
    starts = np.repeat(lo, ce)
    offs = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(ce) - ce, ce)
    ridx = perm[np.minimum(starts + offs, len(perm) - 1)]
    if how != "inner":
        ridx = np.where(np.repeat(hit, ce), ridx, -1)
    return "expanded", lidx, ridx


def _stage_key_pair(ltable, rtable, lkey, rkey, lcache, rcache, device):
    """((lv, lm), (rv, rm)) int lanes for ONE key pair, or None when either
    side is not an integer or date key the device compiles. String keys
    (which the reference recodes through a joint dictionary) decline."""
    ls = _stage_key(ltable, lkey, lcache, device)
    if ls is None:
        return None
    rs = _stage_key(rtable, rkey, rcache, device)
    if rs is None:
        return None
    return ls, rs


def device_join_launch(left_table, right_table, left_keys, right_keys,
                       left_cache=None, right_cache=None, how: str = "inner",
                       device="cuda"):
    """Stage the keys and LAUNCH the right-build range probe without waiting
    for it; the returned zero-arg resolver makes the duplicate-key decision,
    runs a second-orientation probe if one is needed, and returns
    (side, hit, bidx):

    - side "right_build": hit/bidx per LEFT row (bidx indexes the right table);
    - side "left_build": hit/bidx per RIGHT row (bidx indexes the left table);
    - side "expanded": (lidx, ridx) row-index pairs of the N:M range join
      (ridx == -1 marks a left-outer miss).

    Returns None when ineligible: no key, unequal key counts, an empty side,
    a key that is not an integer or date expression, unequal lane dtypes, or
    a composite key space that overflows int32."""
    if not isinstance(left_keys, (list, tuple)):
        left_keys = [left_keys]
    if not isinstance(right_keys, (list, tuple)):
        right_keys = [right_keys]
    if len(left_keys) != len(right_keys) or not left_keys:
        return None
    ln, rn = len(left_table), len(right_table)
    if ln == 0 or rn == 0:
        return None
    device = torch.device(device)
    pairs: List = []
    for lk, rk in zip(left_keys, right_keys):
        pair = _stage_key_pair(left_table, right_table, lk, rk, left_cache, right_cache, device)
        if pair is None:
            return None
        pairs.append(pair)
    if len(pairs) > 1:
        packed = _pack_composite_keys([[p[0] for p in pairs], [p[1] for p in pairs]])
        if packed is None:
            return None
        (lv, lm), (rv, rm) = packed
    else:
        (lv, lm), (rv, rm) = pairs[0]
        if lv.dtype != rv.dtype:
            return None
    return _launch_probe(lv, lm, rv, rm, ln, rn, how)


def _launch_probe(lv, lm, rv, rm, ln: int, rn: int, how: str):
    """Launch the right-build range probe now; return the resolver that
    makes the duplicate-key decision and finishes the probe."""
    lo, counts, perm, dup = _range_probe_kernel(rv, rm, lv, lm)

    def resolve():
        # build = right first (probe order is the host's output order); the
        # one sort serves whichever path the dup flag selects
        if not bool(dup):
            hit, bidx = _pk_outputs(lo, counts, perm)
            return ("right_build", hit[:ln].cpu().numpy(),
                    bidx[:ln].cpu().numpy().astype(np.int64))
        if how == "inner":
            lo2, counts2, perm2, dup2 = _range_probe_kernel(lv, lm, rv, rm)
            if not bool(dup2):
                hit, bidx = _pk_outputs(lo2, counts2, perm2)
                return ("left_build", hit[:rn].cpu().numpy(),
                        bidx[:rn].cpu().numpy().astype(np.int64))
        # duplicate build keys on every usable orientation: the N:M range
        # join, reusing the right-build probe already on the card
        return _range_join(lo, counts, perm, ln, how)

    return resolve
