"""Device join probe (K7) and key packing (the port's copy of
daft_tpu/kernels/device_join.py), as torch code.

The build side is SORTED once and every probe row is a vectorized
``torch.searchsorted`` over the sorted build keys: no hash table. The probe
keeps the reference's exact-int contract (int32 lanes in the 32-bit mode,
int64 lanes in the 64-bit one), so no hand-written kernel is needed. Null keys never match. The probe
direction adapts:

- build = RIGHT side (right keys unique): inner/left/semi/anti with the probe
  over the left rows; the output is already in host order (left row, right row);
- build = LEFT side (left keys unique, inner only): the output is re-sorted
  stably by left row;
- duplicate keys on both sides (N:M): the range probe computes each probe
  row's span of matches on the card; the data-dependent expansion to
  (left row, right row) pairs runs on the host (side "expanded").

Join keys: 1-4 integer or date expressions, or string keys: a plain string
column or a row-local transform of one (``upper(s)``, a fill_null chain).
A string key's codes, each side's own dictionary codes or transform ids,
are recoded through a remap into the sorted JOINT dictionary of both sides
(``_stage_key_pair``), so equal strings get equal ints across tables and
the int probe applies unchanged. An int-valued transform (``length(s)``)
joins as an int, never through the joint dictionary. Several keys pack
into one surrogate lane by exact mixed-radix packing
(``_pack_composite_keys``, also used by the grouped aggregation). A
composite key space that overflows the mode's lane (int32, or int64 in the
64-bit mode) declines to the host join.

Mesh replicas (the rest of K7): ``replicate_join_key`` stages a broadcast
build side's key once and copies it onto each distinct device of the mesh,
cached on the partition; ``device_join_launch`` then swaps in the copy on the
other side's device (``left_replicas``/``right_replicas``), so a probe
neither stages the build side again nor reads it across devices.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .device import (compile_projection, int64_wrap_safe, normalize_and_check, size_bucket,
                     stage_table_columns, string_literal_env, string_lut_env,
                     string_transform_env, transform_cmp_env, uint32_key_declines)


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
    if not (dt.is_integer() or dt.kind == TypeKind.DATE) or uint32_key_declines(dt):
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
        return None  # a computed int64 key could wrap in int32 lanes (32-bit mode)
    # an integer key may embed a string lane ((col("s") == "a").cast(int),
    # length(s), (upper(a) == b).if_else(1, 0)): its closure reads the
    # literal's code bounds, a lookup table, a transform lane or the pairwise
    # remaps of a transform compare (aux is shared, so the compare sees the
    # transform sides' dictionaries)
    aux: dict = {}
    env = string_literal_env([node], schema, dcs, env)
    if env is not None:
        env = string_lut_env([node], schema, dcs, env)
    if env is not None:
        env = string_transform_env([node], schema, table, b, cache, env, aux, device)
    if env is not None:
        env = transform_cmp_env([node], schema, table, b, cache, dcs, env, aux, device)
    if env is None:
        return None
    run, _ = compile_projection([node], schema, tuple(sorted(cols)))
    (vals, valid), = run(env)
    if vals.is_floating_point() or vals.dtype == torch.bool:
        return None
    return vals, _real_rows(valid, len(table))


def _real_rows(valid, n: int):
    """``valid`` with the size-bucket padding lanes forced invalid: a
    null-reviving key (a fill_null chain, a transform through the null slot)
    marks them valid, and the probe masks by validity, so phantom build rows
    would match."""
    if valid.shape[0] > n:
        valid = valid & (torch.arange(valid.shape[0], device=valid.device) < n)
    return valid


def _normalized_key_node(table, key_expr):
    """The key node with literals normalized and Between rewritten (the
    normalization every dictionary cache key uses), or None."""
    from ..expressions import normalize_literals
    from .device import _rewrite_between

    try:
        return _rewrite_between(normalize_literals(key_expr._node, table.schema), table.schema)
    except (ValueError, KeyError):
        return None


def _string_valued_transform_shape(node, schema):
    """The transform shape only for a string-VALUED key: an int key such as
    length(s) must never reach the joint dictionary, whose merge casts to
    large_string and would join 4 against "4"."""
    from .device import _string_dict_value_shape

    try:
        if not node.to_field(schema).dtype.is_string():
            return None
    except (ValueError, KeyError):
        return None
    return _string_dict_value_shape(node, schema)


def _is_plain_string_key(table, key_expr) -> bool:
    """Shape check without staging: the key is a bare string column or a
    row-local transform of one, so the joint-dictionary path may apply."""
    from .device import _plain_string_column

    node = _normalized_key_node(table, key_expr)
    return node is not None and (
        _plain_string_column(node, table.schema) is not None
        or _string_valued_transform_shape(node, table.schema) is not None)


class _CodeSide:
    """(values, valid, dictionary) of one string key side: a plain column's
    dictionary codes, or a transformed key's ids with their dictionary."""

    __slots__ = ("values", "valid", "dictionary")

    def __init__(self, values, valid, dictionary):
        self.values = values
        self.valid = valid
        self.dictionary = dictionary


def _string_code_side(table, key_expr, cache, device) -> Optional[_CodeSide]:
    """One string key side in code space, or None: a plain column through
    its sorted dictionary, a row-local transform through its transform
    lane."""
    from .device import _plain_string_column, dict_transform_lane

    node = _normalized_key_node(table, key_expr)
    if node is None:
        return None
    b = size_bucket(len(table))
    cname = _plain_string_column(node, table.schema)
    if cname is not None:
        staged = stage_table_columns(table, [cname], b, cache, device)
        if staged is None or staged[1][cname].dictionary is None:
            return None
        dc = staged[1][cname]
        return _CodeSide(dc.values, dc.valid, dc.dictionary)
    shape = _string_valued_transform_shape(node, table.schema)
    if shape is None:
        return None
    lane = dict_transform_lane(table, shape, b, cache, device)
    if lane is None:
        return None
    return _CodeSide(lane[0], _real_rows(lane[1], len(table)), lane[2])


def _recode(codes, remap):
    """Codes gathered into the joint dictionary's code space."""
    return remap.index_select(0, codes)


def _joint_remaps(ldc, rdc, lcache, rcache, device):
    """(lremap, rremap) taking each side's codes into their sorted JOINT
    dictionary's code space. Cached per dictionary pair in BOTH sides'
    caches by the dictionaries' ids; the entry holds both dictionaries, so
    neither id can be reused while it lives. A build side joined against
    many probe partitions merges its dictionary once per partition pair."""
    import pyarrow as pa
    import pyarrow.compute as pc

    from .device import joint_remap

    key = ("__jointremap__", id(ldc.dictionary), id(rdc.dictionary), str(device))
    for cache in (lcache, rcache):
        cached = cache.get(key) if cache is not None else None
        if cached is not None:
            return cached[2], cached[3]
    joint = pc.unique(pa.concat_arrays([ldc.dictionary.cast(pa.large_string()),
                                        rdc.dictionary.cast(pa.large_string())]))
    joint = joint.take(pc.sort_indices(joint))
    entry = (ldc.dictionary, rdc.dictionary, joint_remap(ldc.dictionary, joint, device),
             joint_remap(rdc.dictionary, joint, device))
    for cache in (lcache, rcache):
        if cache is not None:
            cache[key] = entry
    return entry[2], entry[3]


def _masked_min_max_multi(vs, ms):
    """Per-column masked min/max for a tuple of key columns, fetched with
    one host sync."""
    mins = torch.stack([torch.where(m, v, torch.iinfo(v.dtype).max).min().to(torch.int64)
                        for v, m in zip(vs, ms)])
    maxs = torch.stack([torch.where(m, v, torch.iinfo(v.dtype).min).max().to(torch.int64)
                        for v, m in zip(vs, ms)])
    both = torch.stack([mins, maxs]).cpu().numpy()
    return both[0], both[1]


def _pack_kernel(vs, ms, mins, strides, wide: bool):
    """Mixed-radix composite-key packing into int32 lanes, or int64 lanes
    when ``wide`` (the 64-bit mode)."""
    out_dt = torch.int64 if wide else torch.int32
    packed = torch.zeros(vs[0].shape, dtype=out_dt, device=vs[0].device)
    valid = torch.ones(ms[0].shape, dtype=torch.bool, device=ms[0].device)
    for v, m, lo, st in zip(vs, ms, mins, strides):
        packed = packed + (v.to(out_dt) - int(lo)) * int(st)
        valid = valid & m
    # clamp invalid lanes so padding garbage stays in range
    return torch.where(valid, packed, 0), valid


def _pack_composite_keys(sides):
    """Pack N integer key columns into ONE surrogate key column per side
    (exact mixed-radix packing: collision-free by construction).

    ``sides`` is a list of [(vals, valid), ...] per side, all with the same
    key count. Offsets and strides come from the min/max over every side, so
    equal keys pack identically. Returns [(packed, valid), ...] per side, or
    None when the combined key space overflows the mode's lane (int32, or
    int64 in the 64-bit mode). A row's composite key is valid only if every
    component is."""
    from ..context import x64_enabled

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
    wide = x64_enabled()
    if int(np.prod(spans, dtype=object)) > (2 ** 63 - 1 if wide else 2 ** 31 - 1):
        return None
    strides = []
    acc = 1
    for s in reversed(spans):
        strides.append(acc)
        acc *= s
    strides = tuple(reversed(strides))
    return [_pack_kernel(tuple(v for v, _ in side), tuple(m for _, m in side),
                         mins, strides, wide) for side in sides]


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


def _stage_key_pair(ltable, rtable, lkey, rkey, lcache, rcache, device, ls=None, rs=None):
    """((lv, lm), (rv, rm)) aligned int lanes for ONE key pair, or None.
    Integer and date keys stage on their own (``ls``/``rs`` pass sides
    staged already). String keys cannot: per-partition codes do not compare
    across tables, so both sides' sorted dictionaries merge into one sorted
    joint dictionary (host, cached per pair) and each side's codes gather
    through a small remap on the card."""
    if ls is None:
        ls = _stage_key(ltable, lkey, lcache, device)
    if rs is None:
        rs = _stage_key(rtable, rkey, rcache, device)
    if ls is not None and rs is not None:
        return ls, rs
    ldc = _string_code_side(ltable, lkey, lcache, device)
    rdc = _string_code_side(rtable, rkey, rcache, device)
    if ldc is None or rdc is None:
        return None
    lremap, rremap = _joint_remaps(ldc, rdc, lcache, rcache, device)
    return ((_recode(ldc.values, lremap), ldc.valid), (_recode(rdc.values, rremap), rdc.valid))


def _device_key(d: torch.device) -> str:
    """One name per physical device (``cuda`` is the current card)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return str(d)


def _replica_cache_key(key_expr):
    from .device import x64_enabled

    return ("__join_key_replica__", key_expr._node._key(), x64_enabled())


def replicate_join_key(part, key_expr, mesh, device) -> bool:
    """Stage ``key_expr`` over ``part`` once on ``device`` and copy it onto
    every distinct device of ``mesh``; the copies are cached on the partition
    by device. True when replicated (an ineligible key: False)."""
    tbl = part.table()
    staged = _stage_key(tbl, key_expr, part.device_stage_cache(), torch.device(device))
    if staged is None:
        return False
    vals, valid = staged
    reps = {}
    for d in mesh.devices:
        k = _device_key(d)
        if k not in reps:
            reps[k] = (vals.to(d), valid.to(d))
    part.device_stage_cache()[_replica_cache_key(key_expr)] = reps
    return True


def join_key_replicas(part, key_expr):
    """The {device: (values, valid)} copies ``replicate_join_key`` cached on
    ``part``, or None."""
    if part is None:
        return None
    return part.device_stage_cache().get(_replica_cache_key(key_expr))


def device_join_launch(left_table, right_table, left_keys, right_keys,
                       left_cache=None, right_cache=None, how: str = "inner",
                       device="cuda", left_replicas=None, right_replicas=None):
    """Stage the keys and LAUNCH the right-build range probe without waiting
    for it; the returned zero-arg resolver makes the duplicate-key decision,
    runs a second-orientation probe if one is needed, and returns
    (side, hit, bidx):

    - side "right_build": hit/bidx per LEFT row (bidx indexes the right table);
    - side "left_build": hit/bidx per RIGHT row (bidx indexes the left table);
    - side "expanded": (lidx, ridx) row-index pairs of the N:M range join
      (ridx == -1 marks a left-outer miss).

    Returns None when ineligible: no key, unequal key counts, an empty side,
    a key that is neither an integer or date expression nor a string key,
    unequal lane dtypes, or a composite key space that overflows the mode's
    lane.

    A side that carries mesh replicas (``replicate_join_key``; one key only)
    has the copy on the other side's device swapped in, and is not staged."""
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
    if len(left_keys) > 1:
        pairs: List = []
        for lk, rk in zip(left_keys, right_keys):
            pair = _stage_key_pair(left_table, right_table, lk, rk, left_cache, right_cache,
                                   device)
            if pair is None:
                return None
            pairs.append(pair)
        packed = _pack_composite_keys([[p[0] for p in pairs], [p[1] for p in pairs]])
        if packed is None:
            return None
        (lv, lm), (rv, rm) = packed
        return _launch_probe(lv, lm, rv, rm, ln, rn, how)
    left_key, right_key = left_keys[0], right_keys[0]
    lk = _stage_key(left_table, left_key, left_cache, device)
    rk = None
    if lk is not None and right_replicas:
        # a replica hit: the build side's key is not staged again (the copy
        # exists, so the key passed the device checks)
        rk = right_replicas.get(_device_key(lk[0].device))
    if rk is None:
        if lk is None and not _is_plain_string_key(left_table, left_key):
            return None  # an ineligible left key: the right side is not staged
        rk = _stage_key(right_table, right_key, right_cache, device)
        if lk is None or rk is None:
            # a string key (or one string side): through the joint dictionary
            pair = _stage_key_pair(left_table, right_table, left_key, right_key, left_cache,
                                   right_cache, device, ls=lk, rs=rk)
            if pair is None:
                return None
            lk, rk = pair
        elif left_replicas:
            lk = left_replicas.get(_device_key(rk[0].device), lk)
    (lv, lm), (rv, rm) = lk, rk
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
