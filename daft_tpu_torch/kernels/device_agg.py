"""Fused device groupby-aggregation (the port's copy of the part of
daft_tpu/kernels/device_agg.py this slice runs).

One compiled program per plan shape evaluates every aggregation input
expression and its masked segment reduction on the card, with an optional
fused filter predicate that stays a mask (no host compaction). Group keys
get their dense codes on the card (``_group_codes_kernel``: sort, boundary
scan, first-occurrence remap) for 1-4 stageable keys: integer/date values,
plain string columns through their sorted dictionary codes, several keys
through mixed-radix packing (null-free only). Anything else takes the host
dictionary encode (``table._group_codes``).

32-bit device mode: float64 inputs compute as float32, and every float sum
of a plan goes through ONE launch of the masked segment-sums kernel
(segment_sums.py) when the padded row count is a multiple of 1024 and there
are at most 4096 group slots. Integer sums narrow to int32 and are
overflow-guarded: the program also returns max|v|, and the resolver declines
(the host path recomputes) if n * max|v| could exceed int32.

Launch/resolve: ``device_grouped_agg_async`` stages, launches every kernel
on the current stream and returns; the resolver fetches the results once.

With ``use_deep_fusion_kernel`` the float sums go to the deep-fused kernel
K2 instead (fused_expr_sums.py), which evaluates the filter and the derived
columns itself; a K2 failure raises, it never falls back to K1.

``device_distinct_indices`` gives the first row of each distinct key tuple
from the same group-codes kernel.

Left out of this slice: the epoch, LUT, transform and joint-dictionary
lanes, transformed string keys, and string min/max over anything but a
plain string column. The reference's deep branch catches any exception and
falls back to the batched kernel; that catch is not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..datatypes import DataType
from .device import (_ONEHOT_MAX_SEGMENTS, _np, _plain_string_column, compile_projection,
                     device_required_columns, int64_wrap_safe, normalize_and_check,
                     segment_reduce, size_bucket, stage_table_columns, string_literal_env,
                     unstage)

# agg kinds with a device segment reduction. mean decomposes to sum+count.
_DEVICE_AGG_KINDS = {"sum", "count", "min", "max", "mean"}

_AGG_CACHE: Dict = {}


def _unwrap(expr):
    from ..expressions import AggExpr, Alias

    node = expr._node
    while isinstance(node, Alias):
        node = node.child
    return node if isinstance(node, AggExpr) else None


def _group_codes_kernel(vals, valid, n):
    """Dense group codes for ONE integer key lane, on the card: sort ->
    boundary detect -> scan -> scatter, then remap codes to FIRST-OCCURRENCE
    order so the group order matches the host dictionary encode exactly
    (null keys form one group). Returns (codes [b] int32, num_groups,
    first_rows [b], uniq_vals [b], uniq_valid [b]); the uniq arrays are
    meaningful for the first num_groups lanes. ``n`` is a 0-d int32 tensor."""
    b = vals.shape[0]
    dev = vals.device
    idx = torch.arange(b, dtype=torch.int32, device=dev)
    oob = idx >= n                      # padding lanes beyond the real rows
    isnull = ~valid & ~oob              # null KEYS group together (SQL)
    k = torch.where(valid, vals, torch.iinfo(vals.dtype).max)
    # jnp.lexsort((k, isnull, oob)): chained stable sorts, least significant first
    perm = torch.argsort(k, stable=True)
    perm = perm[torch.argsort(isnull[perm].to(torch.int8), stable=True)]
    perm = perm[torch.argsort(oob[perm].to(torch.int8), stable=True)]
    sk = k[perm]
    snull = isnull[perm]
    soob = oob[perm]
    prev_diff = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           (sk[1:] != sk[:-1]) | (snull[1:] != snull[:-1])])
    boundary = ~soob & prev_diff
    codes_sorted = (torch.cumsum(boundary.to(torch.int32), 0, dtype=torch.int32) - 1).clamp_min(0)
    codes = torch.zeros(b, dtype=torch.int32, device=dev).index_copy_(0, perm, codes_sorted)
    num_groups = boundary.sum(dtype=torch.int32)
    # first-occurrence row per group; padding contributes the sentinel b
    first = torch.full((b,), b, dtype=torch.int32, device=dev).scatter_reduce_(
        0, codes.long(), torch.where(oob, b, idx), "amin")
    order = torch.argsort(first, stable=True)  # empty/sentinel groups sort last
    inv = torch.zeros(b, dtype=torch.int32, device=dev).index_copy_(
        0, order, torch.arange(b, dtype=torch.int32, device=dev))
    codes = inv[codes.long()]
    first_rows = first[order]
    safe_rows = first_rows.clamp_max(b - 1).long()
    return codes, num_groups, first_rows, vals[safe_rows], valid[safe_rows]


def _stage_group_key(table, key_expr, cache, device):
    """(vals, valid) int lanes for ONE group key: integer/date expressions via
    the join-key stager; plain STRING columns via their sorted dictionary
    codes (dense ints already)."""
    from ..expressions import normalize_literals
    from .device import _rewrite_between
    from .device_join import _stage_key

    staged = _stage_key(table, key_expr, cache, device)
    if staged is not None:
        return staged
    try:
        node = _rewrite_between(normalize_literals(key_expr._node, table.schema), table.schema)
    except (ValueError, KeyError):
        return None
    cname = _plain_string_column(node, table.schema)
    if cname is None:
        return None
    staged_cols = stage_table_columns(table, [cname], size_bucket(len(table)), cache, device)
    if staged_cols is None:
        return None
    return staged_cols[0][cname]


def _try_device_group_codes(table, group_by, stage_cache, n: int, device):
    """(codes_dev, uniq Table, num_groups) via the device kernel for 1-4
    stageable keys, or None when ineligible. Unique key ROWS are gathered on
    the host by first-occurrence index, so the group order matches the host
    dictionary encode exactly."""
    import pyarrow as pa

    from ..series import Series

    lanes = _staged_group_lanes(table, group_by, stage_cache, n, device)
    if lanes is None:
        return None
    vals, valid = lanes
    n_dev = torch.tensor(n, dtype=torch.int32, device=device)
    codes, num_groups, first_rows, _uv, _um = _group_codes_kernel(vals, valid, n_dev)
    num_groups = int(num_groups)  # one small sync; bounds the segment bucket
    first = first_rows[:num_groups].cpu().numpy()
    # evaluate the key expressions over just the num_groups first rows
    first_tbl = table.take(Series.from_arrow(pa.array(first.astype(np.uint64)), "idx"))
    return codes, first_tbl.eval_expression_list(list(group_by)), num_groups


def _staged_group_lanes(table, keys, stage_cache, n: int, device):
    """ONE (vals, valid) int lane for 1-4 group keys: single keys stage
    directly (nulls fine: the kernel groups them); several keys pack
    mixed-radix, which is only null-faithful when every component is
    null-free, so nullable multi-key inputs decline."""
    from .device_join import _pack_composite_keys

    staged = [_stage_group_key(table, k, stage_cache, device) for k in keys]
    if any(s is None for s in staged):
        return None
    if len(staged) == 1:
        return staged[0]
    if not bool(torch.stack([m[:n].all() for _, m in staged]).all()):
        return None
    packed = _pack_composite_keys([staged])
    if packed is None:
        return None
    return packed[0]


def device_distinct_indices(table, keys, stage_cache, n: int, device="cuda"):
    """First-occurrence row indices of the distinct key tuples, computed on
    the card by ``_group_codes_kernel`` (row order preserved: the contract
    of ``Table.distinct``'s host dictionary encode). Several keys pack
    mixed-radix, which is only null-faithful when every component is
    null-free (a null component would merge (1, null) and (2, null)), so
    nullable multi-key inputs decline to the host. Returns np.ndarray or
    None."""
    device = torch.device(device)
    lanes = _staged_group_lanes(table, keys, stage_cache, n, device)
    if lanes is None:
        return None
    vals, valid = lanes
    _, num_groups, first_rows, _, _ = _group_codes_kernel(
        vals, valid, torch.tensor(n, dtype=torch.int32, device=device))
    return first_rows[:int(num_groups)].cpu().numpy()


def group_codes_cached(table, group_by, stage_cache: Optional[dict], n: int,
                       b: int, device, stats=None):
    """(codes_dev, uniq Table|None, num_groups) for ``group_by`` over
    ``table``, cached with the partition under the stage cache. Device kernel
    for 1-4 stageable keys, host ``_group_codes`` otherwise; ungrouped
    degenerates to one group. An error on the card propagates."""
    from ..table import _group_codes

    codes_key = ("groupcodes", tuple(e._node._key() for e in group_by), b, str(device))
    cached = stage_cache.get(codes_key) if stage_cache is not None else None
    if cached is None:
        if 1 <= len(group_by) <= 4:
            cached = _try_device_group_codes(table, group_by, stage_cache, n, device)
            if cached is not None and stats is not None:
                stats.bump("device_group_codes")
        if cached is None:
            if group_by:
                codes_np, uniq = _group_codes(table.eval_expression_list(list(group_by)))
                num_groups = len(uniq)
            else:
                codes_np = np.zeros(n, dtype=np.int64)
                uniq = None
                num_groups = 1
            codes_dev = torch.from_numpy(
                np.pad(codes_np.astype(np.int32), (0, b - n))).to(device)
            cached = (codes_dev, uniq, num_groups)
        if stage_cache is not None:
            stage_cache[codes_key] = cached
    return cached


class _ExprView:
    """Minimal Expression-shaped wrapper so helpers taking Expressions accept
    bare nodes."""

    __slots__ = ("_node",)

    def __init__(self, node):
        self._node = node

    def name(self):
        return self._node.name()


def _plan_agg_specs(to_agg, schema, predicate=None):
    """Shared eligibility prologue for the launch and the static check.
    Returns (specs, child_nodes, pred_nodes) or None when any aggregation
    kind, count mode, child expression or predicate is device-ineligible."""
    specs = []  # (alias, kind, AggExpr node, count_mode)
    child_exprs = []
    for e in to_agg:
        node = _unwrap(e)
        if node is None or node.kind not in _DEVICE_AGG_KINDS:
            return None
        mode = node.extra.get("mode", "valid")
        if node.kind == "count" and mode not in ("valid", "all", "null"):
            return None
        specs.append((e.name(), node.kind, node, mode))
        child_exprs.append(_ExprView(node.child))
    child_nodes = normalize_and_check(child_exprs, schema)
    if child_nodes is None:
        return None
    pred_nodes = None
    if predicate is not None:
        pred_nodes = normalize_and_check([predicate], schema)
        if pred_nodes is None:
            return None
    return specs, child_nodes, pred_nodes


def device_grouped_agg_async(table, to_agg, group_by, stage_cache: Optional[dict] = None,
                             predicate=None, stats=None, device="cuda"):
    """Fused grouped aggregation of one partition on the card, split into a
    launch (staging and every kernel start now, on the current stream) and a
    deferred resolver (ONE result fetch + host assembly when called).

    ``to_agg``: aggregation Expressions (sum/count/min/max/mean);
    ``group_by``: key Expressions; ``predicate``: optional filter fused as a
    mask. Returns a zero-arg resolver yielding a host Table (keys +
    aggregates in first-occurrence group order, as the host path orders
    them) or None when the int32 overflow guard trips; or None at once when
    the plan is ineligible."""
    from ..context import get_context
    from ..schema import Field, Schema
    from ..series import Series
    from ..table import Table

    n = len(table)
    if n == 0:
        return None
    device = torch.device(device)
    schema = table.schema
    planned = _plan_agg_specs(to_agg, schema, predicate)
    if planned is None:
        return None
    specs, child_nodes, pred_nodes = planned

    b = size_bucket(n)
    codes_dev, uniq, num_groups = group_codes_cached(table, group_by, stage_cache, n, b,
                                                     device, stats)
    gb = max(16, 1 << (num_groups - 1).bit_length())  # power-of-two segment bucket

    check_nodes = list(child_nodes) + (list(pred_nodes) if pred_nodes else [])
    needed = device_required_columns(check_nodes, schema)
    staged = stage_table_columns(table, sorted(needed), b, stage_cache, device)
    if staged is None:
        return None
    env, dcs = staged
    if not int64_wrap_safe(check_nodes, schema, env, stage_cache, b):
        return None  # int64 arithmetic could wrap in int32 lanes
    env = string_literal_env(check_nodes, schema, dcs, env)
    if env is None:
        return None  # a string comparison lost its dictionary

    kinds = tuple(s[1] for s in specs)
    modes = tuple(s[3] for s in specs)
    cfg = get_context().execution_config
    run = _compile_agg(tuple(child_nodes), pred_nodes[0] if pred_nodes else None,
                       schema, tuple(sorted(needed)), kinds, modes, gb,
                       bool(cfg.use_segment_sums_kernel), bool(cfg.use_deep_fusion_kernel))
    # the row-count scalar lives on the card with the partition: a warm
    # query makes no upload
    nkey = ("nrows", n, str(device))
    n_dev = stage_cache.get(nkey) if stage_cache is not None else None
    if n_dev is None:
        n_dev = torch.tensor(n, dtype=torch.int32, device=device)
        if stage_cache is not None:
            stage_cache[nkey] = n_dev
    outs_dev = run(env, codes_dev, n_dev, n)  # async: the card computes from here

    def resolve():
        outs = _fetch(outs_dev)
        out_cols: List[Series] = list(uniq._columns) if uniq is not None else []
        out_fields: List[Field] = list(uniq.schema) if uniq is not None else []
        for (alias, kind, agg_node, _mode), child_nd, out in zip(specs, child_nodes, outs):
            expected_dt = agg_node.to_field(schema).dtype
            dictionary = None
            if expected_dt.is_string():
                # string min/max reduce over sorted-dictionary codes
                dictionary = dcs[_plain_string_column(child_nd, schema)].dictionary
            merged = _finish_agg(kind, out, num_groups, expected_dt, n, dictionary=dictionary)
            if merged is None:
                return None  # overflow guard tripped: the host path recomputes
            out_cols.append(merged.rename(alias))
            out_fields.append(Field(alias, expected_dt))
        result = Table(Schema(out_fields), out_cols)
        if pred_nodes is not None and group_by:
            # codes/uniq come from the UNFILTERED table: drop groups with no
            # selected rows and order survivors by their first selected row
            # (the host path's first-occurrence order of the filtered table)
            sel_cnt, first_idx = (a[:num_groups] for a in outs[-1])
            surv = np.nonzero(sel_cnt > 0)[0]
            order = surv[np.argsort(first_idx[surv], kind="stable")]
            if len(order) != num_groups or (order != np.arange(num_groups)).any():
                import pyarrow as pa

                result = result.take(Series.from_arrow(pa.array(order.astype(np.uint64)), "idx"))
        return result

    return resolve


def _fetch(x):
    """Device outputs -> numpy, keeping the list/tuple structure."""
    if isinstance(x, (list, tuple)):
        return type(x)(_fetch(v) for v in x)
    return _np(x)


def _compile_agg(child_nodes, pred_node, schema, input_names, kinds, modes, gb,
                 use_kernel: bool = True, use_deep: bool = False):
    """The compiled aggregation program of one plan shape: ``run(env, codes,
    n_dev, n)`` evaluates every child and its masked segment reduction.

    In the 32-bit mode every float sum rides ONE launch of a segment-sums
    kernel when the padded row count is a multiple of 1024 and there are at
    most 4096 group slots. With ``use_deep`` (every env entry a plain 1-D
    (values, valid) pair, so no string-literal code bounds, and no
    string-literal comparison in the program, which K2's emitter does not
    take) that kernel is K2 (fused_expr_sums.py): it
    evaluates the predicate and the float sum columns from the staged
    columns itself, and torch computes only their validity for the counts.
    Otherwise torch derives and masks the columns and K1 sums them. A K2
    build or launch failure raises: there is no fallback to K1."""
    key = (tuple(n._key() for n in child_nodes),
           pred_node._key() if pred_node is not None else None,
           tuple((f.name, f.dtype) for f in schema), input_names, kinds, modes, gb,
           use_kernel, use_deep)
    if key in _AGG_CACHE:
        return _AGG_CACHE[key]

    child_run, _ = compile_projection(list(child_nodes), schema, input_names)
    pred_run = None
    if pred_node is not None:
        pred_run, _ = compile_projection([pred_node], schema, input_names)

    from . import fused_expr_sums as fes
    from .device import _compile_node, _string_cmp_shape, compile_validity
    from . import segment_sums
    from .segment_sums import BLOCK_ROWS

    child_fns = [_compile_node(nd, schema)[0] for nd in child_nodes]
    valid_fns = [compile_validity(nd, schema) for nd in child_nodes]
    deep_buckets = set()  # padded row counts this program has run deep at

    def has_string_cmp(nd) -> bool:
        return (_string_cmp_shape(nd, schema) is not None
                or any(has_string_cmp(c) for c in nd.children()))

    deep_ok = not any(has_string_cmp(nd) for nd in
                      list(child_nodes) + ([pred_node] if pred_node is not None else []))
    deep_by_dtypes: Dict = {}

    def deep_plan(env):
        """(indices of the children K2 sums, its program): the float sums and
        means, by the lane dtype the closure computes over ``env``'s columns;
        ([], None) when there are none."""
        dtypes = {name: v.dtype for name, (v, _m) in env.items()}
        key = tuple(sorted((k, str(v)) for k, v in dtypes.items()))
        if key not in deep_by_dtypes:
            slots = [i for i, (nd, kind) in enumerate(zip(child_nodes, kinds))
                     if kind in ("sum", "mean")
                     and fes.lane_dtype(nd, schema, dtypes).is_floating_point]
            prog = (fes.program(pred_node, [child_nodes[i] for i in slots], schema, dtypes)
                    if slots else None)
            deep_by_dtypes[key] = slots, prog
        return deep_by_dtypes[key]

    def run(env, codes, n_dev, n):
        b = codes.shape[0]
        idx = torch.arange(b, dtype=torch.int32, device=codes.device)
        inbounds = idx < n_dev
        if pred_run is not None:
            (pv, pm), = pred_run(env)
            sel = pv & pm & inbounds  # invalid predicate rows filter out (SQL WHERE)
        else:
            sel = inbounds
        kernel_ok = (use_kernel and b >= BLOCK_ROWS and b % BLOCK_ROWS == 0
                     and gb <= _ONEHOT_MAX_SEGMENTS)
        deep = (kernel_ok and use_deep and deep_ok
                and all(isinstance(v, tuple) and v[0].dim() == 1 for v in env.values()))
        slots, prog = deep_plan(env) if deep else ([], None)
        # children the kernel does not sum go through their torch closures
        lanes = ([None if i in slots else fn(env) for i, fn in enumerate(child_fns)]
                 if slots else child_run(env))
        fused_sums = []  # (slot in outs, pre-masked float32 column, cnt)
        deep_sums = []  # (slot in outs, cnt), in child order
        outs = []
        for i, (lane, kind, mode) in enumerate(zip(lanes, kinds, modes)):
            if lane is None:
                m = valid_fns[i](env) & sel
                cnt, _ = segment_reduce(m, m, codes, gb, "count")
                deep_sums.append((len(outs), cnt))
                outs.append(None)  # filled from K2 below
                continue
            v, m = lane
            m = m & sel
            if kind == "count":
                contrib = sel if mode == "all" else (sel & ~m if mode == "null" else m)
                cnt, _ = segment_reduce(contrib, contrib, codes, gb, "count")
                outs.append(cnt)
                continue
            if kind in ("sum", "mean"):
                # accumulate in the widest same-class 32-bit dtype
                acc = v.to(torch.float32) if v.is_floating_point() else v.to(torch.int32)
                cnt, _ = segment_reduce(m, m, codes, gb, "count")
                if kernel_ok and acc.is_floating_point():
                    fused_sums.append((len(outs), torch.where(m, acc, 0.0), cnt))
                    outs.append(None)  # filled from the kernel below
                    continue
                vals, valid = segment_reduce(acc, m, codes, gb, "sum")
                if acc.is_floating_point():
                    outs.append((vals, valid, cnt, torch.zeros((), device=codes.device)))
                else:
                    # overflow guard operand: masked max|v| for the host check
                    absv = torch.where(m, v.to(torch.float32).abs(), 0.0)
                    outs.append((vals, valid, cnt, absv.max()))
                continue
            outs.append(segment_reduce(v, m, codes, gb, kind))  # min / max
        if deep_sums:
            sums = fes.fused_expr_sums(prog, codes, env, n, gb)
            if b not in deep_buckets:
                deep_buckets.add(b)
                fes.BUILDS += 1
            for j, (slot, cnt) in enumerate(deep_sums):
                outs[slot] = (sums[:, j], cnt > 0, cnt, torch.zeros((), device=codes.device))
        if fused_sums:
            vk = torch.stack([c for _, c, _ in fused_sums], dim=1)
            sums = segment_sums.masked_segment_sums_padded(
                codes[:, None], sel.to(torch.float32)[:, None], vk, gb)
            for j, (slot, _col, cnt) in enumerate(fused_sums):
                outs[slot] = (sums[:, j], cnt > 0, cnt, torch.zeros((), device=codes.device))
        if pred_run is not None:
            # group-survival data for the resolver's filter pruning
            sel_cnt, _ = segment_reduce(sel, sel, codes, gb, "count")
            first_idx, _ = segment_reduce(idx, sel, codes, gb, "min")
            outs.append((sel_cnt, first_idx))
        return outs

    _AGG_CACHE[key] = run
    return run


def _finish_agg(kind, out, num_groups, expected_dt: DataType, n, dictionary=None):
    """Fetched partials -> host Series of the expected dtype, or None when the
    int32 overflow guard fired and the host must recompute. ``dictionary``
    decodes string min/max code results."""
    import pyarrow as pa
    import pyarrow.compute as pc

    from ..series import Series
    from .device import DeviceColumn

    if kind == "count":
        return Series.from_arrow(pa.array(out[:num_groups].astype(np.uint64)), "o", expected_dt)
    if kind in ("sum", "mean"):
        vals, valid, cnt, max_abs = out
        if np.issubdtype(vals.dtype, np.integer) and float(n) * float(max_abs) >= 2**31 - 1:
            return None  # could have wrapped (guards sum AND mean): host recomputes
        if kind == "mean":
            with np.errstate(invalid="ignore", divide="ignore"):
                mv = vals[:num_groups].astype(np.float64) / cnt[:num_groups].astype(np.float64)
            arr = pa.array(mv, pa.float64())
            if not valid[:num_groups].all():
                arr = pc.if_else(pa.array(valid[:num_groups]), arr,
                                 pa.nulls(num_groups, pa.float64()))
            return Series.from_arrow(arr, "o", expected_dt)
        return unstage(DeviceColumn(vals, valid, num_groups, expected_dt))
    vals, valid = out  # min / max
    return unstage(DeviceColumn(vals, valid, num_groups, expected_dt, dictionary=dictionary))
