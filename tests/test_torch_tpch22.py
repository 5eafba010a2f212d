"""The 22 TPC-H queries of benchmarks/tpch_queries.py through daft_tpu_torch,
held against daft_tpu in its 32-bit device mode, on the CPU.

The queries' file binds ``col`` and ``lit`` from daft_tpu; the port runs them
through ``chip_smoke.tpch22_module``, which parses the file's text and runs
it with ``col`` and ``lit`` from daft_tpu_torch, so the port never sees the
reference's expressions.

- At SF0.005 (seed 7) in the layout of tests/device32/test_tpch_suite32.py
  (lineitem, orders, customer and partsupp cut into 3 partitions), every
  query's rows equal the reference's under that file's rule (floats rounded
  to 2 decimals, then within max(5e-4 relative, 0.02)), and the optimized
  plan trees are equal (the float literals that Q11, Q15 and Q22 compute in
  an eager subquery, a float aggregate of each package's own, are held to
  the same rounding).
- With one partition per table, every routing counter the port counts
  equals the reference's, but for the pinned differences below, each with
  its reason, and the aggregate and lane routes equal the tables that
  chip_smoke.py holds the card's run to at SF1.
  tests/test_torch_tpch22_partitions.py compares the routing in the
  multi-partition layout.
"""

import dataclasses
import datetime
import re

import pytest

import daft_tpu
import daft_tpu_torch
from benchmarks import tpch_full, tpch_queries
from chip_smoke import TPCH22_AGG_ROUTES, TPCH22_LANE_MAPS, tpch22_module
from daft_tpu.optimizer import optimize as ref_optimize
from daft_tpu_torch.optimizer import optimize as port_optimize
from device_mode import real_tpu_mode_cfg

SCALE = 0.005

# every routing counter the port bumps (daft_tpu_torch/execution.py, physical.py,
# fuse/, kernels/device_agg.py)
PORT_COUNTERS = (
    "broadcast_joins", "cse_hits", "device_agg_fallbacks", "device_aggregations",
    "device_distincts", "device_filter_dispatches", "device_filters",
    "device_fused_map_dispatches", "device_fused_map_fallbacks", "device_fused_maps",
    "device_group_codes", "device_handoffs_elided", "device_join_dispatches",
    "device_join_probes", "device_projection_dispatches", "device_projections",
    "device_resident_segments", "device_sorts", "fused_chains", "fused_ops_eliminated",
    "handoffs_elided", "host_aggregations", "host_distincts", "host_filters",
    "host_fused_maps", "host_joins", "host_projections", "host_sorts", "resident_segments",
    "segment_compiles", "segment_dispatches", "segment_fallbacks", "shuffles",
)

# (port, reference) values of the counters that differ, with the reason
PINNED = {
    # the second aggregate groups by c_count, a uint64 count: the port's group
    # codes narrow it to int32 lanes on the card, where the reference's uint32
    # lanes overflow its sentinel and it catches the error and encodes on the host
    13: {"device_group_codes": (2, 1)},
}


@pytest.fixture(autouse=True)
def _restore_port_config():
    ctx = daft_tpu_torch.get_context()
    saved = ctx.execution_config
    yield
    ctx.execution_config = saved


@pytest.fixture(scope="module")
def data():
    return tpch_full.generate(scale=SCALE, seed=7)


@pytest.fixture(scope="module")
def port_queries():
    return tpch22_module()


def _frames(pkg, data, nparts):
    out = {}
    for name, tbl in data.items():
        df = pkg.from_arrow(tbl)
        if nparts > 1 and name in ("lineitem", "orders", "customer", "partsupp"):
            df = df.into_partitions(nparts)
        out[name] = df
    return out


def _run_both(qn, data, port_queries, nparts):
    """(reference, port) of one query: each (rows dict, counters, optimized
    plan tree), the port under the reference's configuration with
    device="cpu"."""
    with real_tpu_mode_cfg() as cfg:
        df = tpch_queries.QUERIES[qn](_frames(daft_tpu, data, nparts))
        tree = ref_optimize(df._plan).display_tree()
        df = df.collect()
        ref = (df.to_pydict(), df.stats.snapshot()["counters"], tree)
        d = dataclasses.asdict(cfg)
    d["jax_enable_x64"] = False
    daft_tpu_torch.set_execution_config(
        daft_tpu_torch.execution_config_from_dict(d, device="cpu"))
    df = port_queries.QUERIES[qn](_frames(daft_tpu_torch, data, nparts))
    tree = port_optimize(df._plan).display_tree()
    df = df.collect()
    return ref, (df.to_pydict(), df.stats.snapshot()["counters"], tree)


def _norm(v):
    if isinstance(v, float):
        return round(v, 2)
    if isinstance(v, (datetime.date, datetime.datetime)):
        return v.isoformat()[:10]
    return v


def _rows(d):
    def key(r):
        return tuple((x is None, repr(type(x)), x if x is not None else 0) for x in r)

    return sorted([tuple(_norm(v) for v in row) for row in zip(*d.values())], key=key)


def _assert_rows_match(qn, got, want):
    g, w = _rows(got), _rows(want)
    assert list(got) == list(want), f"Q{qn}: columns"
    assert len(g) == len(w), f"Q{qn}: {len(g)} rows vs {len(w)}"
    for i, (a, b) in enumerate(zip(g, w)):
        for x, y in zip(a, b):
            if isinstance(x, float) or isinstance(y, float):
                assert x is not None and y is not None and \
                    abs(float(x) - float(y)) <= max(5e-4 * abs(float(y)), 0.02), \
                    f"Q{qn} row {i}: {a} vs {b}"
            else:
                assert x == y, f"Q{qn} row {i}: {a} vs {b}"


def _round_float_literals(tree: str) -> str:
    return re.sub(r"lit\((-?\d+\.\d+(?:e-?\d+)?)\)",
                  lambda m: f"lit({round(float(m.group(1)), 2)})", tree)


@pytest.mark.parametrize("qn", sorted(tpch_queries.QUERIES))
def test_query_matches_reference_in_three_partitions(qn, data, port_queries):
    (rd, _rc, rtree), (gd, _gc, gtree) = _run_both(qn, data, port_queries, 3)
    _assert_rows_match(qn, gd, rd)
    assert _round_float_literals(gtree) == _round_float_literals(rtree)


@pytest.mark.parametrize("qn", sorted(tpch_queries.QUERIES))
def test_routing_counters_match_reference(qn, data, port_queries):
    (rd, rc, rtree), (gd, gc, gtree) = _run_both(qn, data, port_queries, 1)
    _assert_rows_match(qn, gd, rd)
    assert _round_float_literals(gtree) == _round_float_literals(rtree)
    pinned = PINNED.get(qn, {})
    got = {k: gc.get(k, 0) for k in PORT_COUNTERS if k not in pinned}
    want = {k: rc.get(k, 0) for k in PORT_COUNTERS if k not in pinned}
    assert got == want
    assert {k: (gc.get(k, 0), rc.get(k, 0)) for k in pinned} == pinned
    # the new lanes run on the card: no aggregate of these queries declines
    assert gc.get("device_agg_fallbacks", 0) == 0
    assert (gc.get("device_aggregations", 0), gc.get("host_aggregations", 0)) == \
        TPCH22_AGG_ROUTES[qn]
    if qn in TPCH22_LANE_MAPS:
        assert (gc.get("device_fused_maps", 0), gc.get("host_fused_maps", 0)) == \
            TPCH22_LANE_MAPS[qn]
