"""The 22 TPC-H queries of benchmarks/tpch_queries.py through daft_tpu_torch
in its 64-bit device mode (``device_x64=True``), held against daft_tpu in
its own x64 mode, on the CPU, with device kernels on and
``device_min_rows=8`` (tests/test_tpch_suite.py::test_tpch_query_device_mode's
configuration).

The helpers, the scale (SF0.005, seed 7) and the counters are
tests/test_torch_tpch22.py's, imported from there; the row rule is
tests/test_tpch_suite.py's ``_assert_match`` (floats rounded to 2 decimals,
then within max(1e-6 relative, 0.011)), the x64 suite's own:

- in 3 partitions, every query's rows equal the reference's and the
  optimized plans are equal;
- in one partition, every routing counter the port counts equals the
  reference's, but for the pinned differences below, each with its reason,
  the aggregate routes equal the table that chip_smoke.py holds the card's
  phase 6 to (``TPCH22_X64_AGG_ROUTES``), and K1, K2 and the float32
  scatter kernel never run in this mode (the float64 one where a float sum
  has more than 4096 groups: ``SCATTER_F64`` at this scale).
"""

import dataclasses

import jax
import pytest

import daft_tpu
import daft_tpu_torch
from benchmarks import tpch_queries
from chip_smoke import TPCH22_X64_AGG_ROUTES
from daft_tpu.optimizer import optimize as ref_optimize
from daft_tpu_torch.kernels import fused_expr_sums as fes
from daft_tpu_torch.kernels import scatter_sums, segment_sums
from daft_tpu_torch.optimizer import optimize as port_optimize
from test_torch_tpch22 import (PORT_COUNTERS, _frames, _restore_port_config,
                               _round_float_literals, data, port_queries)
from test_tpch_suite import _assert_match
from test_tpch_suite import _rows as _suite_rows

__all__ = ["_restore_port_config", "data", "port_queries"]  # fixtures used by name

# (port, reference) values of the counters that differ, with the reason
PINNED_X64 = {
    # the second aggregate groups by c_count, a uint64 count: the port's
    # group codes run over its int64 bits on the card, where the
    # reference's group-codes kernel takes the uint64 maximum as its
    # sentinel, jax cannot pass that value as an argument (OverflowError),
    # and the reference catches the error and encodes on the host
    13: {"device_group_codes": (2, 1)},
}
# float64 scatter-sum wrapper entries at SF0.005 (aggregates of more than
# 4096 groups there); 0 for every other query
SCATTER_F64 = {18: 1, 20: 1}


def _run_both_x64(qn, data, port_queries, nparts):
    """(reference, port) of one query in the 64-bit mode: each (rows dict,
    counters, optimized plan tree), plus the port's (K1, K2, float32
    scatter, float64 scatter) wrapper entries."""
    from daft_tpu.context import get_context

    assert jax.config.jax_enable_x64
    cfg = get_context().execution_config
    saved = (cfg.use_device_kernels, cfg.device_min_rows)
    cfg.use_device_kernels, cfg.device_min_rows = True, 8
    try:
        df = tpch_queries.QUERIES[qn](_frames(daft_tpu, data, nparts))
        tree = ref_optimize(df._plan).display_tree()
        df = df.collect()
        ref = (df.to_pydict(), df.stats.snapshot()["counters"], tree)
        d = dataclasses.asdict(cfg)
    finally:
        cfg.use_device_kernels, cfg.device_min_rows = saved
    d["jax_enable_x64"] = True
    daft_tpu_torch.set_execution_config(
        daft_tpu_torch.execution_config_from_dict(d, device="cpu"))
    before = (segment_sums.ENTRIES, fes.ENTRIES, scatter_sums.ENTRIES, scatter_sums.ENTRIES_F64)
    df = port_queries.QUERIES[qn](_frames(daft_tpu_torch, data, nparts))
    tree = port_optimize(df._plan).display_tree()
    df = df.collect()
    after = (segment_sums.ENTRIES, fes.ENTRIES, scatter_sums.ENTRIES, scatter_sums.ENTRIES_F64)
    entries = tuple(a - b for a, b in zip(after, before))
    return ref, (df.to_pydict(), df.stats.snapshot()["counters"], tree), entries


def _assert_rows_match(qn, got, want):
    assert list(got) == list(want), f"Q{qn}: columns"
    _assert_match(_suite_rows(got)[0], _suite_rows(want)[0], qn)


@pytest.mark.parametrize("qn", sorted(tpch_queries.QUERIES))
def test_query_matches_reference_in_three_partitions_x64(qn, data, port_queries):
    (rd, _rc, rtree), (gd, _gc, gtree), _e = _run_both_x64(qn, data, port_queries, 3)
    _assert_rows_match(qn, gd, rd)
    assert _round_float_literals(gtree) == _round_float_literals(rtree)


@pytest.mark.parametrize("qn", sorted(tpch_queries.QUERIES))
def test_routing_counters_match_reference_x64(qn, data, port_queries):
    (rd, rc, rtree), (gd, gc, gtree), entries = _run_both_x64(qn, data, port_queries, 1)
    _assert_rows_match(qn, gd, rd)
    assert _round_float_literals(gtree) == _round_float_literals(rtree)
    pinned = PINNED_X64.get(qn, {})
    got = {k: gc.get(k, 0) for k in PORT_COUNTERS if k not in pinned}
    want = {k: rc.get(k, 0) for k in PORT_COUNTERS if k not in pinned}
    assert got == want
    assert {k: (gc.get(k, 0), rc.get(k, 0)) for k in pinned} == pinned
    assert gc.get("device_agg_fallbacks", 0) == 0
    assert (gc.get("device_aggregations", 0), gc.get("host_aggregations", 0)) == \
        TPCH22_X64_AGG_ROUTES[qn]
    # K1, K2 and the float32 scatter never run; float64 sums over more than
    # 4096 groups go through the float64 scatter wrapper
    assert entries[:3] == (0, 0, 0)
    assert entries[3] == SCATTER_F64.get(qn, 0)
