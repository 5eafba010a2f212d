"""The 22 TPC-H queries of benchmarks/tpch_queries.py in 3 partitions
through daft_tpu_torch, held against daft_tpu in its 32-bit device mode on
the CPU, with the routing of the exchange between partitions.

At SF0.005 (seed 7), lineitem, orders, customer and partsupp are cut into 3
partitions (the layout of tests/device32/test_tpch_suite32.py). A sort over
them range-shuffles and sorts each range partition, a hash join
hash-shuffles both sides and joins each co-partitioned pair with the
runtime join filter, and a grouped aggregate folds its stage-1 pieces in
the exchange. Every routing counter the port counts, the exchange's
(``exchange_rows``, ``exchange_precombined_rows``) and the join filter's,
equals the reference's, but for the differences pinned in ``PINNED_3P``,
each with its reason; the aggregate routes equal ``TPCH22_ROUTES_3P``,
the table chip_smoke.py holds the card's run to at SF0.005, with the
DeviceHealth breaker closed in both packages (no trip, no degraded
partition). The rows equal
the reference's under tests/test_torch_tpch22.py's rule.
"""

import pytest

from benchmarks import tpch_full, tpch_queries
from chip_smoke import TPCH22_ROUTES_3P, tpch22_module
from test_torch_tpch22 import PORT_COUNTERS, SCALE, _assert_rows_match, _run_both

import daft_tpu_torch

# the exchange's counters and the join filter's, compared beside the routes
EXCHANGE_COUNTERS = ("exchange_rows", "exchange_precombined_rows", "join_filter_built",
                     "join_filter_probe_rows", "join_filter_rows_pruned",
                     "join_filter_device_probes")

# (port, reference) values of the counters that differ in 3 partitions,
# with the reason
PINNED_3P = {
    # the second aggregate groups by c_count, a uint64 count, in each of the
    # 3 partitions of its stage 1 and its stage 2: the port's group codes
    # narrow it to int32 lanes on the card, where the reference's uint32
    # lanes overflow its sentinel and it encodes on the host (the one-
    # partition pin of tests/test_torch_tpch22.py, three times over)
    13: {"device_group_codes": (9, 6)},
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


@pytest.mark.parametrize("qn", sorted(tpch_queries.QUERIES))
def test_routing_counters_match_reference_in_three_partitions(qn, data, port_queries):
    (rd, rc, _rtree), (gd, gc, _gtree) = _run_both(qn, data, port_queries, 3)
    _assert_rows_match(qn, gd, rd)
    pinned = PINNED_3P.get(qn, {})
    names = [k for k in PORT_COUNTERS + EXCHANGE_COUNTERS if k not in pinned]
    assert {k: gc.get(k, 0) for k in names} == {k: rc.get(k, 0) for k in names}
    assert {k: (gc.get(k, 0), rc.get(k, 0)) for k in pinned} == pinned
    assert gc.get("device_agg_fallbacks", 0) == 0
    assert {k: gc.get(k, 0) for k in TPCH22_ROUTES_3P[qn]} == TPCH22_ROUTES_3P[qn]
    # the routes hold with the breaker closed, in both packages
    health = ("device_breaker_trips", "degraded_completions")
    assert {k: gc.get(k, 0) for k in health} == {k: rc.get(k, 0) for k in health} == {
        k: 0 for k in health}
