"""The port's TPC-H Q1/Q6 slice held against daft_tpu in its 32-bit device
mode, on the CPU.

The same pyarrow tables (made from a seed) go through both packages under
one configuration: daft_tpu under tests/device_mode.real_tpu_mode_cfg (x64
off, device kernels on, the Pallas kernel in interpret mode), the port under
execution_config_from_dict(...) of that config with device="cpu" (the segment
sums take their plain version). Keys, group order and counts must match
exactly; float aggregates agree at rtol 1e-6 (both sides sum in float32 with
compensation, in different orders); both packages also match the pyarrow
oracle at rtol 1e-6.
"""

import dataclasses
import datetime
import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch
from benchmarks import tpch
from chip_smoke import parity, q1 as port_q1, q6 as port_q6
from daft_tpu_torch.kernels import segment_sums
from device_mode import real_tpu_mode_cfg

ROWS = 20_000
RTOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lineitem():
    return tpch.generate_lineitem_only(scale=ROWS / tpch.LINEITEM_ROWS_PER_SF, seed=7)


def _keyed_table(seed=3, n=5000):
    rng = np.random.RandomState(seed)
    v = rng.rand(n) * 100
    w = rng.randint(-1000, 1000, n)
    return pa.table({
        "k": pa.array(rng.randint(0, 6, n), pa.int64()),
        "v": pa.array(v, mask=rng.rand(n) < 0.1),
        "w": pa.array(w, pa.int64(), mask=rng.rand(n) < 0.1),
    })


def _jax_keyed(frame, which):
    from daft_tpu import col

    return _keyed_query(frame, col, which)


def _port_keyed(frame, which):
    from daft_tpu_torch import col

    return _keyed_query(frame, col, which)


def _keyed_query(frame, col, which):
    aggs = (col("v").sum().alias("sv"), col("v").mean().alias("mv"),
            col("v").count().alias("cv"), col("v").min().alias("lo"),
            col("v").max().alias("hi"), col("w").sum().alias("sw"))
    if which == "grouped_nulls":
        return frame.groupby("k").agg(*aggs)
    if which == "filter_empties_group":
        # k == 2 loses every row: the device path must drop that group and
        # keep the survivors in first-selected-row order
        return frame.where((col("k") != 2) & (col("v") > 10.0)).groupby("k").agg(*aggs)
    if which == "ungrouped":
        return frame.where(col("v") < 50.0).agg(*aggs)
    raise AssertionError(which)


def _run_both(table, jax_query, port_query, segment_sums_kernel=True):
    """Run one query through both packages under one configuration. Returns
    ((jax_result, jax_counters), (port_result, port_counters), entries)."""
    with real_tpu_mode_cfg(device_min_rows=8) as cfg:
        import jax

        saved = cfg.use_pallas_segment_sums
        cfg.use_pallas_segment_sums = segment_sums_kernel
        try:
            ref = jax_query(daft_tpu.from_arrow(table).collect()).collect()
            ref_out = ref.to_pydict(), ref.stats.snapshot()["counters"]
            d = dataclasses.asdict(cfg)
        finally:
            cfg.use_pallas_segment_sums = saved
        d["jax_enable_x64"] = bool(jax.config.jax_enable_x64)
    port_cfg = daft_tpu_torch.execution_config_from_dict(d, device="cpu")
    assert not port_cfg.device_x64 and port_cfg.use_device_kernels
    daft_tpu_torch.set_execution_config(port_cfg)
    before = segment_sums.ENTRIES
    got = port_query(daft_tpu_torch.from_arrow(table).collect()).collect()
    return ref_out, (got.to_pydict(), got.stats.snapshot()["counters"]), segment_sums.ENTRIES - before


def _assert_same(ref: dict, got: dict):
    assert list(got) == list(ref)
    for name in ref:
        a, b = got[name], ref[name]
        assert len(a) == len(b), name
        if any(isinstance(x, float) for x in b):
            assert [x is None for x in a] == [x is None for x in b], name
            np.testing.assert_allclose(
                np.array([np.nan if x is None else x for x in a], dtype=float),
                np.array([np.nan if x is None else x for x in b], dtype=float),
                rtol=RTOL, err_msg=name)
        else:
            assert a == b, name  # keys, group order, counts, int sums: exact


@pytest.mark.parametrize("query", ["q1", "q6"])
def test_tpch_query_matches_reference(lineitem, query):
    jax_q, port_q = {"q1": (tpch.q1, port_q1), "q6": (tpch.q6, port_q6)}[query]
    (ref, ref_c), (got, got_c), entries = _run_both(lineitem, jax_q, port_q)
    _assert_same(ref, got)
    oracle = (tpch.oracle_q1(lineitem) if query == "q1"
              else {"revenue": [tpch.oracle_q6(lineitem)]})
    assert parity(ref, oracle, RTOL) and parity(got, oracle, RTOL)
    assert ref_c.get("device_aggregations") == 1 == got_c.get("device_aggregations")
    assert got_c.get("device_agg_fallbacks", 0) == 0
    if query == "q1":
        assert ref_c.get("device_group_codes") == 1 == got_c.get("device_group_codes")
    assert entries == 1  # every float sum of the query in one K1 call


@pytest.mark.parametrize("kernel", [True, False], ids=["segment_sums_kernel", "onehot_sums"])
@pytest.mark.parametrize("which", ["grouped_nulls", "filter_empties_group", "ungrouped"])
def test_keyed_queries_match_reference(which, kernel):
    # kernel=False sends the float sums through segment_reduce's one-hot
    # sums with the Kahan combine across chunks instead of K1, on both sides
    table = _keyed_table()
    (ref, ref_c), (got, got_c), entries = _run_both(
        table, lambda f: _jax_keyed(f, which), lambda f: _port_keyed(f, which), kernel)
    _assert_same(ref, got)
    assert ref_c.get("device_aggregations") == 1 == got_c.get("device_aggregations")
    assert entries == int(kernel)
    if which == "filter_empties_group":
        assert 2 not in got["k"] and len(got["k"]) == 5
    # and the host path of the port agrees with the device path
    daft_tpu_torch.set_execution_config(use_device_kernels=False)
    host = _port_keyed(daft_tpu_torch.from_arrow(table).collect(), which).collect()
    assert host.stats.snapshot()["counters"].get("host_aggregations") == 1
    _assert_same(host.to_pydict(), got)


def test_multi_partition_input_aggregates_in_two_stages():
    # both packages aggregate each partition (stage 1), hash-shuffle the
    # partials by key, and merge them (stage 2): results agree with group
    # order exact (buckets in order, first occurrence within each), and the
    # counters of the plan's route are the reference's
    table = _keyed_table(seed=5)
    parts = [table.slice(0, 2000), table.slice(2000)]
    (ref, ref_c), (got, got_c), entries = _run_both(
        parts, lambda f: _jax_keyed(f, "grouped_nulls"),
        lambda f: _port_keyed(f, "grouped_nulls"))
    _assert_same(ref, got)
    route = ("shuffles", "device_aggregations", "host_aggregations")
    assert {k: got_c.get(k, 0) for k in route} == {k: ref_c.get(k, 0) for k in route}
    assert got_c["shuffles"] == 1 and got_c["device_aggregations"] >= 2
    # one K1 call for the float sums of each aggregation on the card
    assert entries == got_c["device_aggregations"]


def test_config_maps_reference_knobs():
    from daft_tpu.context import ExecutionConfig as RefConfig

    d = dataclasses.asdict(RefConfig(use_device_kernels=True, device_min_rows=8,
                                     use_pallas_segment_sums=False))
    d["jax_enable_x64"] = False
    cfg = daft_tpu_torch.execution_config_from_dict(d, device="cpu")
    assert (cfg.use_device_kernels, cfg.device_min_rows, cfg.use_segment_sums_kernel,
            cfg.device_x64, cfg.device) == (True, 8, False, False, "cpu")
    # the fusion knobs map with the reference's defaults and settings
    assert (cfg.use_deep_fusion_kernel, cfg.expr_fusion, cfg.device_residency) == (
        False, True, True)
    cfg = daft_tpu_torch.execution_config_from_dict(
        {**d, "use_pallas_deep_fusion": True, "expr_fusion": False, "device_residency": False})
    assert (cfg.use_deep_fusion_kernel, cfg.expr_fusion, cfg.device_residency) == (
        True, False, False)
    # jax_enable_x64 maps onto the 64-bit device mode; full-width float64
    # (device_reduced_precision off) has a counterpart only there
    assert daft_tpu_torch.execution_config_from_dict({**d, "jax_enable_x64": True}).device_x64
    cfg = daft_tpu_torch.execution_config_from_dict(
        {**d, "jax_enable_x64": True, "device_reduced_precision": False})
    assert cfg.device_x64
    with pytest.raises(NotImplementedError):
        daft_tpu_torch.execution_config_from_dict({**d, "device_reduced_precision": False})


def test_default_cuda_raises_without_card():
    # the port's entry points default to the card; asking for it where torch
    # sees none raises instead of running on the CPU
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    daft_tpu_torch.set_execution_config(daft_tpu_torch.ExecutionConfig(device_min_rows=8))
    frame = daft_tpu_torch.from_pydict({"k": [1, 2, 1] * 10, "v": [1.0, 2.0, 3.0] * 10})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        frame.groupby("k").agg(daft_tpu_torch.col("v").sum()).collect()


def test_import_leaves_jax_and_reference_out():
    # every module of the port and chip_smoke.py, then a deep-fused query
    # through a device-resident plan segment
    code = (
        "import importlib, pkgutil, sys, daft_tpu_torch as d, chip_smoke\n"
        "for m in pkgutil.walk_packages(d.__path__, 'daft_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "d.set_execution_config(device='cpu', device_min_rows=1, use_deep_fusion_kernel=True)\n"
        "r = d.from_pydict({'k': [1, 2, 1], 'v': [1.0, 2.0, 3.0]})"
        ".with_column('w', d.col('v') * 2).where(d.col('w') > 1)"
        ".groupby('k').agg(d.col('w').sum().alias('s')).collect()\n"
        "assert r.to_pydict() == {'k': [1, 2], 's': [8.0, 4.0]}, r.to_pydict()\n"
        "c = r.stats.snapshot()['counters']\n"
        "assert c.get('device_resident_segments') == 1, c\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'daft_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_port_sources_import_neither_jax_nor_reference():
    import ast

    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, names in os.walk(os.path.join(REPO, "daft_tpu_torch")):
        # kernels/build/ holds build outputs (and may hold a checkout copy
        # for a chip run), not sources of the port
        dirs[:] = [d for d in dirs if os.path.join(root, d) != os.path.join(
            REPO, "daft_tpu_torch", "kernels", "build")]
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert any(f.endswith(os.path.join("fuse", "segment.py")) for f in files)
    assert any(f.endswith("fused_expr_sums.py") for f in files)
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("jax", "jaxlib", "daft_tpu"), (path, m)


@pytest.fixture(autouse=True)
def _restore_port_config():
    saved = daft_tpu_torch.get_context().execution_config
    yield
    daft_tpu_torch.set_execution_config(saved)


def test_dates_compare_as_epoch_days():
    # Q1's date literal compares against int32 epoch days on the device
    d0 = datetime.date(1998, 9, 1)
    table = pa.table({"d": pa.array([d0, d0 + datetime.timedelta(days=2)] * 8),
                      "v": pa.array([1.0, 2.0] * 8)})
    from daft_tpu_torch import col

    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=1)
    got = (daft_tpu_torch.from_arrow(table).where(col("d") <= datetime.date(1998, 9, 2))
           .agg(col("v").sum().alias("s")).collect())
    assert got.to_pydict() == {"s": [8.0]}
    assert got.stats.snapshot()["counters"].get("device_aggregations") == 1
