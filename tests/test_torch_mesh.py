"""The mesh runner (daft_tpu_torch/parallel/) against daft_tpu/parallel/ on
the CPU: tests/test_mesh.py's cases through both packages on the same seeded
inputs, the reference on its ``default_mesh(8)`` (8 virtual CPU devices),
the port on ``default_mesh(8)`` with ``device="cpu"`` (8 CPU slots), in the
32-bit mode and in x64.

Held equal: ``_scatter_to_slabs``'s and ``build_exchange``'s slabs bit for
bit, ``build_exchange_groupby_sum``'s counts (its sums within rtol 1e-6 in
the 32-bit mode, 1e-12 in x64), each output partition's rows, and the
exchange, join and replica counters. Also the three collective-breaker
cases of tests/test_faults.py, the steps of ``__graft_entry__``'s
``dryrun_multichip``, and the pinned differences: the breaker's narrower
catch and the slot wrap of ``default_mesh(n)``.
"""

import dataclasses
from contextlib import contextmanager

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch
from device_mode import real_tpu_mode_cfg
from torch_parity import assert_same_rows, fresh_ledgers_and_faults, restore_port_config  # noqa: F401

MODES = [pytest.param(False, id="32bit"), pytest.param(True, id="x64")]

# the counters each query case holds equal in both packages
MESH_COUNTERS = ("device_shuffles", "exchange_rows", "exchange_bytes",
                 "exchange_precombined_rows", "shuffles", "broadcast_replications",
                 "device_aligned_smj_exchanges", "aligned_boundary_shuffles",
                 "device_join_probes", "host_joins", "broadcast_joins",
                 "collective_breaker_trips", "degraded_shuffles")


@pytest.fixture(autouse=True)
def _fresh():
    fresh_ledgers_and_faults()
    yield
    fresh_ledgers_and_faults()


@contextmanager
def modes(x64: bool, min_rows: int = 8, **knobs):
    """The reference's config for the mode (x64: its default; 32-bit: the
    real-TPU recipe), with ``knobs`` set, and the port's mapped from it."""
    from daft_tpu.context import get_context

    knobs = {"enable_result_cache": False, **knobs}

    @contextmanager
    def ref_cfg():
        if x64:
            yield get_context().execution_config
        else:
            with real_tpu_mode_cfg(device_min_rows=min_rows) as c:
                yield c

    with ref_cfg() as cfg:
        saved = {k: getattr(cfg, k) for k in knobs}
        for k, v in knobs.items():
            setattr(cfg, k, v)
        try:
            d = dataclasses.asdict(cfg)
            d["jax_enable_x64"] = x64
            daft_tpu_torch.set_execution_config(
                daft_tpu_torch.execution_config_from_dict(d, device="cpu"))
            yield cfg
        finally:
            for k, v in saved.items():
                setattr(cfg, k, v)


@contextmanager
def _jax_x64(x64: bool):
    import jax

    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", x64)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def run_mesh(pkg, df):
    """The frame's plan through the package's MeshExecutionContext on an
    8-slot mesh: (partitions, counters)."""
    if pkg is daft_tpu:
        from daft_tpu.execution import execute_plan
        from daft_tpu.optimizer import optimize
        from daft_tpu.parallel import MeshExecutionContext, default_mesh
        from daft_tpu.physical import translate

        cfg = daft_tpu.context.get_context().execution_config
    else:
        from daft_tpu_torch.execution import execute_plan
        from daft_tpu_torch.optimizer import optimize
        from daft_tpu_torch.parallel import MeshExecutionContext, default_mesh
        from daft_tpu_torch.physical import translate

        cfg = daft_tpu_torch.get_context().execution_config
    ctx = MeshExecutionContext(cfg, mesh=default_mesh(8))
    parts = list(execute_plan(translate(optimize(df._plan), cfg), ctx))
    c = ctx.stats.snapshot()["counters"]
    return parts, {k: c.get(k, 0) for k in MESH_COUNTERS}


def check_mesh(build, x64: bool, rtol: float = 0.0, per_partition: bool = True,
               ordered: bool = False, engaged: bool = True, apart=(), **knobs):
    """``build(pkg)`` through both packages' mesh contexts: equal partition
    counts, equal rows per partition (or over all with ``per_partition``
    off; in order with ``ordered``), equal counters but those in ``apart``
    (which the caller holds). Returns the port's (partitions, counters) and
    the reference's counters."""
    with modes(x64, **knobs):
        ref_parts, ref_c = run_mesh(daft_tpu, build(daft_tpu))
        got_parts, got_c = run_mesh(daft_tpu_torch, build(daft_tpu_torch))
    assert len(got_parts) == len(ref_parts)
    if ordered:
        got = pa.concat_tables([p.to_arrow() for p in got_parts]).to_pydict()
        ref = pa.concat_tables([p.to_arrow() for p in ref_parts]).to_pydict()
        assert_same_rows(got, ref, rtol, ordered=True)
    elif per_partition:
        for gp, rp in zip(got_parts, ref_parts):
            assert_same_rows(gp.to_pydict(), rp.to_pydict(), rtol)
    else:
        assert_same_rows(pa.concat_tables([p.to_arrow() for p in got_parts]).to_pydict(),
                         pa.concat_tables([p.to_arrow() for p in ref_parts]).to_pydict(), rtol)
    assert {k: v for k, v in got_c.items() if k not in apart} == {
        k: v for k, v in ref_c.items() if k not in apart}
    if engaged:
        assert got_c["device_shuffles"] >= 1, got_c
    return got_parts, got_c, ref_c


def _s(pkg, vals, name="s"):
    return pkg.Series.from_pylist(vals, name, pkg.DataType.string())


# ---------------------------------------------------------------------------
# K12: the slabs, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x64", MODES)
@pytest.mark.parametrize("r,cap,nb", [(256, 128, 8), (256, 16, 8), (300, 128, 11), (3, 128, 8)],
                         ids=["basic", "over-capacity", "num>n", "fewer-rows-than-devices"])
def test_scatter_to_slabs_bit_equal(x64, r, cap, nb):
    import jax
    import jax.numpy as jnp
    import torch

    from daft_tpu.parallel.collectives import _scatter_to_slabs as ref_scatter
    from daft_tpu_torch.parallel.collectives import _scatter_to_slabs

    n = 8
    rng = np.random.RandomState(r + cap + nb)
    lane = rng.randint(0, nb, r).astype(np.int32)
    bucket = (lane % n).astype(np.int32)
    valid = rng.rand(r) < 0.9
    ints = rng.randint(-1000, 1000, r).astype(np.int64 if x64 else np.int32)
    flts = rng.randn(r).astype(np.float64 if x64 else np.float32)
    emb = rng.rand(r, 4).astype(np.float32)
    flags = rng.rand(r) < 0.5
    cols = [ints, flts, emb, flags, lane]
    with _jax_x64(x64):
        want_v, want = ref_scatter(jnp.asarray(bucket), jnp.asarray(valid),
                                   [jnp.asarray(c) for c in cols], n, cap)
        want_v = np.asarray(want_v)
        want = [np.asarray(w) for w in want]
    got_v, got = _scatter_to_slabs(torch.from_numpy(bucket), torch.from_numpy(valid),
                                   [torch.from_numpy(c) for c in cols], n, cap)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("x64", MODES)
def test_build_exchange_slabs_bit_equal(x64):
    """tests/test_mesh.py test_exchange_roundtrip_preserves_rows through
    both packages: the received valid and column slabs are equal."""
    import jax

    from daft_tpu.parallel import default_mesh as ref_mesh
    from daft_tpu.parallel.collectives import build_exchange as ref_build
    from daft_tpu.parallel.collectives import exchange_capacity as ref_cap
    from daft_tpu.parallel.collectives import shard_to_mesh as ref_shard
    from daft_tpu_torch.parallel import default_mesh
    from daft_tpu_torch.parallel.collectives import build_exchange, exchange_capacity, shard_to_mesh

    n, r = 8, 256
    rng = np.random.RandomState(0)
    vals = rng.randint(0, 1000, size=(n, r)).astype(np.int64 if x64 else np.int32)
    emb = rng.rand(n, r, 3).astype(np.float32)
    bucket = (vals % n).astype(np.int32)
    valid = rng.rand(n, r) < 0.9
    cap = exchange_capacity([bucket[i][valid[i]] for i in range(n)], [None] * n, n)
    assert cap == ref_cap([bucket[i][valid[i]] for i in range(n)], [None] * n, n)
    with _jax_x64(x64):
        m = ref_mesh(8)
        fn = ref_build(m, cap, (vals.dtype, emb.dtype), ((), (3,)))
        want = [np.asarray(jax.device_get(o)) for o in fn(
            ref_shard(bucket, m), ref_shard(valid, m), ref_shard(vals, m), ref_shard(emb, m))]
    with modes(x64):
        mesh = default_mesh(8)
        got = build_exchange(mesh, cap)(
            shard_to_mesh(bucket, mesh), shard_to_mesh(valid, mesh),
            shard_to_mesh(vals, mesh), shard_to_mesh(emb, mesh))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.stack([t.numpy() for t in g]), w)
    # every received row belongs to its slot, and none is lost
    rv, rc = np.stack([t.numpy() for t in got[0]]), np.stack([t.numpy() for t in got[1]])
    for d in range(n):
        assert (rc[d].reshape(-1)[rv[d].reshape(-1)] % n == d).all()
    assert sorted(rc[rv].tolist()) == sorted(vals[valid].tolist())


@pytest.mark.parametrize("x64", MODES)
def test_exchange_groupby_sum_counts_exact_sums_close(x64):
    """``__graft_entry__.dryrun_multichip`` step 1 through both packages."""
    import jax

    from daft_tpu.parallel import default_mesh as ref_mesh
    from daft_tpu.parallel.collectives import build_exchange_groupby_sum as ref_build
    from daft_tpu.parallel.collectives import shard_to_mesh as ref_shard
    from daft_tpu_torch.kernels import scatter_sums
    from daft_tpu_torch.parallel import default_mesh
    from daft_tpu_torch.parallel.collectives import (build_exchange_groupby_sum,
                                                     exchange_capacity, shard_to_mesh)

    n, rows, groups = 8, 64, 24
    rng = np.random.RandomState(0)
    codes = rng.randint(0, groups, size=(n, rows)).astype(np.int32)
    values = rng.rand(n, rows).astype(np.float64 if x64 else np.float32)
    bucket = (codes % n).astype(np.int32)
    valid = np.ones((n, rows), dtype=bool)
    cap = exchange_capacity(list(bucket), [None] * n, n)
    with _jax_x64(x64):
        m = ref_mesh(8)
        ws, wc = ref_build(m, cap, groups)(ref_shard(bucket, m), ref_shard(valid, m),
                                           ref_shard(codes, m), ref_shard(values, m))
        ws, wc = np.asarray(jax.device_get(ws)), np.asarray(jax.device_get(wc))
    with modes(x64):
        mesh = default_mesh(8)
        entries = (scatter_sums.ENTRIES, scatter_sums.ENTRIES_F64)
        gs, gc = build_exchange_groupby_sum(mesh, cap, groups)(
            shard_to_mesh(bucket, mesh), shard_to_mesh(valid, mesh),
            shard_to_mesh(codes, mesh), shard_to_mesh(values, mesh))
        # every slot's float sums went through the scatter kernel's wrapper
        moved = (scatter_sums.ENTRIES_F64 - entries[1]) if x64 else (
            scatter_sums.ENTRIES - entries[0])
        assert moved == n
    gs, gc = np.stack([t.numpy() for t in gs]), np.stack([t.numpy() for t in gc])
    assert gc.dtype == wc.dtype == np.int32
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_allclose(gs, ws, rtol=1e-12 if x64 else 1e-6)
    want = np.zeros(groups)
    np.add.at(want, codes.reshape(-1), values.reshape(-1).astype(np.float64))
    got = np.array([gs[g % n, g] for g in range(groups)])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert [gc[g % n, g] for g in range(groups)] == np.bincount(
        codes.reshape(-1), minlength=groups).tolist()


# ---------------------------------------------------------------------------
# the shuffle through MeshExecutionContext (tests/test_mesh.py's queries)
# ---------------------------------------------------------------------------

def _hash8(pkg):
    return pkg.from_pydict({"k": np.arange(4000) % 37,
                            "v": np.arange(4000, dtype=np.float64)}).repartition(8, pkg.col("k"))


def _random8(pkg):
    return pkg.from_pydict({"k": np.arange(4000) % 37,
                            "v": np.arange(4000, dtype=np.float64)}).repartition(8)


def _null_keys(pkg):
    return pkg.from_pydict({
        "k": pa.array([1, None, 3, None, 5, 6, 7, 8] * 64, pa.int64()),
        "v": pa.array(np.arange(512, dtype=np.int32))}).repartition(8, pkg.col("k"))


def _string_payload(pkg):
    svals = [None if i % 31 == 0 else f"row{i % 97}" for i in range(400)]
    return pkg.from_pydict({"k": [1, 2, None, 4, 5, None, 7, 8] * 50,
                            "s": _s(pkg, svals)}).repartition(8, pkg.col("k"))


def _fewer_rows(pkg):
    return pkg.from_pydict({"k": [1, 2, 3], "v": [1.0, 2.0, 3.0]}).repartition(8, pkg.col("k"))


def _num(num):
    def build(pkg):
        return pkg.from_pydict({"k": np.arange(3000) % 41,
                                "v": np.arange(3000, dtype=np.float64)}
                               ).repartition(num, pkg.col("k"))
    return build


SHUFFLES = [pytest.param(_hash8, id="hash"), pytest.param(_random8, id="random"),
            pytest.param(_null_keys, id="null-keys"),
            pytest.param(_string_payload, id="string-payload"),
            pytest.param(_fewer_rows, id="fewer-rows-than-devices"),
            pytest.param(_num(5), id="num5"), pytest.param(_num(11), id="num11")]


@pytest.mark.parametrize("x64", MODES)
@pytest.mark.parametrize("build", SHUFFLES)
def test_mesh_shuffle_partitions_equal(build, x64):
    check_mesh(build, x64)


def _sort_ab(pkg):
    rng = np.random.RandomState(3)
    return (pkg.from_pydict({"a": rng.randint(0, 1000, 2000), "b": rng.randn(2000)})
            .repartition(4).sort([pkg.col("a"), pkg.col("b")]))


def _sort_desc_nulls(pkg):
    vals = [5, None, 3, 9, None, 1, 7, 2] * 128
    return (pkg.from_pydict({"a": pa.array(vals, pa.int64()),
                             "i": np.arange(len(vals), dtype=np.int64)})
            .repartition(8).sort([pkg.col("a"), pkg.col("i")], desc=[True, False]))


def _sort_string_key(pkg):
    rng = np.random.RandomState(13)
    words = [None if i % 29 == 0 else f"w{rng.randint(0, 200):03d}" for i in range(1500)]
    return (pkg.from_pydict({"s": _s(pkg, words), "v": np.arange(1500, dtype=np.int64)})
            .repartition(4).sort([pkg.col("s"), pkg.col("v")]))


@pytest.mark.parametrize("x64", MODES)
@pytest.mark.parametrize("build", [pytest.param(_sort_ab, id="int-float"),
                                   pytest.param(_sort_desc_nulls, id="descending-nulls"),
                                   pytest.param(_sort_string_key, id="string-key")])
def test_mesh_global_sort_equal(build, x64):
    # the range exchange and per-partition sorts are the global order
    check_mesh(build, x64, ordered=True)


@pytest.mark.parametrize("x64", MODES)
def test_mesh_groupby_agg_equal(x64):
    def build(pkg):
        rng = np.random.RandomState(7)
        col = pkg.col
        return (pkg.from_pydict({"g": rng.randint(0, 50, size=5000), "x": rng.randn(5000),
                                 "y": rng.randint(0, 100, size=5000)})
                .repartition(8).groupby(col("g"))
                .agg(col("x").sum().alias("sx"), col("y").mean().alias("my"),
                     col("x").count().alias("c")).sort(col("g")))

    # the reference's stage-1 partials of one partition carry validity
    # bitmaps that the port's do not (in x64: 100 bytes over the 400 partial
    # rows of the hash exchange), so exchange_bytes is held apart, to at
    # most a bitmap per column of what crossed
    _, c, ref_c = check_mesh(build, x64, rtol=1e-12 if x64 else 1e-5, ordered=True,
                             apart=("exchange_bytes",))
    gap = ref_c["exchange_bytes"] - c["exchange_bytes"]
    assert 0 <= gap <= 4 * -(-c["exchange_rows"] // 8), (gap, c)


@pytest.mark.parametrize("x64", MODES)
def test_mesh_high_cardinality_string_declines(x64, monkeypatch):
    import daft_tpu.parallel.mesh_exec as ref_me
    import daft_tpu_torch.parallel.mesh_exec as me

    monkeypatch.setattr(ref_me, "_STRING_DICT_CAP", 16)
    monkeypatch.setattr(me, "_STRING_DICT_CAP", 16)

    def build(pkg):
        return pkg.from_pydict({"k": [1, 2, 3, 4] * 50,
                                "s": [f"unique-{i}" for i in range(200)]}
                               ).repartition(8, pkg.col("k"))

    _, c, _ = check_mesh(build, x64, engaged=False)
    assert c["device_shuffles"] == 0 and c["shuffles"] == 1


@pytest.mark.parametrize("x64", MODES)
def test_mesh_int64_overflow_declines(x64):
    def build(pkg):
        big = np.array([2**40 + i for i in range(512)], dtype=np.int64)
        return pkg.from_pydict({"k": big, "v": np.arange(512, dtype=np.float64)}
                               ).repartition(8, pkg.col("k"))

    _, c, _ = check_mesh(build, x64, engaged=x64)
    # the 32-bit mode's int32 guard declines the exchange; x64 ships it
    assert c["device_shuffles"] == (1 if x64 else 0)


@pytest.mark.parametrize("x64", MODES)
def test_mesh_embedding_column_empty_destinations(x64):
    """An embedding column rides the exchange as a 2-D lane in both
    packages: the shuffled partitions (six of the eight destinations
    empty) come back with equal rows and one device shuffle each."""
    outs, shuffles = [], []
    for pkg in (daft_tpu, daft_tpu_torch):
        emb = pa.FixedSizeListArray.from_arrays(pa.array(np.arange(24, dtype=np.float32)), 4)
        s = pkg.Series.from_arrow(emb, "e", pkg.DataType.embedding(pkg.DataType.float32(), 4))
        t = pkg.Table(pkg.Schema([pkg.Field("k", pkg.DataType.int64()), pkg.Field("e", s.dtype)]),
                      [pkg.Series.from_pylist([1, 1, 1, 2, 2, 2], "k"), s])
        with modes(x64):
            if pkg is daft_tpu:
                from daft_tpu.micropartition import MicroPartition
                from daft_tpu.parallel import MeshExecutionContext, default_mesh

                cfg = daft_tpu.context.get_context().execution_config
            else:
                from daft_tpu_torch.micropartition import MicroPartition
                from daft_tpu_torch.parallel import MeshExecutionContext, default_mesh

                cfg = daft_tpu_torch.get_context().execution_config
            ctx = MeshExecutionContext(cfg, mesh=default_mesh(8))
            out = ctx.try_device_shuffle([MicroPartition.from_table(t)], [pkg.col("k")], 8,
                                         "hash")
        assert out is not None
        outs.append([p.to_pydict() for p in out])
        shuffles.append(ctx.stats.counters.get("device_shuffles", 0))
    assert outs[0] == outs[1]
    assert shuffles[0] == shuffles[1] == 1
    assert sum(len(p["k"]) for p in outs[1]) == 6


def test_mesh_shuffle_seeds_the_stage_cache():
    """Every output's columns are cached under the key device ops look up,
    in the packed layout (validity False past the rows)."""
    from daft_tpu_torch.kernels.device import size_bucket, stage_table_columns
    from daft_tpu_torch.micropartition import MicroPartition
    from daft_tpu_torch.parallel import MeshExecutionContext, default_mesh
    from daft_tpu_torch.table import Table

    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=1)
    rng = np.random.RandomState(2)
    t = Table.from_pydict({"k": rng.randint(0, 100, 1024).astype(np.int64), "v": rng.rand(1024)})
    ctx = MeshExecutionContext(daft_tpu_torch.get_context().execution_config,
                               mesh=default_mesh(8))
    out = ctx.try_device_shuffle([MicroPartition.from_table(t)], [daft_tpu_torch.col("k")], 8,
                                 "hash")
    for p in out:
        cache = p.device_stage_cache()
        n = len(cache)
        b = size_bucket(max(len(p), 1))
        env, _ = stage_table_columns(p.table(), ["k", "v"], b, cache, ctx._device())
        assert len(cache) == n == 2  # both hits: nothing staged again
        for name in ("k", "v"):
            dc = cache[(name, b, "cpu", False)]
            assert dc.length == len(p) and not dc.valid[dc.length:].any()


def test_mesh_copartitioned_join_probes_from_the_cache(monkeypatch):
    """After the mesh shuffle of both sides, the device join probe stages
    nothing (tests/test_mesh.py test_mesh_copartitioned_join_probes_from_cache)."""
    import daft_tpu_torch.kernels.device as dev
    from daft_tpu_torch.kernels.device_join import device_join_launch
    from daft_tpu_torch.micropartition import MicroPartition
    from daft_tpu_torch.parallel import MeshExecutionContext, default_mesh
    from daft_tpu_torch.table import Table

    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=1)
    col = daft_tpu_torch.col
    rng = np.random.RandomState(4)
    left = Table.from_pydict({"k": np.arange(2000, dtype=np.int64), "lv": rng.rand(2000)})
    right = Table.from_pydict({"k2": rng.permutation(5000)[:1500].astype(np.int64),
                               "rv": rng.rand(1500)})
    ctx = MeshExecutionContext(daft_tpu_torch.get_context().execution_config,
                               mesh=default_mesh(8))
    lout = ctx.try_device_shuffle([MicroPartition.from_table(left)], [col("k")], 8, "hash")
    rout = ctx.try_device_shuffle([MicroPartition.from_table(right)], [col("k2")], 8, "hash")
    calls = []
    real = dev.stage_series
    monkeypatch.setattr(dev, "stage_series",
                        lambda *a, **kw: calls.append(a) or real(*a, **kw))
    total = 0
    for lp, rp in zip(lout, rout):
        if len(lp) == 0 or len(rp) == 0:
            continue
        side, hit, _ = device_join_launch(lp.table(), rp.table(), col("k"), col("k2"),
                                          lp.device_stage_cache(), rp.device_stage_cache(),
                                          "inner", device="cpu")()
        total += int(np.asarray(hit).sum())
    assert calls == []
    assert total == len(set(left.to_pydict()["k"]) & set(right.to_pydict()["k2"]))


@pytest.mark.parametrize("x64", MODES)
def test_mesh_join_query_device_probes(x64):
    def build(pkg):
        rng = np.random.RandomState(9)
        col = pkg.col
        l = pkg.from_pydict({"k": np.arange(4000, dtype=np.int64),
                             "lv": rng.rand(4000)}).repartition(8, col("k"))
        r = pkg.from_pydict({"k2": rng.permutation(8000)[:3000].astype(np.int64),
                             "rv": rng.rand(3000)}).repartition(8, col("k2"))
        return l.join(r, left_on="k", right_on="k2").agg(col("lv").sum().alias("s"),
                                                         col("k").count().alias("c"))

    _, c, _ = check_mesh(build, x64, rtol=1e-9 if x64 else 1e-5, per_partition=False,
                      use_device_kernels=True, device_min_rows=1)
    assert c["device_join_probes"] >= 1


@pytest.mark.parametrize("x64", MODES)
def test_mesh_broadcast_join_replicates_the_build_key(x64):
    def build(pkg):
        rng = np.random.RandomState(3)
        col = pkg.col
        big = pkg.from_pydict({"k": rng.randint(0, 50, size=5000).astype(np.int64),
                               "v": rng.rand(5000)}).repartition(8, col("k"))
        small = pkg.from_pydict({"k2": np.arange(0, 50, 2, dtype=np.int64),
                                 "name": np.arange(25, dtype=np.int64) * 10})
        return big.join(small, left_on="k", right_on="k2").agg(
            col("v").sum().alias("s"), col("name").count().alias("c"))

    _, c, _ = check_mesh(build, x64, rtol=1e-9 if x64 else 1e-5, per_partition=False,
                      use_device_kernels=True, device_min_rows=1,
                      broadcast_join_size_bytes_threshold=10 * 1024 * 1024)
    assert c["broadcast_joins"] == 1 and c["broadcast_replications"] == 1
    assert c["device_join_probes"] >= 1


def test_broadcast_probe_reads_the_replica(monkeypatch):
    """A partition's probe takes the build side's copy on its device and
    stages nothing of the build side."""
    import daft_tpu_torch.kernels.device_join as dj
    from daft_tpu_torch.micropartition import MicroPartition
    from daft_tpu_torch.parallel import default_mesh

    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=1)
    col = daft_tpu_torch.col
    small = MicroPartition.from_pydict({"k2": np.arange(0, 50, 2, dtype=np.int64)})
    big = MicroPartition.from_pydict({"k": np.arange(100, dtype=np.int64) % 50})
    assert dj.replicate_join_key(small, col("k2"), default_mesh(8), "cpu")
    reps = dj.join_key_replicas(small, col("k2"))
    assert list(reps) == ["cpu"]
    staged = []
    real = dj._stage_key
    monkeypatch.setattr(dj, "_stage_key", lambda t, *a: staged.append(t) or real(t, *a))
    side, hit, bidx = dj.device_join_launch(big.table(), small.table(), col("k"), col("k2"),
                                            None, None, "inner", device="cpu",
                                            right_replicas=reps)()
    assert staged == [big.table()]
    assert side == "right_build" and int(hit.sum()) == 50


def _smj_ints(pkg):
    rng = np.random.RandomState(12)
    l = pkg.from_pydict({"k": rng.randint(0, 400, 4000).astype(np.int64), "lv": rng.rand(4000)})
    r = pkg.from_pydict({"k2": rng.randint(0, 400, 2500).astype(np.int64), "rv": rng.rand(2500)})
    return l.repartition(8).join(r.repartition(8), left_on="k", right_on="k2",
                                 strategy="sort_merge")


def _smj_strings(pkg):
    rng = np.random.RandomState(21)
    keys = [f"k{rng.randint(0, 300):03d}" for _ in range(3000)]
    rkeys = [f"k{rng.randint(0, 300):03d}" for _ in range(1500)]
    l = pkg.from_pydict({"k": _s(pkg, keys), "lv": np.arange(3000, dtype=np.int64),
                         "tag": _s(pkg, [f"t{i % 7}" for i in range(3000)])})
    r = pkg.from_pydict({"k2": _s(pkg, rkeys), "rv": np.arange(1500, dtype=np.int64)})
    return l.repartition(8).join(r.repartition(8), left_on="k", right_on="k2",
                                 strategy="sort_merge")


def _smj_empty(pkg):
    rng = np.random.RandomState(13)
    col = pkg.col
    l = pkg.from_pydict({"k": rng.randint(0, 50, 1000).astype(np.int64),
                         "a": rng.rand(1000)}).repartition(4)
    r = (pkg.from_pydict({"k2": rng.randint(0, 50, 500).astype(np.int64), "b": rng.rand(500)})
         .where(col("k2") > 10**9).repartition(4))
    return l.join(r, left_on="k", right_on="k2", strategy="sort_merge")


@pytest.mark.parametrize("x64", MODES)
@pytest.mark.parametrize("build,aligned", [pytest.param(_smj_ints, 1, id="int-key"),
                                           pytest.param(_smj_strings, 1, id="string-key"),
                                           pytest.param(_smj_empty, 0, id="empty-side")])
def test_mesh_sort_merge_join_aligned_exchange(build, aligned, x64):
    parts, c, _ = check_mesh(build, x64, engaged=aligned == 1)
    assert c["device_aligned_smj_exchanges"] == aligned
    keys = [k for p in parts for k in p.to_pydict()["k"]]
    assert keys == sorted(keys)


# ---------------------------------------------------------------------------
# the collective breaker (tests/test_faults.py TestCollectiveFallback)
# ---------------------------------------------------------------------------

def _both_ctx(cfgs):
    from daft_tpu.parallel import MeshExecutionContext as RefCtx
    from daft_tpu.parallel import default_mesh as ref_mesh
    from daft_tpu_torch.parallel import MeshExecutionContext, default_mesh

    return RefCtx(cfgs[0], mesh=ref_mesh(8)), MeshExecutionContext(cfgs[1], mesh=default_mesh(8))


def _parts():
    from daft_tpu.micropartition import MicroPartition as RefMP
    from daft_tpu_torch.micropartition import MicroPartition

    k = {"k": np.arange(256, dtype=np.int64) % 8}
    return RefMP.from_pydict(k), MicroPartition.from_pydict(k)


@contextmanager
def _breaker_cfgs(**knobs):
    with modes(True, **knobs) as ref_cfg:
        yield ref_cfg, daft_tpu_torch.get_context().execution_config


def test_collective_exchange_failure_declines_and_trips():
    from daft_tpu import faults as ref_faults
    from daft_tpu_torch import faults

    with _breaker_cfgs(device_breaker_threshold=2) as cfgs:
        got = []
        for (ctx, p, f, pkg) in zip(_both_ctx(cfgs), _parts(), (ref_faults, faults),
                                    (daft_tpu, daft_tpu_torch)):
            f.arm("collective.exchange", "always")
            for _ in range(3):
                # the third call finds the breaker open and never reaches the site
                assert ctx.try_device_shuffle([p], [pkg.col("k")], 8, "hash") is None
            c = ctx.stats.snapshot()["counters"]
            got.append(({k: c.get(k, 0) for k in MESH_COUNTERS},
                        f.snapshot()["injected"]["collective.exchange"],
                        c.get("device_attempt_failures", 0)))
    assert got[0][:2] == got[1][:2]
    assert got[1][0]["collective_breaker_trips"] == 1 and got[1][0]["degraded_shuffles"] == 1
    assert got[1][1] == 2
    # pinned: the port counts each failure it hands to the host
    assert (got[0][2], got[1][2]) == (0, 2)


def test_collective_query_completes_on_the_host():
    from daft_tpu import faults as ref_faults
    from daft_tpu_torch import faults

    def build(pkg):
        col = pkg.col
        return (pkg.from_pydict({"k": np.arange(512, dtype=np.int64) % 7,
                                 "v": np.arange(512, dtype=np.int64)})
                .repartition(8, col("k")).groupby("k").agg(col("v").sum().alias("s")))

    ref_faults.arm("collective.exchange", "always")
    faults.arm("collective.exchange", "always")
    parts, c, _ = check_mesh(build, True, engaged=False, device_breaker_threshold=1)
    assert c["device_shuffles"] == 0 and c["collective_breaker_trips"] == 1
    got = {}
    for p in parts:
        d = p.to_pydict()
        got.update(dict(zip(d["k"], d["s"])))
    assert got == {k: sum(i for i in range(512) if i % 7 == k) for k in range(7)}


def test_collective_breaker_heals_after_the_probe(monkeypatch):
    from daft_tpu import faults as ref_faults
    from daft_tpu.execution import DeviceHealth as RefHealth
    from daft_tpu.parallel.mesh_exec import MeshExecutionContext as RefCtx
    from daft_tpu_torch import faults
    from daft_tpu_torch.execution import DeviceHealth
    from daft_tpu_torch.parallel.mesh_exec import MeshExecutionContext

    with _breaker_cfgs(device_breaker_threshold=1, device_breaker_cooldown_s=0.0) as cfgs:
        got = []
        for ctx, p, f, pkg, cls, health in zip(
                _both_ctx(cfgs), _parts(), (ref_faults, faults), (daft_tpu, daft_tpu_torch),
                (RefCtx, MeshExecutionContext), (RefHealth, DeviceHealth)):
            sentinel = [p]
            monkeypatch.setattr(cls, "_device_shuffle_impl", lambda self, *a, **k: sentinel)
            f.arm("collective.exchange", "first_n", n=1)
            assert ctx.try_device_shuffle([p], [pkg.col("k")], 8, "hash") is None
            assert ctx.collective_health.state == health.OPEN
            assert ctx.try_device_shuffle([p], [pkg.col("k")], 8, "hash") is sentinel
            assert ctx.collective_health.state == health.CLOSED
            c = ctx.stats.snapshot()["counters"]
            got.append(c.get("collective_breaker_recoveries", 0))
    assert got == [1, 1]


@pytest.mark.parametrize("exc", ["DaftKernelError", "RuntimeError"])
def test_collective_breaker_narrower_catch_pinned(exc, monkeypatch):
    """Pinned difference: the reference's breaker takes any exception of the
    exchange (the shuffle then runs on the host); the port's takes only
    DEVICE_FAILURES and torch.distributed's link errors, so a DaftKernelError
    or a defect reaches the caller."""
    from daft_tpu.parallel.mesh_exec import MeshExecutionContext as RefCtx
    from daft_tpu_torch.errors import DaftKernelError
    from daft_tpu_torch.parallel.mesh_exec import MeshExecutionContext

    err = DaftKernelError if exc == "DaftKernelError" else RuntimeError

    def boom(self, *a, **k):
        raise err("the exchange broke")

    monkeypatch.setattr(RefCtx, "_device_shuffle_impl", boom)
    monkeypatch.setattr(MeshExecutionContext, "_device_shuffle_impl", boom)
    with _breaker_cfgs() as cfgs:
        ref_ctx, ctx = _both_ctx(cfgs)
        rp, p = _parts()
        assert ref_ctx.try_device_shuffle([rp], [daft_tpu.col("k")], 8, "hash") is None
        with pytest.raises(err, match="the exchange broke"):
            ctx.try_device_shuffle([p], [daft_tpu_torch.col("k")], 8, "hash")
        assert ctx.stats.snapshot()["counters"].get("device_attempt_failures", 0) == 0


def test_mesh_runner_registers_the_collective_breaker():
    from daft_tpu_torch.parallel import default_mesh
    from daft_tpu_torch.runners import MeshRunner

    daft_tpu_torch.set_execution_config(device="cpu")
    df = daft_tpu_torch.from_pydict({"k": np.arange(64) % 5}).repartition(8, daft_tpu_torch.col("k"))
    ps = MeshRunner(default_mesh(8)).run(df._plan)
    assert sum(len(p) for p in ps.partitions) == 64
    assert daft_tpu_torch.health()["breakers"]["collective"] == "closed"


@pytest.mark.parametrize("scheme", ["hash", "range"])
def test_mesh_exchange_steps_are_child_spans(scheme):
    """A profiled exchange records ``collective.exchange`` with its five
    steps as child phase spans, in order, one each; a declined exchange
    records no step."""
    from daft_tpu_torch.micropartition import MicroPartition
    from daft_tpu_torch.parallel import MeshExecutionContext, default_mesh
    from daft_tpu_torch.profile import Profiler
    from daft_tpu_torch.table import Table

    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=1)
    rng = np.random.RandomState(4)
    t = Table.from_pydict({"k": rng.randint(0, 100, 512).astype(np.int64), "v": rng.rand(512)})
    ctx = MeshExecutionContext(daft_tpu_torch.get_context().execution_config,
                               mesh=default_mesh(8))
    ctx.stats.profiler = Profiler()
    col = daft_tpu_torch.col
    bnds = Table.from_pydict({"k": np.arange(1, 8, dtype=np.int64) * 12})
    out = ctx.try_device_shuffle([MicroPartition.from_table(t)], [col("k")], 8, scheme,
                                 boundaries=bnds if scheme == "range" else None)
    assert sum(len(p) for p in out) == 512
    # a declined exchange (an unshippable payload) opens no step
    bad = Table.from_pydict({"k": [1, 2], "l": [[1], [2]]})
    assert ctx.try_device_shuffle([MicroPartition.from_table(bad)], [col("k")], 8,
                                  "hash") is None
    spans = ctx.stats.profiler.spans_snapshot()
    top = [s for s in spans if s.name == "collective.exchange"]
    assert len(top) == 2 and all(s.kind == "phase" for s in top)
    steps = sorted((s for s in spans if s.parent == top[0].sid), key=lambda s: s.t0_ns)
    assert [s.name for s in steps] == ["collective.bucket", "collective.stage",
                                       "collective.scatter", "collective.counts",
                                       "collective.unstage"]
    assert all(s.kind == "phase" for s in steps)
    assert sum(s.dur_ns for s in steps) <= top[0].dur_ns
    assert not [s for s in spans if s.parent == top[1].sid]


def test_set_runner_mesh_selects_the_mesh_runner():
    from daft_tpu_torch.runners import MeshRunner, NativeRunner

    daft_tpu_torch.set_execution_config(device="cpu")
    try:
        daft_tpu_torch.set_runner_mesh()
        assert isinstance(daft_tpu_torch.get_context().runner(), MeshRunner)
        df = daft_tpu_torch.from_pydict({"k": [1, 2, 3] * 10}).repartition(
            8, daft_tpu_torch.col("k")).collect()
        assert df.stats.snapshot()["counters"]["device_shuffles"] == 1
        # "distributed" names the runner of worker processes (dist/); an
        # unknown name raises
        with pytest.raises(ValueError):
            daft_tpu_torch.set_runner("ray")
    finally:
        daft_tpu_torch.set_runner_native()
    assert type(daft_tpu_torch.get_context().runner()) is NativeRunner


def test_default_mesh_slot_wrap_pinned():
    """Pinned difference: the port's ``default_mesh(n)`` gives n slots,
    slot i on local device i % count (8 CPU slots here, 8 slots on one
    card); the reference's ``devs[:n]`` gives at most the device count. In
    every reference test both sides have 8."""
    from daft_tpu.parallel import default_mesh as ref_mesh
    from daft_tpu_torch.parallel import default_mesh

    daft_tpu_torch.set_execution_config(device="cpu")
    assert ref_mesh(8).devices.size == default_mesh(8).size == 8
    assert ref_mesh(16).devices.size == 8 and default_mesh(16).size == 16
    assert default_mesh().size == 1
    assert set(str(d) for d in default_mesh(16).devices) == {"cpu"}


def test_cuda_mesh_raises_without_a_card():
    import torch

    from daft_tpu_torch.errors import DaftKernelError
    from daft_tpu_torch.parallel import Mesh, MeshExecutionContext, default_mesh

    if torch.cuda.is_available():
        pytest.skip("a card is present: the mesh runs")
    daft_tpu_torch.set_execution_config(device="cuda")
    with pytest.raises(DaftKernelError):
        default_mesh(8)
    with pytest.raises(DaftKernelError):
        MeshExecutionContext(daft_tpu_torch.get_context().execution_config,
                             mesh=Mesh([(0, "cuda:0")] * 2))


# ---------------------------------------------------------------------------
# __graft_entry__.dryrun_multichip's query steps (2-7) through both packages
# ---------------------------------------------------------------------------

def _dry_data():
    rng = np.random.RandomState(0)
    rng.randint(0, 24, size=(8, 64))
    rng.rand(8, 64)  # step 1's draws, so the rest see the reference's stream
    return rng


def _dry_runner(pkg):
    if pkg is daft_tpu:
        from daft_tpu.parallel import default_mesh
        from daft_tpu.runners import MeshRunner
    else:
        from daft_tpu_torch.parallel import default_mesh
        from daft_tpu_torch.runners import MeshRunner
    return MeshRunner(default_mesh(8))


def _dry_queries(pkg):
    rng = _dry_data()
    col = pkg.col
    data = {"g": rng.randint(0, 40, size=512), "x": rng.randn(512),
            "y": rng.randint(0, 1000, size=512).astype(np.int64)}
    q2 = (pkg.from_pydict(data).repartition(8, col("g")).groupby(col("g"))
          .agg(col("x").sum().alias("sx"), col("y").max().alias("my"),
               col("x").count().alias("c")).sort(col("g")))
    q3 = (pkg.from_pydict({"a": rng.randint(0, 5000, 2048).astype(np.int64),
                           "b": rng.randn(2048)}).repartition(8).sort([col("a"), col("b")]))
    q4 = pkg.from_pydict(data).repartition(3, col("g"))
    sdata = {"m": np.array(["MAIL", "SHIP", "AIR", "RAIL"])[rng.randint(0, 4, 512)].tolist(),
             "v": rng.rand(512)}
    dim = {"m2": ["MAIL", "SHIP", "AIR", "RAIL"], "w": [1.0, 2.0, 3.0, 4.0]}
    q5 = (pkg.from_pydict(sdata).where(col("m").is_in(["MAIL", "SHIP", "RAIL"]))
          .join(pkg.from_pydict(dim), left_on="m", right_on="m2").groupby(col("m"))
          .agg(col("v").sum().alias("sv"), col("w").count().alias("c")).sort(col("m")))
    cdata = {"a": [None if i % 13 == 0 else s for i, s in enumerate(
                 np.array(["MAIL", "SHIP", "AIR"])[rng.randint(0, 3, 512)].tolist())],
             "b": np.array(["MAIL", "RAIL", "BARGE"])[rng.randint(0, 3, 512)].tolist(),
             "v": rng.rand(512)}
    q6 = (pkg.from_pydict(cdata).where(col("a").fill_null(col("b")) >= col("b"))
          .select((col("v") > 0.5).if_else(col("a"), col("b")).alias("pick"), col("v"))
          .sort([col("pick"), col("v")]))
    tdata = {"s": np.array(["  Mail ", "mail", "SHIP", "ship ", "AIR"])[
                 rng.randint(0, 5, 512)].tolist(), "v": rng.rand(512)}
    q7 = (pkg.from_pydict(tdata).where(col("s").str.lower().str.contains("a"))
          .groupby(col("s").str.lstrip().str.rstrip().str.upper().alias("k"))
          .agg(col("v").sum().alias("sv"), col("v").count().alias("c")).sort(col("k")))
    return [q2, q3, q4, q5, q6, q7]


@pytest.mark.parametrize("x64", MODES)
def test_dryrun_multichip_steps_match_the_reference(x64):
    """Each step's mesh rows equal the port's own host rows (the reference
    test's contract), and the reference's: exactly but for the float sums,
    which in the 32-bit mode add float32 terms of unit scale whose sums
    cancel to about 0.02 (``atol`` 1e-6, a few float32 ulps of the terms;
    the port's host path differs from the reference's there by as much)."""
    from daft_tpu_torch.runners import NativeRunner

    with modes(x64):
        ref = [_dry_runner(daft_tpu).run(q._plan) for q in _dry_queries(daft_tpu)]
        qs = _dry_queries(daft_tpu_torch)
        got = [_dry_runner(daft_tpu_torch).run(q._plan) for q in qs]
        host = [NativeRunner().run(q._plan) for q in qs]
    rtol, atol = (1e-12, 0.0) if x64 else (1e-5, 1e-6)
    for i, (r, g, h) in enumerate(zip(ref, got, host)):
        if i == 2:  # step 4: a 3-way repartition, bucket by bucket
            assert len(g.partitions) == len(r.partitions) == len(h.partitions) == 3
            for gp, rp, hp in zip(g.partitions, r.partitions, h.partitions):
                assert_same_rows(gp.to_pydict(), rp.to_pydict())
                # the 32-bit exchange ships float64 payload as float32, so the
                # host's buckets hold the same keys (the reference's check)
                assert sorted(gp.to_pydict()["g"]) == sorted(hp.to_pydict()["g"])
            continue
        gd, rd = g.to_table().to_pydict(), r.to_table().to_pydict()
        assert_same_rows(gd, h.to_table().to_pydict(), rtol, ordered=True)
        assert list(gd) == list(rd)
        for name in gd:
            if gd[name] and isinstance(gd[name][0], float):
                np.testing.assert_allclose(gd[name], rd[name], rtol=rtol, atol=atol)
            else:
                assert gd[name] == rd[name]
    assert got[5].to_table().to_pydict()["k"] == ["AIR", "MAIL"]


# ---------------------------------------------------------------------------
# the runner's plans and the executor's declines under a mesh
# ---------------------------------------------------------------------------

def test_mesh_plans_decline_fanout_resizes_and_cache_apart():
    """A grouped aggregate over 8 partitions resizes its exchange on its
    second native run (feedback planning); through MeshRunner it never does,
    and the mesh's plans cache under their own runner."""
    from daft_tpu_torch.adapt import HISTORY, PLAN_CACHE
    from daft_tpu_torch.parallel import default_mesh
    from daft_tpu_torch.runners import MeshRunner, NativeRunner

    col = daft_tpu_torch.col
    daft_tpu_torch.set_execution_config(device="cpu", history_fdo=True, plan_cache=True,
                                        enable_result_cache=False)

    rng = np.random.RandomState(12)
    src = daft_tpu_torch.from_pydict({"k": rng.randint(0, 7, 4000),
                                      "v": rng.rand(4000)}).into_partitions(8).collect()
    got = {}
    ctx = daft_tpu_torch.get_context()
    try:
        for name, runner in (("native", NativeRunner()), ("mesh", MeshRunner(default_mesh(8)))):
            PLAN_CACHE.clear()
            HISTORY.clear()
            ctx._runner = runner
            runs = [src.groupby("k").agg(col("v").sum().alias("s")).sort("k").collect()
                    for _ in range(2)]
            c = runs[1].stats.snapshot()["counters"]
            got[name] = (c.get("fdo_shuffle_resizes", 0), c.get("plan_cache_hits", 0),
                         c.get("device_shuffles", 0))
    finally:
        ctx._runner = None
    assert got["native"][0] >= 1 and got["native"][2] == 0
    assert got["mesh"][0] == 0 and got["mesh"][1] == 1 and got["mesh"][2] >= 1
    PLAN_CACHE.clear()
    HISTORY.clear()


def test_mesh_declines_the_stream_and_the_subplan_cache(tmp_path):
    """Under a mesh context the morsel pipeline and the sub-plan result
    cache stand down (partitions may belong to other slots and processes);
    the rows equal the native run's."""
    import pyarrow.parquet as papq

    from daft_tpu_torch.adapt import RESULT_CACHE
    from daft_tpu_torch.parallel import default_mesh
    from daft_tpu_torch.runners import MeshRunner, NativeRunner

    col = daft_tpu_torch.col
    daft_tpu_torch.set_execution_config(device="cpu", use_device_kernels=False,
                                        morsel_size_rows=64, enable_result_cache=False)
    path = str(tmp_path / "t.parquet")
    papq.write_table(pa.table({"k": np.arange(1000) % 7, "v": np.arange(1000.0)}), path)
    RESULT_CACHE.clear()
    rows = {}
    for name, runner in (("native", NativeRunner()), ("mesh", MeshRunner(default_mesh(8)))):
        df = (daft_tpu_torch.read_parquet(path).where(col("v") > 10.0)
              .with_column("w", col("v") * 2.0))
        stats = daft_tpu_torch.execution.RuntimeStats()
        ps = runner.run(df._plan, stats=stats)
        c = stats.snapshot()["counters"]
        rows[name] = ps.to_table().to_pydict()
        engaged = (c.get("stream_morsels", 0), c.get("subplan_cache_misses", 0)
                   + c.get("subplan_cache_hits", 0))
        if name == "mesh":
            assert engaged == (0, 0)
        else:  # the native run streams the chain and consults the cache
            assert engaged[0] > 0 and engaged[1] > 0, engaged
    assert rows["mesh"] == rows["native"]
    RESULT_CACHE.clear()
