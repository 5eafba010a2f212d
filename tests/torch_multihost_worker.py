"""One process of a multi-process daft_tpu_torch cluster on the CPU (gloo),
for tests/test_torch_multihost.py. Not collected by pytest.

Run: python torch_multihost_worker.py <scenario> <process_id> <num_processes> <port>

Scenarios:
- ``main`` (2 processes, 4 CPU slots each, 8 in all): a raw cross-process
  ``build_exchange``; TPC-H Q5 through ``MeshRunner`` on the global mesh
  (its rows printed for the parent to hold against the reference's answer);
  scan locality over 8 parquet files, straight and through a projection and
  filter chain; one file owned by process 0 (the empty local contribution);
  a string payload.
- ``four`` (4 processes, 2 slots each): a string shuffle and a grouped
  aggregate against an exact oracle.
- ``probe``: the raw collectives, ``all_to_all_single`` and ``all_gather``.
- ``sketch`` (2 processes, 4 slots each): ``build_register_allmerge`` over
  the global mesh, one seeded HLL register row a slot, against the numpy
  max of all 8 rows.
- ``transport`` (2 processes, 4 slots each): ``collective.exchange`` armed
  on every process, so that the exchange of a grouped sum over a
  repartition takes dist/peer.py's host transport (``transport_shuffles``);
  its rows printed for the parent to hold against the reference's.
- ``lake`` (2 processes, 4 slots each): the Iceberg table at
  ``TORCH_MH_LAKE`` read through ``read_iceberg`` and summed by key through
  the exchange (its rows printed, and the data files each process opened),
  and a ScanOperator of 4 factory fragments grouped likewise.

Each check prints a marker line the parent reads. The worker imports the
port and benchmarks/tpch.py's generator and oracles (pyarrow only), never
jax or daft_tpu.
"""

import collections
import datetime
import json
import os
import shutil
import sys
import tempfile

scenario = sys.argv[1]
pid = int(sys.argv[2])
nproc = int(sys.argv[3])
port = sys.argv[4]

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import daft_tpu_torch as dtt  # noqa: E402
from daft_tpu_torch import col  # noqa: E402
from daft_tpu_torch.parallel.multihost import (global_mesh, init_distributed,  # noqa: E402
                                               process_local_slots, shutdown_distributed)

dtt.set_execution_config(device="cpu", use_device_kernels=True, device_min_rows=1,
                         enable_result_cache=False,
                         # the collectives' order must be the same on every
                         # process: one worker thread (SPMD discipline)
                         executor_threads=1)
assert init_distributed(f"localhost:{port}", nproc, pid)
assert dist.get_backend() == "gloo"


def done(marker: str, **extra) -> None:
    tail = "".join(f" {k}={v}" for k, v in extra.items())
    print(f"{marker} {pid}{tail}", flush=True)


def exchanges(coll) -> int:
    return coll.stats.snapshot()["counters"].get("device_shuffles", 0)


def use_mesh(mesh) -> None:
    from daft_tpu_torch.runners import MeshRunner

    ctx = dtt.get_context()
    ctx._runner = MeshRunner(mesh=mesh)


def assert_groupby_sum(coll, keys_np, vals_np, key_col, out_col, tag) -> None:
    acc = collections.defaultdict(int)
    for kk, vv in zip(keys_np.tolist(), vals_np.tolist()):
        acc[kk] += vv
    gd = coll.to_pydict()
    assert gd[key_col] == sorted(acc), (tag, gd[key_col][:5], sorted(acc)[:5])
    assert gd[out_col] == [acc[kk] for kk in sorted(acc)], f"{tag}: sums differ"


def q5(customer, orders, lineitem, nation):
    """benchmarks/tpch.py's Q5 over daft_tpu_torch frames."""
    lo = datetime.date(1994, 1, 1)
    hi = datetime.date(1995, 1, 1)
    n = nation.where(col("n_regionname") == "ASIA")
    o = orders.where((col("o_orderdate") >= lo) & (col("o_orderdate") < hi))
    return (n.join(customer, left_on="n_nationkey", right_on="c_nationkey")
            .join(o, left_on="c_custkey", right_on="o_custkey")
            .join(lineitem, left_on="o_orderkey", right_on="l_orderkey")
            .with_column("revenue", col("l_extendedprice") * (1 - col("l_discount")))
            .groupby("n_name").agg(col("revenue").sum().alias("revenue"))
            .sort("revenue", desc=True))


def raw_exchange(mesh) -> None:
    from daft_tpu_torch.parallel.collectives import (build_exchange, exchange_capacity,
                                                     shard_to_mesh)

    n = mesh.size
    slots = process_local_slots(mesh)
    rng = np.random.RandomState(0)  # the same control plane on every process
    vals = rng.randint(0, 1000, size=(n, 64)).astype(np.int64)
    bucket = (vals % n).astype(np.int32)
    valid = np.ones((n, 64), dtype=bool)
    cap = exchange_capacity(list(bucket), [None] * n, n)
    rv, rc = build_exchange(mesh, cap)(
        shard_to_mesh(bucket, mesh), shard_to_mesh(valid, mesh), shard_to_mesh(vals, mesh))
    for k, d in enumerate(slots):
        rows = rc[k].reshape(-1)[rv[k].reshape(-1)].numpy()
        assert (rows % n == d).all(), f"slot {d} received foreign rows"
        assert np.array_equal(np.sort(rows), np.sort(vals[bucket == d])), f"slot {d}"
    done("MULTIHOST_OK")


def write_files(tag: str, seed: int, nfiles: int, rows: int, key_hi: int, val_hi: int):
    import pyarrow as pa
    import pyarrow.parquet as papq

    root = os.path.join(tempfile.gettempdir(), f"torch_mh_{tag}_{port}_{pid}")
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)  # the same files on every process
    ks, vs = [], []
    for i in range(nfiles):
        kk = rng.randint(0, key_hi, rows).astype(np.int64)
        vv = rng.randint(0, val_hi, rows).astype(np.int64)
        papq.write_table(pa.table({"k": kk, "v": vv}), os.path.join(root, f"f{i:02d}.parquet"))
        ks.append(kk)
        vs.append(vv)
    return root, np.concatenate(ks), np.concatenate(vs)


def opened_since(before: int) -> int:
    from daft_tpu_torch.io.scan import IO_STATS

    return IO_STATS.snapshot()["files_opened"] - before


def files_opened() -> int:
    from daft_tpu_torch.io.scan import IO_STATS

    return IO_STATS.snapshot()["files_opened"]


def main() -> None:
    from benchmarks import tpch

    mesh = global_mesh(4)
    assert mesh.size == 4 * nproc and len(process_local_slots(mesh)) == 4
    raw_exchange(mesh)
    use_mesh(mesh)

    tables = tpch.generate_tables(scale=0.02, seed=42)
    cust = dtt.from_arrow(tables["customer"]).repartition(4, "c_custkey").collect()
    orders = dtt.from_arrow(tables["orders"]).repartition(4, "o_custkey").collect()
    nat = dtt.from_arrow(tables["nation"]).collect()
    line = (dtt.from_arrow(tables["lineitem"])
            .select(col("l_orderkey"), col("l_extendedprice"), col("l_discount"))
            .repartition(4, "l_orderkey"))
    got = q5(cust, orders, line, nat).collect()
    assert exchanges(got) >= 1, got.stats.snapshot()
    gd = got.to_pydict()
    want = tpch.oracle_q5(tables["customer"], tables["orders"], tables["lineitem"],
                          tables["nation"])
    assert gd["n_name"] == want["n_name"], (gd, want)
    for a, b in zip(gd["revenue"], want["revenue"]):
        assert abs(a - b) <= max(1e-5 * abs(b), 1e-6), (a, b)
    done("MULTIHOST_Q5_OK", shuffles=exchanges(got))
    print("MULTIHOST_Q5_ROWS " + json.dumps(gd), flush=True)

    cfg = dtt.get_context().execution_config
    dtt.set_execution_config(cfg, scan_tasks_min_size_bytes=1)  # one task a file
    root, k1, v1 = write_files("scan", 7, 8, 5000, 40, 1000)
    before = files_opened()
    res = (dtt.read_parquet(os.path.join(root, "*.parquet")).repartition(8, "k")
           .groupby("k").agg(col("v").sum().alias("s")).sort("k")).collect()
    opened = opened_since(before)
    assert exchanges(res) >= 1
    assert_groupby_sum(res, k1, v1, "k", "s", "scan-locality")
    shutil.rmtree(root, ignore_errors=True)
    done("MULTIHOST_SCANLOC_OK", opened=opened)

    root, k2, v2 = write_files("chain", 11, 8, 4000, 30, 500)
    before = files_opened()
    res = (dtt.read_parquet(os.path.join(root, "*.parquet"))
           .with_column("w", col("v") * 3 + 1)
           .where(col("w") % 2 == 1)
           .repartition(8, "k").groupby("k").agg(col("w").sum().alias("sw")).sort("k")
           ).collect()
    opened = opened_since(before)
    assert exchanges(res) >= 1
    w = v2 * 3 + 1
    keep = (w % 2) == 1
    assert_groupby_sum(res, k2[keep], w[keep], "k", "sw", "map-chain")
    shutil.rmtree(root, ignore_errors=True)
    done("MULTIHOST_MAPCHAIN_OK", opened=opened)

    root, k3, v3 = write_files("one", 23, 1, 3000, 12, 100)
    before = files_opened()
    res = (dtt.read_parquet(os.path.join(root, "*.parquet")).repartition(4, "k")
           .groupby("k").agg(col("v").sum().alias("s")).sort("k")).collect()
    opened = opened_since(before)
    assert exchanges(res) >= 1
    # only the owner reads the file; process 1 contributes no rows
    assert opened <= (1 if pid == 0 else 0) + 1, opened
    assert_groupby_sum(res, k3, v3, "k", "s", "single-owner")
    shutil.rmtree(root, ignore_errors=True)
    done("MULTIHOST_EMPTYLOCAL_OK", opened=opened)

    rng = np.random.RandomState(31)
    svals = [None if i % 19 == 0 else f"name-{i % 23}" for i in range(4000)]
    sk = rng.randint(0, 16, 4000).astype(np.int64)
    coll = (dtt.from_pydict({"g": dtt.Series.from_pylist(svals, "g", dtt.DataType.string()),
                             "k": sk}).repartition(8, "k")
            .groupby("g").agg(col("k").count().alias("c")).sort("g")).collect()
    assert exchanges(coll) >= 1, coll.stats.snapshot()
    acc = collections.Counter(svals)
    sd = coll.to_pydict()
    want_keys = sorted(k for k in acc if k is not None)
    assert [k for k in sd["g"] if k is not None] == want_keys
    assert [c for k, c in zip(sd["g"], sd["c"]) if k is not None] == [acc[k] for k in want_keys]
    assert sd["c"][sd["g"].index(None)] == acc[None]
    done("MULTIHOST_STRINGPAYLOAD_OK")


def transport() -> None:
    from daft_tpu_torch import faults

    use_mesh(global_mesh(4))
    rng = np.random.RandomState(5)  # the same rows on every process
    k = rng.randint(0, 50, 6000).astype(np.int64)
    v = rng.randint(0, 1000, 6000).astype(np.int64)
    faults.arm("collective.exchange", "always")
    try:
        res = dtt.from_pydict({"k": k, "v": v}).repartition(8, "k").collect()
    finally:
        faults.disarm()
    c = res.stats.snapshot()["counters"]
    assert c.get("transport_shuffles", 0) == 1, c
    assert c.get("device_shuffles", 0) == 0 and c.get("shuffles", 0) == 0, c
    parts = [p.to_pydict() for p in res.iter_partitions()]
    assert len(parts) == 8
    done("TRANSPORT_OK", transport_shuffles=c["transport_shuffles"])
    print("TRANSPORT_ROWS " + json.dumps(parts), flush=True)


def four() -> None:
    mesh = global_mesh(2)
    assert mesh.size == 2 * nproc
    use_mesh(mesh)
    rng = np.random.RandomState(5)
    svals = [None if i % 17 == 0 else f"g{i % 29:02d}" for i in range(6000)]
    keys = rng.randint(0, 32, 6000).astype(np.int64)
    vals = rng.rand(6000)
    coll = (dtt.from_pydict({"g": dtt.Series.from_pylist(svals, "g", dtt.DataType.string()),
                             "k": keys, "v": vals})
            .repartition(8, "k")
            .groupby("g").agg(col("v").sum().alias("s"), col("v").count().alias("c"))
            .sort("g")).collect()
    assert exchanges(coll) >= 1, coll.stats.snapshot()
    acc_s = collections.defaultdict(float)
    acc_c = collections.defaultdict(int)
    for g, v in zip(svals, vals):
        acc_s[g] += v
        acc_c[g] += 1
    gd = coll.to_pydict()
    assert [k for k in gd["g"] if k is not None] == sorted(k for k in acc_c if k is not None)
    for g, s, c in zip(gd["g"], gd["s"], gd["c"]):
        assert c == acc_c[g], (g, c, acc_c[g])
        # the 32-bit mode sums float64 as float32
        assert abs(s - acc_s[g]) <= max(1e-5 * abs(acc_s[g]), 1e-6), (g, s)
    done("MULTIHOST4_OK", shuffles=exchanges(coll))


def lake() -> None:
    from daft_tpu_torch.io.pyscan import FactoryScanTask, ScanOperator
    from daft_tpu_torch.schema import Field, Schema
    import pyarrow as pa

    mesh = global_mesh(4)
    use_mesh(mesh)
    before = files_opened()
    res = (dtt.read_iceberg(os.environ["TORCH_MH_LAKE"]).repartition(8, "k")
           .groupby("k").agg(col("v").sum().alias("s")).sort("k")).collect()
    opened = opened_since(before)
    assert exchanges(res) >= 1, res.stats.snapshot()
    print("LAKE_ICEBERG_ROWS " + json.dumps(res.to_pydict()), flush=True)
    done("LAKE_ICEBERG_OK", opened=opened)

    schema = Schema([Field("a", dtt.DataType.int64()), Field("s", dtt.DataType.string())])

    class Op(ScanOperator):
        def schema(self):
            return schema

        def to_scan_tasks(self, pushdowns):
            for i in range(4):
                def factory(pd, _i=i):
                    return pa.table({
                        "a": pa.array([_i * 25 + j for j in range(25)], pa.int64()),
                        "s": pa.array([f"r{_i}-{j}" for j in range(25)])})

                yield FactoryScanTask(factory, schema, pushdowns, num_rows=25,
                                      label=f"frag-{i}")

    res = (dtt.from_scan_operator(Op()).with_column("g", col("a") % 3)
           .groupby("g").agg(col("a").sum().alias("s")).sort("g")).collect()
    assert exchanges(res) >= 1, res.stats.snapshot()
    print("LAKE_FACTORY_ROWS " + json.dumps(res.to_pydict()), flush=True)
    done("LAKE_FACTORY_OK")


def probe() -> None:
    world = dist.get_world_size()
    x = torch.arange(world * 2, dtype=torch.int32) + 100 * pid
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x)
    want = torch.tensor([100 * q + 2 * pid + j for q in range(world) for j in range(2)],
                        dtype=torch.int32)
    assert torch.equal(out, want), (out, want)
    got = [torch.empty(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(got, torch.tensor([pid], dtype=torch.int64))
    assert [int(t) for t in got] == list(range(world))
    done("PROBE_OK")


def sketch() -> None:
    from daft_tpu_torch.kernels.sketches import HLL_M
    from daft_tpu_torch.parallel.collectives import build_register_allmerge

    mesh = global_mesh(4)
    assert mesh.size == 4 * nproc
    every = np.random.RandomState(11).randint(0, 40, (mesh.size, HLL_M)).astype(np.uint8)
    rows = [torch.from_numpy(every[s]).to(mesh.devices[s]) for s in mesh.local_indices()]
    got = build_register_allmerge(mesh, HLL_M)(rows)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (HLL_M,)
    assert np.array_equal(got.cpu().numpy(), every.max(axis=0))
    # a process's own rows alone do not give it: the max crossed processes
    assert not np.array_equal(every[mesh.local_indices()].max(axis=0), every.max(axis=0))
    done("SKETCH_MERGE_OK")


try:
    {"main": main, "four": four, "probe": probe, "lake": lake, "sketch": sketch,
     "transport": transport}[scenario]()
finally:
    shutdown_distributed()
