"""The lake formats, SQL scans, the avro codec, the Unity Catalog client and
user-defined scan sources of daft_tpu_torch (io/catalogs.py, io/avro.py,
io/unity.py, io/pyscan.py), held against daft_tpu on the CPU.

Each case of tests/test_catalogs.py runs one input through both packages
(the reference in its 32-bit device mode, the port under that config
mapped, ``device="cpu"``) and compares rows, the routing counters and the
error raised. Tables are built by the reference's own fixtures
(``_write_delta``, ``_build_iceberg``, ``_entry``), imported, not copied.
Left out: ``TestInterop::test_torch_datasets``, which waits for the
``to_torch_*`` datasets (ROADMAP, Queue 1, item 10). The lance round trip
skips where ``lance`` is missing, as the reference's does.

Added: Delta and Iceberg tables that one package writes read back by the
other, in both directions; manifests and avro files that one package
encodes decoded by the other, byte for byte equal at a fixed sync marker;
the Ray and Dask gates; and one 2-process ``gloo`` cluster of the port that
reads an Iceberg table and a ScanOperator under ``MeshRunner``
(tests/torch_multihost_worker.py's ``lake`` scenario), held to the
reference's rows.
"""

import json
import os
import sqlite3
import time
from importlib import import_module

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

import daft_tpu
import daft_tpu_torch
from test_catalogs import _MANIFEST_ENTRY_SCHEMA, _build_iceberg, _write_delta
from torch_parity import (counters, fresh_ledgers_and_faults, restore_port_config,  # noqa: F401
                          under_both)

PKGS = (daft_tpu, daft_tpu_torch)
BASE = {"enable_result_cache": False}


def _mod(pkg, name: str):
    return import_module(f"{pkg.__name__}.{name}")


def _other(pkg):
    return daft_tpu if pkg is daft_tpu_torch else daft_tpu_torch


@pytest.fixture(autouse=True)
def fresh_state():
    fresh_ledgers_and_faults()
    yield
    fresh_ledgers_and_faults()


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # the error is part of what is compared
        return ("raised", type(e).__name__, str(e))


def both(fn, knobs=None):
    return under_both(fn, {**BASE, **(knobs or {})})


def same(fn, knobs=None):
    """``fn(pkg)`` through both packages; returns the port's result after
    holding it equal to the reference's."""
    ref, got = both(fn, knobs)
    assert got == ref
    return got


def rows_and_counters(df):
    df = df.collect()
    return df.to_pydict(), counters(df)


# ---------------------------------------------------------------------------
# TestDeltaLake
# ---------------------------------------------------------------------------

def test_delta_read_add_remove(tmp_path):
    root = str(tmp_path)
    for name, t in [("f1.parquet", pa.table({"x": [1, 2], "y": ["a", "b"]})),
                    ("f2.parquet", pa.table({"x": [3], "y": ["c"]})),
                    ("old.parquet", pa.table({"x": [9], "y": ["z"]}))]:
        papq.write_table(t, os.path.join(root, name))
    _write_delta(root, [
        [{"add": {"path": "old.parquet", "size": 100, "partitionValues": {}}}],
        [{"add": {"path": "f1.parquet", "size": 200, "partitionValues": {}}},
         {"remove": {"path": "old.parquet"}}],
        [{"add": {"path": "f2.parquet", "size": 80, "partitionValues": {}}}],
    ])
    got = same(lambda pkg: rows_and_counters(pkg.read_deltalake(root).sort("x")))
    assert got[0] == {"x": [1, 2, 3], "y": ["a", "b", "c"]}  # old.parquet removed


def test_delta_partition_values(tmp_path):
    root = str(tmp_path)
    papq.write_table(pa.table({"v": [1, 2]}), os.path.join(root, "p0.parquet"))
    papq.write_table(pa.table({"v": [3]}), os.path.join(root, "p1.parquet"))
    _write_delta(root, [
        [{"add": {"path": "p0.parquet", "size": 1, "partitionValues": {"day": "2024-01-01"}}},
         {"add": {"path": "p1.parquet", "size": 1, "partitionValues": {"day": "2024-01-02"}}}],
    ])

    def fn(pkg):
        out = rows_and_counters(pkg.read_deltalake(root).sort("v"))
        filtered = rows_and_counters(pkg.read_deltalake(root).where(pkg.col("day") == "2024-01-02"))
        return out, filtered

    (out, _), (filtered, _) = same(fn)
    assert out["day"] == ["2024-01-01", "2024-01-01", "2024-01-02"]
    assert filtered["v"] == [3]


def test_delta_not_a_delta_table(tmp_path):
    got = same(lambda pkg: _outcome(lambda: pkg.read_deltalake(str(tmp_path))))
    assert got[:2] == ("raised", "DaftNotFoundError") and "_delta_log" in got[2]


# ---------------------------------------------------------------------------
# TestReadSql, and TestReviewFixes.test_read_sql_live_connection
# ---------------------------------------------------------------------------

def _items_db(tmp_path) -> str:
    db = str(tmp_path / "t.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE items (id INTEGER, name TEXT, price REAL)")
    conn.executemany("INSERT INTO items VALUES (?, ?, ?)",
                     [(1, "a", 1.5), (2, "b", 2.5), (3, None, 9.0)])
    conn.execute("CREATE TABLE t (a INTEGER)")
    conn.executemany("INSERT INTO t VALUES (?)", [(i,) for i in range(10)])
    conn.commit()
    conn.close()
    return db


@pytest.mark.parametrize("case", ["sqlite_path", "sqlite_url", "connection_factory",
                                  "live_connection", "empty_result"])
def test_read_sql(tmp_path, case):
    db = _items_db(tmp_path)

    def fn(pkg):
        if case == "sqlite_path":
            return rows_and_counters(
                pkg.read_sql("SELECT * FROM items WHERE price < 5", db).sort("id"))
        if case == "sqlite_url":
            return rows_and_counters(pkg.read_sql("SELECT id FROM items", f"sqlite://{db}")
                                     .sort("id"))
        if case == "connection_factory":
            return rows_and_counters(pkg.read_sql("SELECT a FROM t",
                                                  lambda: sqlite3.connect(db)).sum("a"))
        if case == "empty_result":
            return rows_and_counters(pkg.read_sql("SELECT a FROM t WHERE a > 100", db))
        conn = sqlite3.connect(db)
        out = rows_and_counters(pkg.read_sql("SELECT a FROM t WHERE a = 7", conn))
        conn.execute("SELECT 1")  # the borrowed connection stays usable
        conn.close()
        return out

    got = same(fn)
    want = {"sqlite_path": {"id": [1, 2], "name": ["a", "b"], "price": [1.5, 2.5]},
            "sqlite_url": {"id": [1, 2, 3]}, "connection_factory": {"a": [45]},
            "live_connection": {"a": [7]}, "empty_result": {"a": []}}[case]
    assert got[0] == want


# ---------------------------------------------------------------------------
# TestRetryAndCancel
# ---------------------------------------------------------------------------

def test_missing_file_fails_fast(tmp_path):
    def fn(pkg):
        scan, schema = _mod(pkg, "io.scan"), _mod(pkg, "schema")
        task = scan.ScanTask(str(tmp_path / "nope.parquet"), scan.FileFormat.PARQUET,
                             schema.Schema([schema.Field("a", pkg.DataType.int64())]),
                             scan.Pushdowns())
        t0 = time.perf_counter()
        out = _outcome(task.read)
        return out[:2], time.perf_counter() - t0 < 0.2  # no retries on permanent errors

    assert same(fn) == (("raised", "FileNotFoundError"), True)


def test_cancel_mid_query():
    def fn(pkg):
        df = pkg.from_pydict({"x": np.arange(200_000)})
        df = df.repartition(64).select((pkg.col("x") * 2).alias("y"))
        it = df.iter_partitions()
        next(it)  # the query is running
        df.cancel()
        return _outcome(lambda: [None for _ in it])[:2]

    assert same(fn) == ("raised", "QueryCancelledError")


def test_cancel_then_retry():
    def fn(pkg):
        df = pkg.from_pydict({"x": [1, 2, 3]}).select((pkg.col("x") + 1).alias("y"))
        df.cancel()
        return df.to_pydict()  # a new run clears the cancellation

    assert same(fn) == {"y": [2, 3, 4]}


# ---------------------------------------------------------------------------
# TestInterop (test_torch_datasets left out: item 10) and TestReviewFixes
# ---------------------------------------------------------------------------

def test_partition_set_cache():
    def fn(pkg):
        c = _mod(pkg, "runners").PartitionSetCache()
        df = pkg.from_pydict({"a": [1]}).collect()
        c.put("k", df._result)
        c.put("k", df._result)  # refcount 2
        steps = [c.get("k") is df._result]
        c.release("k")
        steps.append(len(c))
        c.release("k")
        steps += [len(c), c.get("k") is None]
        return steps

    assert same(fn) == [True, 1, 0, True]


def test_delta_checkpoint(tmp_path):
    root = str(tmp_path)
    log = os.path.join(root, "_delta_log")
    os.makedirs(log)
    papq.write_table(pa.table({"v": [1]}), os.path.join(root, "cp.parquet"))
    papq.write_table(pa.table({"v": [2]}), os.path.join(root, "post.parquet"))
    # a checkpoint at version 5 holds cp.parquet; json commit 6 adds post.parquet
    cp = pa.table({"add": [{"path": "cp.parquet", "size": 1}, None],
                   "remove": [None, {"path": "gone.parquet"}]})
    papq.write_table(cp, os.path.join(log, f"{5:020d}.checkpoint.parquet"))
    with open(os.path.join(log, "_last_checkpoint"), "w") as f:
        json.dump({"version": 5, "size": 2}, f)
    with open(os.path.join(log, f"{6:020d}.json"), "w") as f:
        f.write(json.dumps({"add": {"path": "post.parquet", "size": 1,
                                    "partitionValues": {}}}) + "\n")
    assert same(lambda pkg: rows_and_counters(pkg.read_deltalake(root).sort("v")))[0] == {
        "v": [1, 2]}


def test_result_cache_reuse():
    def fn(pkg):
        base = pkg.from_pydict({"k": np.arange(1000) % 5, "v": np.arange(1000.0)})
        q1 = base.groupby("k").agg(pkg.col("v").sum().alias("s")).sort("k")
        q2 = base.groupby("k").agg(pkg.col("v").sum().alias("s")).sort("k")
        r1, r2 = q1.collect().to_pydict(), q2.collect().to_pydict()
        return r1 == r2, q2.stats.snapshot()["counters"].get("result_cache_hits", 0)

    assert same(fn, {"enable_result_cache": True}) == (True, 1)


def test_udf_plans_not_cached():
    def fn(pkg):
        calls = {"n": 0}

        @pkg.udf(return_dtype=pkg.DataType.int64())
        def bump(s):
            calls["n"] += 1
            return s

        base = pkg.from_pydict({"x": [1, 2]})
        q = base.select(bump(pkg.col("x")).alias("y"))
        key = _mod(pkg, "runners").plan_cache_key(q._plan)
        q.collect()
        base.select(bump(pkg.col("x")).alias("y")).collect()
        return key, calls["n"]  # ran twice: never served from a cache

    assert same(fn, {"enable_result_cache": True}) == (None, 2)


def test_limit_with_partition_filter(tmp_path):
    root = str(tmp_path)
    papq.write_table(pa.table({"v": list(range(100))}), os.path.join(root, "a.parquet"))
    papq.write_table(pa.table({"v": list(range(100, 200))}), os.path.join(root, "b.parquet"))
    _write_delta(root, [[
        {"add": {"path": "a.parquet", "size": 1, "partitionValues": {"p": "x"}}},
        {"add": {"path": "b.parquet", "size": 1, "partitionValues": {"p": "y"}}},
    ]])
    got = same(lambda pkg: rows_and_counters(
        pkg.read_deltalake(root).where(pkg.col("p") == "y").limit(3)))
    assert got[0]["v"] == [100, 101, 102]


def test_no_stale_hit_after_gc_id_reuse():
    import gc

    def fn(pkg):
        bad = []
        for i in range(30):
            vals = [i * 10, i * 10 + 1, i * 10 + 2]
            out = pkg.from_pydict({"x": vals}).select((pkg.col("x") * 2).alias("y")).collect()
            if out.to_pydict() != {"y": [v * 2 for v in vals]}:
                bad.append(i)
            del out
            gc.collect()
        return bad

    assert same(fn, {"enable_result_cache": True}) == []


def test_scan_cache_invalidated_on_overwrite(tmp_path):
    def fn(pkg):
        p = str(tmp_path / f"{pkg.__name__}.parquet")
        papq.write_table(pa.table({"a": [1, 2]}), p)
        df1 = pkg.read_parquet(p).collect()
        first = df1.to_pydict()
        papq.write_table(pa.table({"a": [9, 9, 9]}), p)
        os.utime(p, ns=(1, 1))  # a distinct mtime even on coarse clocks
        df2 = pkg.read_parquet(p).collect()
        return first, df2.to_pydict(), df1.to_pydict()

    assert same(fn, {"enable_result_cache": True}) == (
        {"a": [1, 2]}, {"a": [9, 9, 9]}, {"a": [1, 2]})


# ---------------------------------------------------------------------------
# TestAvro, and each package decoding the other's bytes
# ---------------------------------------------------------------------------

AVRO_SCHEMA = {"type": "record", "name": "t", "fields": [
    {"name": "a", "type": "long"},
    {"name": "s", "type": ["null", "string"]},
    {"name": "arr", "type": {"type": "array", "items": "int"}},
    {"name": "m", "type": {"type": "map", "values": "double"}},
    {"name": "sub", "type": {"type": "record", "name": "sub", "fields": [
        {"name": "x", "type": "boolean"}, {"name": "b", "type": "bytes"}]}},
    {"name": "fx", "type": {"type": "fixed", "name": "f4", "size": 4}},
    {"name": "e", "type": {"type": "enum", "name": "c", "symbols": ["R", "G", "B"]}},
]}
AVRO_RECORDS = [
    {"a": -12345678901234, "s": None, "arr": [1, -2, 3], "m": {"pi": 3.14},
     "sub": {"x": True, "b": b"\x00\xff"}, "fx": b"abcd", "e": "G"},
    {"a": 2**62, "s": "héllo", "arr": [], "m": {},
     "sub": {"x": False, "b": b""}, "fx": b"zzzz", "e": "B"},
]


def test_avro_round_trip_all_types(tmp_path, monkeypatch):
    monkeypatch.setattr(os, "urandom", lambda n: b"\x07" * n)  # one sync marker
    blobs = {}
    for pkg in PKGS:
        avro = _mod(pkg, "io.avro")
        p = str(tmp_path / f"{pkg.__name__}.avro")
        avro.write_avro_file(p, AVRO_SCHEMA, AVRO_RECORDS)
        with open(p, "rb") as f:
            blobs[pkg] = f.read()
        for reader in PKGS:  # each package decodes each package's file
            schema, got = _mod(reader, "io.avro").read_avro_file(p)
            assert got == AVRO_RECORDS and schema == AVRO_SCHEMA
    assert blobs[daft_tpu_torch] == blobs[daft_tpu]


def test_avro_deflate_codec(tmp_path):
    import zlib

    schema = {"type": "record", "name": "t", "fields": [{"name": "a", "type": "long"}]}
    recs = [{"a": i} for i in range(100)]
    for pkg in PKGS:
        A = _mod(pkg, "io.avro")
        w = A._Writer()
        w.write(A.MAGIC)
        m = {"avro.schema": json.dumps(schema).encode(), "avro.codec": b"deflate"}
        w.write_long(len(m))
        for k, v in m.items():
            w.write_utf8(k)
            w.write_bytes(v)
        w.write_long(0)
        sync = b"\x01" * 16
        w.write(sync)
        body = A._Writer()
        for rec in recs:
            A._encode(body, schema, rec)
        comp = zlib.compress(body.out.getvalue())[2:-4]  # raw deflate
        w.write_long(len(recs))
        w.write_long(len(comp))
        w.write(comp)
        w.write(sync)
        p = str(tmp_path / f"{pkg.__name__}.avro")
        with open(p, "wb") as f:
            f.write(w.out.getvalue())
        for reader in PKGS:
            assert _mod(reader, "io.avro").read_avro_file(p)[1] == recs


def test_avro_errors_match(tmp_path):
    p = str(tmp_path / "bad.avro")
    with open(p, "wb") as f:
        f.write(b"not avro")
    outs = [_outcome(lambda: _mod(pkg, "io.avro").read_avro_file(p)) for pkg in PKGS]
    assert outs[1] == outs[0] and outs[1][1] == "ValueError"


# ---------------------------------------------------------------------------
# TestIceberg, TestHudi
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["v2_with_deletes_in_log", "v1_inline_manifests",
                                  "moved_table_paths_remap", "pushdown_prunes_scan"])
def test_read_iceberg(tmp_path, case):
    root = str(tmp_path / "tbl")
    os.makedirs(root)
    if case == "v2_with_deletes_in_log":
        _build_iceberg(root, [pa.table({"x": [1, 2, 3], "y": ["a", "b", "c"]}),
                              pa.table({"x": [4], "y": ["d"]})], deleted_paths=["gone.parquet"])
        build, want = (lambda pkg: pkg.read_iceberg(root).sort("x"),
                       {"x": [1, 2, 3, 4], "y": ["a", "b", "c", "d"]})
    elif case == "v1_inline_manifests":
        _build_iceberg(root, [pa.table({"x": [7], "y": ["q"]})], fmt_version=1)
        build, want = lambda pkg: pkg.read_iceberg(root), {"x": [7], "y": ["q"]}
    elif case == "moved_table_paths_remap":
        # metadata written against an old absolute location: the reader
        # remaps by the /metadata/ and /data/ tails
        _build_iceberg(root, [pa.table({"x": [5], "y": ["m"]})],
                       location="/nonexistent/old/location")
        build, want = lambda pkg: pkg.read_iceberg(root), {"x": [5], "y": ["m"]}
    else:
        _build_iceberg(root, [pa.table({"x": [1, 2], "y": ["a", "b"]}),
                              pa.table({"x": [100, 200], "y": ["c", "d"]})])
        build, want = (lambda pkg: pkg.read_iceberg(root).where(pkg.col("x") > 50)
                       .select(pkg.col("x")).sort("x"), {"x": [100, 200]})

    def fn(pkg):
        df = build(pkg).collect()
        c = df.stats.snapshot()["counters"]
        return df.to_pydict(), counters(df), c.get("scan_tasks_pruned", 0)

    assert same(fn)[0] == want


def test_iceberg_merge_on_read_rejected(tmp_path):
    _build_iceberg(str(tmp_path), [pa.table({"x": [1], "y": ["a"]})], delete_file=True)
    got = same(lambda pkg: _outcome(lambda: pkg.read_iceberg(str(tmp_path))))
    assert got[:2] == ("raised", "ValueError") and "merge-on-read" in got[2]


def _hudi(root, slices):
    os.makedirs(os.path.join(root, ".hoodie"))
    for i, (fid, name, t) in enumerate(slices):
        papq.write_table(t, os.path.join(root, name))
        with open(os.path.join(root, ".hoodie", f"{i + 1:03d}.commit"), "w") as f:
            json.dump({"partitionToWriteStats": {"": [{"fileId": fid, "path": name}]}}, f)


def test_hudi_read_cow_timeline(tmp_path):
    root = str(tmp_path)
    _hudi(root, [("f1", "p1.parquet", pa.table({"x": [1, 2], "y": ["a", "b"]})),
                 ("f2", "p2.parquet", pa.table({"x": [3], "y": ["c"]}))])
    got = same(lambda pkg: rows_and_counters(pkg.read_hudi(root).sort("x")))
    assert got[0] == {"x": [1, 2, 3], "y": ["a", "b", "c"]}


def test_hudi_latest_file_slice_wins(tmp_path):
    root = str(tmp_path)
    # the same fileId in both commits: only the latest slice survives
    _hudi(root, [("g1", "s0.parquet", pa.table({"x": [1], "y": ["old"]})),
                 ("g1", "s1.parquet", pa.table({"x": [1], "y": ["new"]}))])
    assert same(lambda pkg: rows_and_counters(pkg.read_hudi(root)))[0] == {
        "x": [1], "y": ["new"]}


def test_hudi_merge_on_read_rejected(tmp_path):
    root = str(tmp_path)
    _hudi(root, [("f1", "p1.parquet", pa.table({"x": [1]}))])
    open(os.path.join(root, ".hoodie", "002.deltacommit"), "w").close()
    got = same(lambda pkg: _outcome(lambda: pkg.read_hudi(root)))
    assert got[:2] == ("raised", "ValueError") and "merge-on-read" in got[2]


# ---------------------------------------------------------------------------
# TestWriteDeltalake, TestWriteIceberg: each package writes its own table;
# the rows read back, by both packages, must agree
# ---------------------------------------------------------------------------

def _lake(fmt):
    return (lambda df, uri, **kw: getattr(df, f"write_{fmt}")(uri, **kw),
            lambda pkg, uri, **kw: getattr(pkg, f"read_{fmt}")(uri, **kw))


@pytest.mark.parametrize("fmt", ["deltalake", "iceberg"])
@pytest.mark.parametrize("case", ["round_trip", "append_and_overwrite", "error_mode",
                                  "multi_partition", "all_empty_partitions"])
def test_write_lake(tmp_path, fmt, case):
    write, read = _lake(fmt)
    xy = lambda pkg, x, y: pkg.from_pydict({"x": x, "y": y})  # noqa: E731

    def fn(pkg):
        uri = str(tmp_path / pkg.__name__ / "tbl")
        steps = []
        if case == "round_trip":
            out = write(xy(pkg, [1, 2, 3], ["a", "b", "c"]), uri)
            steps.append(len(out.to_pydict()["path"]))
        elif case == "append_and_overwrite":
            write(xy(pkg, [1], ["a"]), uri)
            write(xy(pkg, [2], ["b"]), uri, mode="append")
            steps.append(read(pkg, uri).sort("x").to_pydict())
            write(xy(pkg, [9], ["z"]), uri, mode="overwrite")
        elif case == "error_mode":
            write(xy(pkg, [1], ["a"]), uri)
            steps.append(_outcome(lambda: write(xy(pkg, [2], ["b"]), uri, mode="error"))[:2])
        elif case == "multi_partition":
            write(pkg.from_pydict({"x": list(range(100)),
                                   "y": [f"r{i}" for i in range(100)]}).repartition(4), uri)
        else:
            write(pkg.from_pydict({"x": pa.array([], pa.int64()),
                                   "y": pa.array([], pa.string())}), uri)
        if case == "all_empty_partitions" and fmt == "deltalake":
            steps.append(_outcome(lambda: read(pkg, uri).to_pydict())[:2])
        else:
            steps.append(read(pkg, uri).sort("x").to_pydict())
            steps.append(read(_other(pkg), uri).sort("x").to_pydict())
        return steps

    got = same(fn)
    if case == "round_trip":
        assert got[0] >= 1 and got[1] == got[2] == {"x": [1, 2, 3], "y": ["a", "b", "c"]}
    elif case == "append_and_overwrite":
        assert got[0] == {"x": [1, 2], "y": ["a", "b"]}
        assert got[1] == got[2] == {"x": [9], "y": ["z"]}
    elif case == "error_mode":
        assert got[0] == ("raised", "FileExistsError") and got[1] == {"x": [1], "y": ["a"]}
    elif case == "multi_partition":
        assert got[0]["x"] == got[1]["x"] == list(range(100))
    elif fmt == "iceberg":
        assert got[0] == got[1] == {"x": [], "y": []}


def test_deltalake_error_mode_and_commit_collision(tmp_path, monkeypatch):
    """A concurrent writer lands the next version between this writer's log
    listing and its commit: the put-if-absent raises, nothing of the loser
    is committed, and a clean retry commits the version after."""
    def fn(pkg):
        root = str(tmp_path / pkg.__name__ / "tbl")
        pkg.from_pydict({"x": [1]}).write_deltalake(root)
        err = _outcome(lambda: pkg.from_pydict({"x": [2]}).write_deltalake(root, mode="error"))
        log = os.path.join(root, "_delta_log")
        real_listdir = os.listdir
        racer = f"{1:020d}.json"

        def stale_then_race(path):
            names = list(real_listdir(path))
            if os.path.abspath(path) == os.path.abspath(log):
                p = os.path.join(log, racer)
                if not os.path.exists(p):
                    open(p, "w").close()
                names = [n for n in names if n != racer]  # a stale view
            return names

        with monkeypatch.context() as m:
            m.setattr(_mod(pkg, "io.catalogs").os, "listdir", stale_then_race)
            lost = _outcome(lambda: pkg.from_pydict({"x": [3]}).write_deltalake(root,
                                                                               mode="append"))
        commits = sorted(n for n in os.listdir(log) if n.endswith(".json"))
        pkg.from_pydict({"x": [3]}).write_deltalake(root, mode="append")
        return (err[:2], lost[:2], commits, sorted(n for n in os.listdir(log)),
                pkg.read_deltalake(root).sort("x").to_pydict())

    err, lost, commits, after, rows = same(fn)
    assert err == lost == ("raised", "FileExistsError")
    assert commits == [f"{0:020d}.json", f"{1:020d}.json"]  # the loser left no commit
    assert after == commits + [f"{2:020d}.json"]
    assert rows["x"] == [1, 3]


def test_iceberg_append_and_snapshot_time_travel(tmp_path):
    def fn(pkg):
        root = str(tmp_path / pkg.__name__ / "ice")
        pkg.from_pydict({"x": [1], "y": ["a"]}).write_iceberg(root)
        with open(os.path.join(root, "metadata", "v1.metadata.json")) as f:
            first = json.load(f)["current-snapshot-id"]
        pkg.from_pydict({"x": [2], "y": ["b"]}).write_iceberg(root, mode="append")
        return [p.read_iceberg(root).sort("x").to_pydict() for p in (pkg, _other(pkg))] + [
            p.read_iceberg(root, snapshot_id=first).to_pydict() for p in (pkg, _other(pkg))]

    assert same(fn) == [{"x": [1, 2], "y": ["a", "b"]}] * 2 + [{"x": [1], "y": ["a"]}] * 2


@pytest.mark.parametrize("fmt_version", [1, 2])
def test_iceberg_append_onto_fixture_built_table(tmp_path, fmt_version):
    """test_append_onto_fixture_built_table (v2) and
    test_append_onto_v1_table_keeps_existing_data (v1 inline manifests)."""
    def fn(pkg):
        root = str(tmp_path / pkg.__name__ / "ice")
        os.makedirs(root)
        _build_iceberg(root, [pa.table({"x": [1, 2], "y": ["a", "b"]})],
                       fmt_version=fmt_version)
        pkg.from_pydict({"x": [3], "y": ["c"]}).write_iceberg(root, mode="append")
        return [p.read_iceberg(root).sort("x").to_pydict() for p in (pkg, _other(pkg))]

    assert same(fn) == [{"x": [1, 2, 3], "y": ["a", "b", "c"]}] * 2


def test_iceberg_append_onto_v1_manifest_list_table(tmp_path):
    """v1 tables can also use a manifest-list file whose records predate the
    ``content`` field; an append normalizes them."""
    def fn(pkg):
        avro = _mod(pkg, "io.avro")
        root = str(tmp_path / pkg.__name__ / "ice")
        os.makedirs(os.path.join(root, "metadata"))
        os.makedirs(os.path.join(root, "data"))
        papq.write_table(pa.table({"x": [1, 2], "y": ["a", "b"]}),
                         os.path.join(root, "data", "f0.parquet"))
        entries = [{"status": 1, "snapshot_id": 7,
                    "data_file": {"content": 0, "file_path": f"file://{root}/data/f0.parquet",
                                  "file_format": "PARQUET", "partition": {},
                                  "record_count": 2, "file_size_in_bytes": 100}}]
        mpath = os.path.join(root, "metadata", "m0.avro")
        avro.write_avro_file(mpath, _MANIFEST_ENTRY_SCHEMA, entries)
        v1_mlist_schema = {"type": "record", "name": "manifest_file", "fields": [
            {"name": "manifest_path", "type": "string"},
            {"name": "manifest_length", "type": "long"},
            {"name": "partition_spec_id", "type": "int"}]}
        avro.write_avro_file(os.path.join(root, "metadata", "snap-7.avro"), v1_mlist_schema, [{
            "manifest_path": f"file://{root}/metadata/m0.avro",
            "manifest_length": os.path.getsize(mpath), "partition_spec_id": 0}])
        meta = {"format-version": 1, "table-uuid": "0", "location": root,
                "current-snapshot-id": 7,
                "snapshots": [{"snapshot-id": 7, "timestamp-ms": 0,
                               "manifest-list": f"file://{root}/metadata/snap-7.avro"}],
                "schema": {"type": "struct", "fields": [
                    {"id": 1, "name": "x", "type": "long"},
                    {"id": 2, "name": "y", "type": "string"}]}}
        with open(os.path.join(root, "metadata", "v1.metadata.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(root, "metadata", "version-hint.text"), "w") as f:
            f.write("1")
        before = pkg.read_iceberg(root).sort("x").to_pydict()
        pkg.from_pydict({"x": [3], "y": ["c"]}).write_iceberg(root, mode="append")
        return before, [p.read_iceberg(root).sort("x").to_pydict() for p in (pkg, _other(pkg))]

    before, after = same(fn)
    assert before == {"x": [1, 2], "y": ["a", "b"]}
    assert after == [{"x": [1, 2, 3], "y": ["a", "b", "c"]}] * 2


def test_iceberg_manifests_decode_across_packages(tmp_path):
    """The avro a package's write_iceberg commits (manifest list and
    manifests) decodes with the other package's read_avro_file to the same
    records."""
    def fn(pkg):
        root = str(tmp_path / pkg.__name__ / "ice")
        pkg.from_pydict({"x": [1, 2], "y": ["a", "b"]}).write_iceberg(root)
        pkg.from_pydict({"x": [3], "y": ["c"]}).write_iceberg(root, mode="append")
        names = sorted(n for n in os.listdir(os.path.join(root, "metadata"))
                       if n.endswith(".avro"))
        decoded = []
        for n in names:
            p = os.path.join(root, "metadata", n)
            mine = _mod(pkg, "io.avro").read_avro_file(p)
            theirs = _mod(_other(pkg), "io.avro").read_avro_file(p)
            assert mine == theirs
            decoded.append(len(mine[1]))
        return sorted(decoded)

    # two manifests of one entry each, a manifest list of one record, then one of two
    assert same(fn) == [1, 1, 1, 2]


# ---------------------------------------------------------------------------
# TestPythonScanOperator and the factory cases of TestLanceGated
# ---------------------------------------------------------------------------

def _operator(pkg, n_fragments=3, rows=10):
    pyscan, schema_mod = _mod(pkg, "io.pyscan"), _mod(pkg, "schema")
    schema = schema_mod.Schema([schema_mod.Field("a", pkg.DataType.int64()),
                                schema_mod.Field("s", pkg.DataType.string())])
    calls = []

    class Op(pyscan.ScanOperator):
        def schema(self):
            return schema

        def to_scan_tasks(self, pushdowns):
            for i in range(n_fragments):
                def factory(pd, _i=i):
                    calls.append((_i, pd.columns))
                    return pa.table({
                        "a": pa.array([_i * rows + j for j in range(rows)], pa.int64()),
                        "s": pa.array([f"r{_i}-{j}" for j in range(rows)])})

                yield pyscan.FactoryScanTask(factory, schema, pushdowns, num_rows=rows,
                                             label=f"frag-{i}")

    return Op(), calls


def test_scan_operator_e2e():
    def fn(pkg):
        op, calls = _operator(pkg)
        out = rows_and_counters(pkg.from_scan_operator(op).where(pkg.col("a") >= 15)
                                .select(pkg.col("a")).sort("a"))
        return out, sorted(calls)

    (out, _), calls = same(fn)
    assert out == {"a": list(range(15, 30))}
    assert [c[0] for c in calls] == [0, 1, 2]


def test_pushdowns_reapplied_after_factory():
    # the factory ignores every pushdown; the engine applies them again
    got = same(lambda pkg: pkg.from_scan_operator(_operator(pkg)[0]).limit(4).to_pydict())
    assert got["a"] == [0, 1, 2, 3]


def test_factory_batches_and_empty():
    def fn(pkg):
        pyscan, schema_mod = _mod(pkg, "io.pyscan"), _mod(pkg, "schema")
        schema = schema_mod.Schema([schema_mod.Field("x", pkg.DataType.int32())])

        class Op(pyscan.ScanOperator):
            def schema(self):
                return schema

            def to_scan_tasks(self, pushdowns):
                yield pyscan.FactoryScanTask(lambda pd: iter([]), schema, pushdowns,
                                             label="empty")
                yield pyscan.FactoryScanTask(
                    lambda pd: iter(pa.table({"x": pa.array([1, 2], pa.int32())}).to_batches()),
                    schema, pushdowns, label="batches")

        return pkg.from_scan_operator(Op()).to_pydict()

    assert same(fn) == {"x": [1, 2]}


def test_groupby_over_scan_operator():
    def fn(pkg):
        op, _ = _operator(pkg, n_fragments=2, rows=6)
        return rows_and_counters(pkg.from_scan_operator(op).with_column("g", pkg.col("a") % 2)
                                 .groupby("g").agg(pkg.col("a").sum().alias("s")).sort("g"))

    out, _ = same(fn)
    assert out["g"] == [0, 1] and sum(out["s"]) == sum(range(12))


def test_absorbed_columns_keep_filter_inputs():
    # a factory that honors the column pushdown must still produce a
    # filter's input column that the projection drops
    def fn(pkg):
        pyscan, schema_mod = _mod(pkg, "io.pyscan"), _mod(pkg, "schema")
        schema = schema_mod.Schema([schema_mod.Field("k", pkg.DataType.int64()),
                                    schema_mod.Field("v", pkg.DataType.float64())])
        seen = []

        class Op(pyscan.ScanOperator):
            def schema(self):
                return schema

            def can_absorb_select(self):
                return True

            def to_scan_tasks(self, pushdowns):
                def factory(pd):
                    seen.append(pd.columns)
                    data = {"k": pa.array([0, 1, 2, 3], pa.int64()),
                            "v": pa.array([0.5, 1.5, 2.5, 3.5])}
                    cols = pd.columns if pd.columns is not None else list(data)
                    return pa.table({c: data[c] for c in cols})

                yield pyscan.FactoryScanTask(factory, schema, pushdowns, label="f0")

        got = (pkg.from_scan_operator(Op()).where(pkg.col("k") == 3)
               .select(pkg.col("v")).to_pydict())
        return got, bool(seen) and all("k" in (c or ["k"]) for c in seen)

    assert same(fn) == ({"v": [3.5]}, True)


def test_factory_tasks_never_cache_collide(tmp_path):
    label = str(tmp_path / "src.bin")
    with open(label, "w") as f:
        f.write("x")  # a stat-able label shared by both operators

    def fn(pkg):
        pyscan, schema_mod = _mod(pkg, "io.pyscan"), _mod(pkg, "schema")
        schema = schema_mod.Schema([schema_mod.Field("a", pkg.DataType.int64())])

        def make_op(values):
            class Op(pyscan.ScanOperator):
                def schema(self):
                    return schema

                def to_scan_tasks(self, pushdowns):
                    yield pyscan.FactoryScanTask(
                        lambda pd: pa.table({"a": pa.array(values, pa.int64())}),
                        schema, pushdowns, label=label)

            return Op()

        df1 = pkg.from_scan_operator(make_op([1, 2])).collect()
        key = _mod(pkg, "runners").plan_cache_key(pkg.from_scan_operator(make_op([5]))._plan)
        got2 = pkg.from_scan_operator(make_op([7, 8])).to_pydict()
        return key, got2, df1.to_pydict()

    assert same(fn, {"enable_result_cache": True}) == (None, {"a": [7, 8]}, {"a": [1, 2]})


# ---------------------------------------------------------------------------
# TestLanceGated and the Ray and Dask gates
# ---------------------------------------------------------------------------

def _missing(name: str) -> bool:
    try:
        import_module(name)
        return False
    except ImportError:
        return True


@pytest.mark.parametrize("case", ["read_lance", "write_lance", "from_ray_dataset",
                                  "to_ray_dataset", "from_dask_dataframe", "to_dask_dataframe"])
def test_optional_packages_are_gated(tmp_path, case):
    needs = {"read_lance": "lance", "write_lance": "lance", "from_ray_dataset": "ray",
             "to_ray_dataset": "ray", "from_dask_dataframe": "dask",
             "to_dask_dataframe": "dask"}[case]
    if not _missing(needs):
        pytest.skip(f"{needs} installed; the gate does not apply")
    path = str(tmp_path / "t.lance")
    calls = {
        "read_lance": lambda pkg: pkg.read_lance(path),
        "write_lance": lambda pkg: pkg.from_pydict({"a": [1]}).write_lance(path),
        "from_ray_dataset": lambda pkg: pkg.from_ray_dataset(object()),
        "to_ray_dataset": lambda pkg: pkg.from_pydict({"a": [1]}).to_ray_dataset(),
        "from_dask_dataframe": lambda pkg: pkg.from_dask_dataframe(object()),
        "to_dask_dataframe": lambda pkg: pkg.from_pydict({"a": [1]}).to_dask_dataframe(),
    }
    ref, got = both(lambda pkg: _outcome(lambda: calls[case](pkg)))
    assert got[:2] == ref[:2] == ("raised", "ImportError")
    assert needs in got[2]
    if case != "to_ray_dataset":  # the reference names its jax mesh there
        assert got == ref


def test_lance_roundtrip_if_available(tmp_path):
    pytest.importorskip("lance")

    def fn(pkg):
        uri = str(tmp_path / f"{pkg.__name__}.lance")
        pkg.from_pydict({"a": [1, 2, 3], "s": ["x", "y", "z"]}).write_lance(uri)
        return pkg.read_lance(uri).sort("a").to_pydict()

    assert same(fn) == {"a": [1, 2, 3], "s": ["x", "y", "z"]}


# ---------------------------------------------------------------------------
# TestUnityCatalog
# ---------------------------------------------------------------------------

def _serve_unity(tables):
    import http.server
    import threading

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            from urllib.parse import unquote, urlparse

            path = urlparse(self.path).path
            body = None
            if path.endswith("/catalogs"):
                body = {"catalogs": [{"name": "main"}]}
            elif path.endswith("/schemas"):
                body = {"schemas": [{"name": "default"}]}
            elif path.endswith("/tables"):
                body = {"tables": [{"name": n.split(".")[-1]} for n in tables]}
            else:
                name = unquote(path.rsplit("/", 1)[-1])
                if name in tables:
                    body = {"name": name, "storage_location": tables[name]}
            if body is None:
                self.send_response(404)
                self.end_headers()
                return
            data = json.dumps(body).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def test_unity_list_and_load_and_read(tmp_path):
    uri = str(tmp_path / "t_delta")
    daft_tpu_torch.from_pydict({"a": [1, 2, 3], "s": ["x", "y", "z"]}).write_deltalake(uri)
    srv, ep = _serve_unity({"main.default.t": uri})
    try:
        def fn(pkg):
            cat = _mod(pkg, "io.unity").UnityCatalog(ep, token="tok")
            table = cat.load_table("main.default.t")
            return (cat.list_catalogs(), cat.list_schemas("main"),
                    cat.list_tables("main.default"), table.table_uri == uri,
                    pkg.read_deltalake(table).sort("a").to_pydict())

        assert same(fn) == (["main"], ["main.default"], ["main.default.t"], True,
                            {"a": [1, 2, 3], "s": ["x", "y", "z"]})
    finally:
        srv.shutdown()
        srv.server_close()


def test_unity_missing_location_raises(tmp_path):
    srv, ep = _serve_unity({"main.default.v": ""})
    try:
        got = same(lambda pkg: _outcome(
            lambda: _mod(pkg, "io.unity").UnityCatalog(ep).load_table("main.default.v")))
        assert got[:2] == ("raised", "ValueError") and "storage_location" in got[2]
    finally:
        srv.shutdown()
        srv.server_close()


# ---------------------------------------------------------------------------
# a 2-process cluster of the port over gloo reading lake tables
# ---------------------------------------------------------------------------

def test_two_process_cluster_reads_iceberg_and_a_scan_operator(tmp_path, monkeypatch):
    from test_torch_multihost import _line, _spawn

    root = str(tmp_path / "ice")
    os.makedirs(root)
    rng = np.random.RandomState(3)
    tables = [pa.table({"k": rng.randint(0, 12, 500).astype(np.int64),
                        "v": rng.randint(0, 1000, 500).astype(np.int64)}) for _ in range(4)]
    daft_tpu.from_arrow(tables).write_iceberg(root)  # the reference's commit
    monkeypatch.setenv("TORCH_MH_LAKE", root)
    outs = _spawn("lake", 2)
    want = (daft_tpu.read_iceberg(root).groupby("k").agg(daft_tpu.col("v").sum().alias("s"))
            .sort("k").to_pydict())
    opened = 0
    for i, out in enumerate(outs):
        assert f"LAKE_ICEBERG_OK {i}" in out, out
        got = json.loads(_line(out, "LAKE_ICEBERG_ROWS ").split(" ", 1)[1])
        assert got == want
        opened += int(_line(out, f"LAKE_ICEBERG_OK {i}").split("opened=")[1])
        # the factories' rows through the exchange, as the reference's
        # single process sums them
        assert f"LAKE_FACTORY_OK {i}" in out, out
        fac = json.loads(_line(out, "LAKE_FACTORY_ROWS ").split(" ", 1)[1])
        op, _ = _operator(daft_tpu, n_fragments=4, rows=25)
        ref_fac = (daft_tpu.from_scan_operator(op).with_column("g", daft_tpu.col("a") % 3)
                   .groupby("g").agg(daft_tpu.col("a").sum().alias("s")).sort("g").to_pydict())
        assert fac == ref_fac
    # each data file is read by its owning process alone (task i by i % 2)
    assert opened == len(tables)


# ---------------------------------------------------------------------------
# chip_smoke.py phase 19's tables, read by both packages
# ---------------------------------------------------------------------------

def test_phase19_tables_read_alike(tmp_path, monkeypatch):
    """The Delta log and the Iceberg table that chip_smoke.py's phase 19
    builds over one parquet file (its manifests by the port's avro codec),
    the file behind its loopback S3 endpoint, and its ScanOperator of the
    file's row groups give both packages the same rows."""
    import chip_smoke
    from benchmarks import tpch_full

    li = tpch_full.generate(scale=0.001, seed=7)["lineitem"]
    path = str(tmp_path / "lineitem.parquet")
    papq.write_table(li, path, row_group_size=-(-li.num_rows // 4))
    chip_smoke.delta_over(path, str(tmp_path / "delta"))
    chip_smoke.iceberg_over(path, str(tmp_path / "iceberg"))
    s3 = chip_smoke.LoopbackS3()
    try:
        s3.objects[("lake", "lineitem/part-0.parquet")] = path
        monkeypatch.setenv("AWS_ENDPOINT_URL", s3.endpoint)
        readers = {"delta": lambda pkg: pkg.read_deltalake(str(tmp_path / "delta")),
                   "iceberg": lambda pkg: pkg.read_iceberg(str(tmp_path / "iceberg")),
                   "s3": lambda pkg: pkg.read_parquet("s3://lake/lineitem/*.parquet")}

        def fn(pkg):
            col = pkg.col
            out = {}
            for name, read in readers.items():
                out[name] = rows_and_counters(
                    read(pkg).where(col("l_discount") > 0.03).groupby("l_returnflag", "l_linestatus")
                    .agg(col("l_quantity").sum().alias("q"), col("l_orderkey").count().alias("n"))
                    .sort(["l_returnflag", "l_linestatus"]))[0]
            return out

        got = same(fn)
        want = got["delta"]
        assert got["iceberg"] == got["s3"] == want and sum(want["n"]) > 0
        assert s3.sent > 0
        op = chip_smoke.row_group_operator(path)
        factory = (daft_tpu_torch.from_scan_operator(op).where(daft_tpu_torch.col("l_discount") > 0.03)
                   .groupby("l_returnflag", "l_linestatus")
                   .agg(daft_tpu_torch.col("l_quantity").sum().alias("q"),
                        daft_tpu_torch.col("l_orderkey").count().alias("n"))
                   .sort(["l_returnflag", "l_linestatus"]).to_pydict())
        assert factory["n"] == want["n"]
        assert factory["q"] == pytest.approx(want["q"], rel=1e-9)
    finally:
        s3.stop()
