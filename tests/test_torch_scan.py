"""The port's scan layer (stats.py, io/readers.py, io/scan.py,
io/object_store.py) against daft_tpu's, case by case from
tests/test_io_scan.py: pushdowns, row-group pruning, statistics, lazy
partitions, globbing, the CSV and JSON readers (the JSON streaming among
them), merged scan tasks, the arrow IPC reader and the scan retries. Each
case runs once through each package over the same files (written by
pyarrow) and returns what it observed; the two must be equal. The cases of
tests/test_io_scan.py over the writer are left out with the writer.
"""

import json
import os
import types

import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.parquet as papq
import pytest

import daft_tpu
import daft_tpu_torch
from torch_parity import restore_port_config  # noqa: F401


def _ns(pkg):
    """The scan-layer names of one package."""
    from importlib import import_module

    name = pkg.__name__
    io = import_module(f"{name}.io")
    readers = import_module(f"{name}.io.readers")
    scan = import_module(f"{name}.io.scan")
    stats = import_module(f"{name}.stats")
    return types.SimpleNamespace(
        pkg=pkg, col=pkg.col, IO_STATS=io.IO_STATS, FileFormat=io.FileFormat,
        Pushdowns=io.Pushdowns, ScanTask=io.ScanTask, glob_paths=io.glob_paths,
        readers=readers, scan=scan, stats=stats,
        MicroPartition=import_module(f"{name}.micropartition").MicroPartition,
        Schema=import_module(f"{name}.schema").Schema,
        Table=import_module(f"{name}.table").Table,
        ScanSource=import_module(f"{name}.logical").ScanSource,
        faults=import_module(f"{name}.faults"),
        object_store=import_module(f"{name}.io.object_store"))


REF, PORT = _ns(daft_tpu), _ns(daft_tpu_torch)


@pytest.fixture(autouse=True)
def _configs():
    """Both packages with scan retries that do not sleep; the port on the
    CPU."""
    from daft_tpu.context import get_context

    cfg = get_context().execution_config
    saved = cfg.scan_retry_backoff_s
    cfg.scan_retry_backoff_s = 0.0
    daft_tpu_torch.set_execution_config(device="cpu", scan_retry_backoff_s=0.0)
    try:
        yield
    finally:
        cfg.scan_retry_backoff_s = saved
        daft_tpu.faults.disarm()
        daft_tpu_torch.faults.disarm()


@pytest.fixture
def pq_file(tmp_path):
    p = str(tmp_path / "t.parquet")
    papq.write_table(pa.table({
        "a": list(range(1000)),
        "b": [float(i) * 0.5 for i in range(1000)],
        "c": ["x" * (i % 5) for i in range(1000)],
    }), p, row_group_size=100)
    return p


def _io(m) -> dict:
    return m.IO_STATS.snapshot()


# ---------------------------------------------------------------------------
# the readers and the statistics over one parquet file
# ---------------------------------------------------------------------------

def _column_pushdown(m, p):
    m.IO_STATS.reset()
    out = m.readers.read_parquet_table(p, m.Pushdowns(columns=["b"]))
    return out.column_names, _io(m)


def _rowgroup_pruning(m, p):
    m.IO_STATS.reset()
    out = m.readers.read_parquet_table(p, m.Pushdowns(filters=(m.col("a") > 950)._node))
    return out.to_pydict(), _io(m)


def _limit_early_stop(m, p):
    m.IO_STATS.reset()
    out = m.readers.read_parquet_table(p, m.Pushdowns(limit=150))
    return len(out), _io(m)


def _filter_only_column_dropped(m, p):
    out = m.readers.read_parquet_table(
        p, m.Pushdowns(columns=["b"], filters=(m.col("a") > 990)._node))
    return out.to_pydict()


def _rowgroup_stats_bounds(m, p):
    md = m.readers.parquet_metadata(p)
    sch = m.Schema.from_arrow(papq.ParquetFile(p).schema_arrow)
    st = m.readers.row_group_stats(md, 3, sch)
    return {k: (c.min, c.max, c.null_count) for k, c in st.columns.items()}, st.num_rows


def _parquet_chunks(m, p):
    # the chunk-wise read chooses the whole-file read's row groups
    pd = m.Pushdowns(columns=["a"], filters=(m.col("a") > 650)._node, limit=None)
    pf, chosen, columns, _ = m.readers.plan_parquet_chunks(p, pd)
    chunks = [m.readers.read_parquet_chunk(pf, rg, columns, pd, None).to_pydict()
              for rg in chosen]
    whole = m.readers.read_parquet_table(p, pd).to_pydict()
    return chosen, columns, chunks, whole


def _scan_task_lazy_metadata(m, p):
    md = m.readers.parquet_metadata(p)
    sch = m.Schema.from_arrow(papq.ParquetFile(p).schema_arrow)
    task = m.ScanTask(p, m.FileFormat.PARQUET, sch, m.Pushdowns(limit=150),
                      num_rows=md.num_rows, size_bytes=os.path.getsize(p))
    mp = m.MicroPartition.from_scan_task(task)
    out = [mp.is_loaded(), mp.num_rows_or_none()]
    mp2 = mp.head(50)
    out += [mp2.is_loaded(), len(mp2)]
    mp3 = m.MicroPartition.from_scan_task(task.with_pushdowns(m.Pushdowns())).select_columns(["a"])
    out += [mp3.is_loaded(), mp3.table().column_names, mp3.is_loaded()]
    return out


def _statistics_and_chunks(m, p):
    # an unloaded partition answers its file statistics and reads chunk by
    # chunk without loading
    md = m.readers.parquet_metadata(p)
    sch = m.Schema.from_arrow(papq.ParquetFile(p).schema_arrow)
    st = m.readers.row_group_stats(md, 0, sch)
    for rg in range(1, md.num_row_groups):
        st = st.merge(m.readers.row_group_stats(md, rg, sch))
    task = m.ScanTask(p, m.FileFormat.PARQUET, sch,
                      m.Pushdowns(filters=(m.col("a") >= 420)._node),
                      num_rows=md.num_rows, size_bytes=os.path.getsize(p), stats=st)
    mp = m.MicroPartition.from_scan_task(task)
    stats = mp.statistics()
    chunks = [len(t) for t in mp.iter_chunk_tables()]
    return (stats.num_rows, stats.columns["a"].min, stats.columns["a"].max, chunks,
            mp.is_loaded(), len(mp.table()))


READER_CASES = {
    "column_pushdown": _column_pushdown,
    "rowgroup_pruning": _rowgroup_pruning,
    "limit_early_stop": _limit_early_stop,
    "filter_only_column_dropped": _filter_only_column_dropped,
    "rowgroup_stats_bounds": _rowgroup_stats_bounds,
    "parquet_chunks": _parquet_chunks,
    "scan_task_lazy_metadata": _scan_task_lazy_metadata,
    "statistics_and_chunks": _statistics_and_chunks,
}


@pytest.mark.parametrize("case", list(READER_CASES))
def test_parquet_reader_case(pq_file, case):
    fn = READER_CASES[case]
    assert fn(PORT, pq_file) == fn(REF, pq_file)


def test_filter_may_match_tristate():
    def run(m):
        st = m.stats.TableStats({"a": m.stats.ColumnStats(10, 20, 0)}, num_rows=5)
        c = m.col
        preds = [c("a") > 25, c("a") > 15, (c("a") > 25) & (c("a") < 100),
                 (c("a") > 25) | (c("a") < 15), c("zz") == 1, ~(c("a") > 25),
                 c("a").is_null(), c("a") == 5, c("a") <= 9, c("a") != 10]
        merged = st.merge(m.stats.TableStats({"a": m.stats.ColumnStats(30, 40, 2)}, 3))
        return ([m.stats.filter_may_match(p._node, st) for p in preds],
                merged.num_rows, merged.columns["a"].min, merged.columns["a"].max,
                merged.columns["a"].null_count)

    got = run(PORT)
    assert got == run(REF)
    assert got[0][:5] == [False, True, False, True, True]


def test_micropartition_concat_chains():
    def run(m):
        t = m.Table.from_pydict({"x": [1, 2], "y": ["a", "b"]})
        mp = m.MicroPartition.concat([m.MicroPartition.from_table(t),
                                      m.MicroPartition.from_table(t)])
        return len(mp), mp.table().to_pydict()

    assert run(PORT) == run(REF)


def test_glob_paths(tmp_path):
    for i in range(3):
        (tmp_path / f"f{i}.csv").write_text("a\n1\n")
    (tmp_path / "_hidden.csv").write_text("a\n1\n")

    def run(m):
        out = [m.glob_paths(str(tmp_path)), m.glob_paths(str(tmp_path / "*.csv")),
               m.glob_paths([str(tmp_path / "f0.csv"), "file://" + str(tmp_path / "f1.csv")])]
        for bad in (tmp_path / "nope" / "*.csv", tmp_path / "missing.csv"):
            with pytest.raises(FileNotFoundError):
                m.glob_paths(str(bad))
        return out

    got = run(PORT)
    assert got == run(REF)
    assert [len(g) for g in got] == [3, 4, 2]


def _closed_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_remote_paths_raise_naming_the_roadmap(monkeypatch):
    # named in the fifteenth slice, when a remote path raised and named
    # ROADMAP Queue 1 item 9; since that item a remote path goes to the
    # object-store client, and a store that refuses the connection raises
    # the reference's transient error after the same retries
    assert PORT.object_store.is_remote_path("s3://b/k.parquet")
    assert not PORT.object_store.is_remote_path("/tmp/k.parquet")
    endpoint = f"http://127.0.0.1:{_closed_port()}"
    monkeypatch.setenv("AWS_ENDPOINT_URL", endpoint)
    monkeypatch.setenv("GCS_ENDPOINT_URL", endpoint)
    for path in ("s3://bucket/t.parquet", f"{endpoint}/t.csv", "gs://b/x/*.parquet"):
        assert PORT.object_store.is_remote_path(path) == REF.object_store.is_remote_path(path)
        seen = []
        for ns in (REF, PORT):
            ns.IO_STATS.reset()
            for fn in (ns.glob_paths, ns.pkg.read_parquet):
                try:
                    out = fn(path)
                    seen.append(("ok", out if fn is ns.glob_paths else None))
                except Exception as e:  # the error is what is compared
                    seen.append((type(e).__name__, str(e)))
            seen.append(ns.IO_STATS.snapshot()["retries"])
        assert seen[3:] == seen[:3]
        # an http url globs to itself without a request; every other step
        # makes one, retried 4 times
        http = path.startswith(endpoint)
        assert seen[0][0] == ("ok" if http else "TransientIOError")
        assert seen[1][0] == "TransientIOError"
        assert seen[2] == (4 if http else 8)


# ---------------------------------------------------------------------------
# CSV and JSON
# ---------------------------------------------------------------------------

def test_csv_roundtrip_pushdowns(tmp_path):
    p = str(tmp_path / "t.csv")
    pacsv.write_csv(pa.table({"a": [1, 2, 3], "b": ["x", "y", "z"]}), p)

    def run(m):
        sch = m.readers.infer_csv_schema(p)
        m.IO_STATS.reset()
        out = m.readers.read_csv_table(p, m.Pushdowns(columns=["b"], limit=2), schema=sch)
        return sch.field_names(), out.to_pydict(), _io(m)

    got = run(PORT)
    assert got == run(REF)
    assert got[1] == {"b": ["x", "y"]}


def test_csv_no_header(tmp_path):
    p = str(tmp_path / "nh.csv")
    with open(p, "w") as f:
        f.write("1,x\n2,y\n")

    def run(m):
        sch = m.readers.infer_csv_schema(p, has_headers=False)
        return m.readers.read_csv_table(p, schema=sch, has_headers=False).to_pydict()

    assert run(PORT) == run(REF)


def test_json_reader(tmp_path):
    p = str(tmp_path / "t.jsonl")
    with open(p, "w") as f:
        for i in range(10):
            f.write(json.dumps({"a": i, "s": f"v{i}", "nested": {"k": i * 2}}) + "\n")

    def run(m):
        sch = m.readers.infer_json_schema(p)
        m.IO_STATS.reset()
        out = m.readers.read_json_table(p, m.Pushdowns(filters=(m.col("a") < 3)._node))
        return sch.field_names(), out.to_pydict(), _io(m)

    got = run(PORT)
    assert got == run(REF)
    assert len(got[1]["a"]) == 3


def _big_json(tmp_path, n):
    p = str(tmp_path / f"big{n}.json")
    with open(p, "w") as f:
        for i in range(n):
            f.write(json.dumps({"a": i, "b": f"row{i}", "c": i * 0.5}) + "\n")
    return p


def _json_limit(m, tmp_path):
    p = _big_json(tmp_path, 200_000)
    m.IO_STATS.reset()
    got = m.pkg.read_json(p).limit(10).to_pydict()
    snap = _io(m)
    assert snap["bytes_read"] < os.path.getsize(p) / 4, snap  # the head alone
    return got, snap


def _json_projection(m, tmp_path):
    return m.pkg.read_json(_big_json(tmp_path, 5000)).select(m.col("a")).to_pydict()


def _json_filter_limit(m, tmp_path):
    p = _big_json(tmp_path, 50_000)
    return (m.pkg.read_json(p).where(m.col("a") % 1000 == 0)
            .select(m.col("a"), m.col("c")).limit(7).to_pydict())


def _json_empty(m, tmp_path):
    p = str(tmp_path / "empty.json")
    open(p, "w").close()
    with pytest.raises(Exception) as e:
        m.pkg.read_json(p).to_pydict()  # inference has nothing to read
    return type(e.value).__name__


def _json_late_field(m, tmp_path):
    p = str(tmp_path / "late.json")
    if not os.path.exists(p):
        with open(p, "w") as f:
            for i in range(60_000):
                row = {"a": i, "b": "x" * 30}
                if i > 50_000:
                    row["d"] = i  # first appears about 1.7 MB in
                f.write(json.dumps(row) + "\n")
    got = m.pkg.read_json(p).to_pydict()
    return sorted(got), got["a"][:3], got["a"][-1], got["d"][0], got["d"][-1]


JSON_CASES = {"limit_early_stop": _json_limit, "projection": _json_projection,
              "filter_plus_limit": _json_filter_limit, "empty_file": _json_empty,
              "late_field": _json_late_field}


@pytest.mark.parametrize("case", list(JSON_CASES))
def test_json_streaming_case(tmp_path, case):
    fn = JSON_CASES[case]
    assert fn(PORT, tmp_path) == fn(REF, tmp_path)


# ---------------------------------------------------------------------------
# merged scan tasks
# ---------------------------------------------------------------------------

def _write_parts(tmp_path, n=6, rows=50):
    for i in range(n):
        papq.write_table(pa.table({
            "k": pa.array([i] * rows, pa.int64()),
            "v": pa.array([float(j) for j in range(rows)]),
        }), str(tmp_path / f"part{i}.parquet"))


def _merged_one_task(m, tmp_path):
    df = m.pkg.read_parquet(str(tmp_path))
    src = df._plan
    while not isinstance(src, m.ScanSource):
        src = src.children()[0]
    return len(src.tasks), len(src.tasks[0].children), df.sort(m.col("k")).to_pydict()["k"]


def _merged_pushdowns_limit(m, tmp_path):
    got = m.pkg.read_parquet(str(tmp_path)).where(m.col("k") == 3).select(m.col("v")).to_pydict()
    m.IO_STATS.reset()
    got2 = m.pkg.read_parquet(str(tmp_path)).limit(10).to_pydict()
    return got, len(got2["k"]), _io(m)["files_opened"]


def _merged_stats_prune(m, tmp_path):
    m.IO_STATS.reset()
    got = m.pkg.read_parquet(str(tmp_path)).where(m.col("k") == 0).to_pydict()
    return got, _io(m)


def _merged_cache_invalidation(m, tmp_path):
    _write_parts(tmp_path, n=3)
    q = m.pkg.read_parquet(str(tmp_path)).agg(m.col("k").sum().alias("s"))
    s1 = q.to_pydict()["s"][0]
    # overwrite a child that is not the first: a stale cache would give s1
    papq.write_table(pa.table({"k": pa.array([100] * 50, pa.int64()),
                               "v": pa.array([0.0] * 50)}), str(tmp_path / "part2.parquet"))
    s2 = m.pkg.read_parquet(str(tmp_path)).agg(m.col("k").sum().alias("s")).to_pydict()["s"][0]
    assert s2 == s1 - 2 * 50 + 100 * 50
    return s1, s2


MERGED_CASES = {"one_task": _merged_one_task, "pushdowns_and_limit": _merged_pushdowns_limit,
                "stats_prune_children": _merged_stats_prune,
                "cache_invalidation_covers_all_children": _merged_cache_invalidation}


@pytest.mark.parametrize("case", list(MERGED_CASES))
def test_merged_scan_task_case(tmp_path, case):
    fn = MERGED_CASES[case]
    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    _write_parts(tmp_path / "r")
    _write_parts(tmp_path / "p")
    assert fn(PORT, tmp_path / "p") == fn(REF, tmp_path / "r")


def test_merge_respects_max_window():
    def run(m):
        sch = m.Schema.from_arrow(pa.schema([("a", pa.int64())]))
        tasks = [m.ScanTask(f"f{i}", m.FileFormat.PARQUET, sch, m.Pushdowns(),
                            num_rows=10, size_bytes=40) for i in range(10)]
        out = m.scan.merge_scan_tasks_by_size(tasks, min_bytes=100, max_bytes=130)
        big = m.ScanTask("big", m.FileFormat.PARQUET, sch, m.Pushdowns(),
                         num_rows=10, size_bytes=500)
        out2 = m.scan.merge_scan_tasks_by_size(tasks[:2] + [big] + tasks[2:4],
                                               min_bytes=100, max_bytes=130)
        return ([len(getattr(t, "children", [t])) for t in out],
                sum(t.num_rows() for t in out),
                [len(getattr(t, "children", [t])) for t in out2],
                [t.size_bytes() for t in out2])

    got = run(PORT)
    assert got == run(REF)
    assert got[0] == [3, 3, 3, 1] and got[2] == [2, 1, 2]


def test_cache_distinguishes_reader_options(tmp_path):
    p = str(tmp_path / "c.csv")
    with open(p, "w") as f:
        f.write("x;y\n5;6\n")

    def run(m):
        return (m.pkg.read_csv(p, delimiter=";").to_pydict(),
                m.pkg.read_csv(p, delimiter=",").to_pydict())

    got = run(PORT)
    assert got == run(REF)
    assert set(got[0]) == {"x", "y"} and set(got[1]) == {"x;y"}


def test_arrow_ipc_reader_pushdowns(tmp_path):
    path = str(tmp_path / "t.arrow")
    tbl = pa.table({"a": list(range(20)), "b": [f"s{i}" for i in range(20)],
                    "c": [float(i) for i in range(20)]})
    with pa.OSFile(path, "wb") as f, pa.ipc.new_file(f, tbl.schema) as w:
        w.write_table(tbl)

    def run(m):
        schema = m.Schema.from_arrow(tbl.schema)
        rd = m.readers.read_arrow_ipc_table
        m.IO_STATS.reset()
        return (rd(path, m.Pushdowns(), schema=schema).to_pydict(),
                rd(path, m.Pushdowns(columns=["c", "a"]), schema=schema).column_names,
                rd(path, m.Pushdowns(filters=(m.col("a") >= 15)._node), schema=schema).to_pydict(),
                len(rd(path, m.Pushdowns(limit=3), schema=schema)), _io(m))

    got = run(PORT)
    assert got == run(REF)
    assert got[2]["a"] == [15, 16, 17, 18, 19]


def test_from_glob_path(tmp_path):
    _write_parts(tmp_path, n=2)

    def run(m):
        return m.pkg.from_glob_path(str(tmp_path / "*.parquet")).to_pydict()

    assert run(PORT) == run(REF)


# ---------------------------------------------------------------------------
# retries: a transient error retries under the policy, a permanent one raises
# ---------------------------------------------------------------------------

def _task(m, p):
    sch = m.Schema.from_arrow(papq.ParquetFile(p).schema_arrow)
    return m.ScanTask(p, m.FileFormat.PARQUET, sch, m.Pushdowns(columns=["a"]))


@pytest.mark.parametrize("chunked", [False, True], ids=["read", "iter_chunks"])
def test_transient_read_retries_then_completes(pq_file, chunked):
    def run(m):
        m.IO_STATS.reset()
        m.faults.arm("scan.read", "first_n", n=2)
        t = _task(m, pq_file)
        rows = (sum(len(c) for c in t.iter_chunks()) if chunked else len(t.read()))
        m.faults.disarm()
        return rows, _io(m)["retries"]

    got = run(PORT)
    assert got == run(REF) == (1000, 2)


def test_retries_exhausted_raise_the_readers_error(pq_file):
    def run(m):
        m.IO_STATS.reset()
        m.faults.arm("scan.read", "always")
        with pytest.raises(OSError) as e:
            _task(m, pq_file).read()
        m.faults.disarm()
        return type(e.value).__name__, _io(m)["retries"]

    got = run(PORT)
    assert got == run(REF)
    assert got == ("InjectedFault", 3)  # scan_retry_attempts


def test_permanent_error_raises_at_once(tmp_path, pq_file):
    def run(m):
        t = _task(m, pq_file)
        gone = m.ScanTask(str(tmp_path / "gone.parquet"), t.format, t.schema, t.pushdowns)
        m.IO_STATS.reset()
        with pytest.raises(FileNotFoundError):
            gone.read()
        return _io(m)["retries"]

    assert run(PORT) == run(REF) == 0
