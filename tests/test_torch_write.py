"""The write path and the DataFrame's output surface of daft_tpu_torch, held
against daft_tpu on the CPU in the reference's 32-bit device mode.

Ported from tests/test_io_scan.py (``test_writer_roundtrip``,
``test_writer_hive_partitioned``) and tests/test_dataframe.py
(``test_iter_rows_and_partitions``, ``test_write_parquet_roundtrip``,
``test_write_csv_roundtrip``, ``test_show_and_repr``), over one partition
and several, from memory and from parquet. File names hold a random uuid,
so the cases compare the manifests' row counts and keys and the contents
read back, never the names. Rows compare exactly, float sums of a device
aggregate at rtol 1e-5 (tests/test_torch_scan_queries.py's tolerance in the
32-bit mode).
"""

import os

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as papq
import pytest

import daft_tpu_torch
from torch_parity import (assert_same_rows, fresh_ledgers_and_faults, restore_port_config,
                          rows, under_both)  # noqa: F401

BASE = {"enable_result_cache": False}
FORMATS = ("parquet", "csv", "json")


@pytest.fixture(autouse=True)
def fresh_state():
    fresh_ledgers_and_faults()
    yield
    fresh_ledgers_and_faults()


def both(fn, knobs=None):
    return under_both(fn, {**BASE, **(knobs or {})})


def _sub(pkg, name: str):
    from importlib import import_module

    return import_module(f"{pkg.__name__}.{name}")


def read_back(pkg, fmt: str, paths):
    return getattr(pkg, f"read_{fmt}")(list(paths))


@pytest.fixture(params=["arrow", "parquet"])
def make_df(request, tmp_path):
    """tests/conftest.py's make_df for either package: in memory or over a
    parquet file, repartitioned."""
    source = request.param

    def make(pkg, data: dict, repartition: int = 1):
        if source == "arrow":
            df = pkg.from_pydict(data)
        else:
            p = str(tmp_path / f"{pkg.__name__}.parquet")
            papq.write_table(pa.table(data), p)
            df = pkg.read_parquet(p)
        return df.repartition(repartition) if repartition != 1 else df

    return make


# ---------------------------------------------------------------------------
# tests/test_io_scan.py: the writer over a Table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
def test_writer_roundtrip(tmp_path, fmt):
    # strings that a CSV reader cannot take for numbers
    data = {"a": list(range(10)), "b": [f"s{i}" for i in range(10)]}

    def run(pkg):
        table, io = _sub(pkg, "table").Table, _sub(pkg, "io.readers")
        man = _sub(pkg, "io.writer").write_tabular(
            table.from_pydict(data), str(tmp_path / pkg.__name__), fmt)
        paths = man.to_pydict()["path"]
        back = table.concat([getattr(io, f"read_{fmt}_table")(p) for p in paths])
        return len(paths), back.to_pydict()

    ref, got = both(run)
    assert got == ref == (1, data)


def test_writer_splits_at_the_target_file_size(tmp_path):
    data = {"a": list(range(100)), "b": [f"s{i}" for i in range(100)]}

    def run(pkg):
        table = _sub(pkg, "table").Table
        man = _sub(pkg, "io.writer").write_tabular(
            table.from_pydict(data), str(tmp_path / pkg.__name__), "parquet",
            target_file_size=500)
        paths = man.to_pydict()["path"]
        return len(paths), pkg.read_parquet(paths).sort("a").to_pydict()

    ref, got = both(run)
    assert got == ref
    assert got[0] > 1 and got[1] == data


@pytest.mark.parametrize("fmt", FORMATS)
def test_writer_hive_partitioned(tmp_path, fmt):
    data = {"k": ["a", "b", "a", None], "v": [1, 2, 3, 4]}

    def run(pkg):
        table, io = _sub(pkg, "table").Table, _sub(pkg, "io.readers")
        man = _sub(pkg, "io.writer").write_tabular(
            table.from_pydict(data), str(tmp_path / pkg.__name__), fmt,
            partition_cols=[pkg.col("k")])
        d = man.to_pydict()
        assert any("k=a" in p for p in d["path"])
        assert any("k=__HIVE_DEFAULT_PARTITION__" in p for p in d["path"])
        # each key's file holds its rows without the key column
        files = {k: getattr(io, f"read_{fmt}_table")(p).to_pydict()
                 for k, p in zip(d["k"], d["path"])}
        return d["k"], files

    ref, got = both(run)
    assert got == ref
    assert got[0] == ["a", "b", None]
    assert got[1] == {"a": {"v": [1, 3]}, "b": {"v": [2]}, None: {"v": [4]}}


def test_partition_by_value_groups_rows_as_the_reference():
    data = {"k": ["b", None, "a", "b", None], "j": [1, 1, 2, 1, 1], "v": [0, 1, 2, 3, 4]}

    def run(pkg):
        mp = _sub(pkg, "micropartition").MicroPartition.from_pydict(data)
        parts, uniq = mp.partition_by_value([pkg.col("k"), pkg.col("j")])
        return [p.to_pydict() for p in parts], uniq.to_pydict()

    ref, got = both(run)
    assert got == ref
    assert got[1] == {"k": ["b", None, "a"], "j": [1, 1, 2]}
    assert [p["v"] for p in got[0]] == [[0, 3], [1, 4], [2]]


# ---------------------------------------------------------------------------
# tests/test_dataframe.py: the output surface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_partitions", [1, 4])
def test_iter_rows_and_partitions(make_df, num_partitions):
    def run(pkg):
        df = make_df(pkg, {"a": [1, 2, 3]}, repartition=num_partitions)
        it_rows = sorted(r["a"] for r in df.iter_rows())
        parts = [len(p) for p in df.iter_partitions()]
        batches = pa.Table.from_batches(list(df.to_arrow_iter())).to_pydict()
        return it_rows, len(parts), sum(parts), df.num_partitions(), sorted(batches["a"])

    ref, got = both(run)
    assert got == ref
    assert got[0] == [1, 2, 3] and got[2] == 3 and got[3] == num_partitions


@pytest.mark.parametrize("num_partitions", [1, 4])
def test_write_parquet_roundtrip(tmp_path, make_df, num_partitions):
    def run(pkg):
        df = make_df(pkg, {"a": list(range(10)), "b": [str(i) for i in range(10)]},
                     repartition=num_partitions)
        manifest = df.write_parquet(str(tmp_path / pkg.__name__ / "out"))
        paths = manifest.to_pydict()["path"]
        back = pkg.read_parquet(paths).to_pydict()
        return len(paths), sorted(back["a"]), rows(back)

    ref, got = both(run)
    assert got == ref
    assert got[0] >= 1 and got[1] == list(range(10))


@pytest.mark.parametrize("fmt", ["csv", "json"])
@pytest.mark.parametrize("num_partitions", [1, 4])
def test_write_csv_roundtrip(tmp_path, fmt, num_partitions):
    def run(pkg):
        df = pkg.from_pydict({"a": [1, 2, 3, 4], "b": ["x", "y", "z", "w"]})
        if num_partitions > 1:
            df = df.into_partitions(num_partitions)
        manifest = getattr(df, f"write_{fmt}")(str(tmp_path / pkg.__name__ / "out"))
        paths = manifest.to_pydict()["path"]
        return len(paths), read_back(pkg, fmt, paths).sort("a").to_pydict()

    ref, got = both(run)
    assert got == ref == (num_partitions, {"a": [1, 2, 3, 4], "b": ["x", "y", "z", "w"]})


def test_show_and_repr(capsys):
    def run(pkg):
        df = pkg.from_pydict({"a": [1, 2, 3], "s": ["x", None, "z"]})
        lazy = repr(df.where(pkg.col("a") > 1))
        df.show(2)
        shown = capsys.readouterr().out
        return lazy, shown, repr(df.collect())

    (rlazy, rshown, rrepr), (lazy, shown, got_repr) = both(run)
    assert "a" in shown and "int64" in shown
    assert shown == rshown and got_repr == rrepr
    # a repr never runs a plan: a frame not yet collected shows its schema
    assert lazy.startswith("DataFrame(") and rlazy.startswith("DataFrame(")
    assert "None" in got_repr and "| 3 " in got_repr


def test_repr_previews_num_preview_rows():
    def run(pkg):
        return repr(pkg.from_pydict({"a": list(range(20))}).collect())

    ref, got = both(run, {"num_preview_rows": 3})
    assert got == ref
    assert "| 2 " in got and "| 3 " not in got


# ---------------------------------------------------------------------------
# writes over the device path, hive keys, the caches
# ---------------------------------------------------------------------------

def _agg_frame(pkg, n: int = 4000, parts: int = 4):
    rng = np.random.RandomState(5)
    df = pkg.from_pydict({"k": rng.randint(0, 12, n).astype(np.int64), "v": rng.rand(n)})
    return df.into_partitions(parts).groupby("k").agg(
        pkg.col("v").sum().alias("s"), pkg.col("v").count().alias("n")).sort("k")


def test_write_of_a_device_aggregate_reads_back(tmp_path):
    from daft_tpu_torch.kernels import segment_sums

    entries = segment_sums.ENTRIES

    def run(pkg):
        manifest = _agg_frame(pkg).write_parquet(str(tmp_path / pkg.__name__))
        c = manifest.stats.snapshot()["counters"]
        back = pkg.read_parquet(manifest.to_pydict()["path"]).sort("k").to_pydict()
        return back, c.get("device_aggregations", 0), manifest.num_partitions()

    (rback, rdev, rparts), (back, dev, parts) = both(run)
    assert dev == rdev > 0 and parts == rparts
    assert segment_sums.ENTRIES > entries  # the sums went through K1's wrapper
    assert_same_rows(back, rback, rtol=1e-5, ordered=True)
    # and they are the port's in-memory result
    assert_same_rows(back, _agg_frame(daft_tpu_torch).to_pydict(), rtol=0.0, ordered=True)


@pytest.mark.parametrize("fmt", FORMATS)
def test_write_partition_cols_with_a_null_key(tmp_path, fmt):
    data = {"g": ["x", None, "y", "x", None, "y"] * 50, "v": list(range(300)),
            "w": [float(i) / 7 for i in range(300)]}

    def run(pkg):
        df = pkg.from_pydict(data).into_partitions(3)
        manifest = getattr(df, f"write_{fmt}")(str(tmp_path / pkg.__name__),
                                              partition_cols=["g"])
        m = manifest.to_pydict()
        assert list(m) == ["path", "g"]
        dirs = sorted({os.path.basename(os.path.dirname(p)) for p in m["path"]})
        per_key = {}
        for key, p in zip(m["g"], m["path"]):
            per_key.setdefault(key, []).append(p)
        back = {k: rows(read_back(pkg, fmt, ps).to_pydict()) for k, ps in per_key.items()}
        return len(m["path"]), dirs, back

    ref, got = both(run)
    assert got == ref
    assert got[1] == ["g=__HIVE_DEFAULT_PARTITION__", "g=x", "g=y"]
    for key, want in (("x", 0), (None, 1), ("y", 2)):
        assert sorted(r[0] for r in got[2][key]) == [v for v in range(300) if v % 3 == want]


def test_a_repeated_write_writes_again(tmp_path):
    # no cache serves a write: not the whole-plan result cache, not the plan
    # cache, and feedback planning never resizes its exchange, where the
    # same aggregate without the write resizes at once from the history the
    # two writes recorded (and its repeat is a plan-cache hit)
    from torch_parity import clear_adapt

    keys = ("result_cache_hits", "plan_cache_hits", "fdo_shuffle_resizes")

    def run(pkg):
        clear_adapt()
        rng = np.random.RandomState(9)
        df = pkg.from_pydict({"k": rng.randint(0, 100, 8000).astype(np.int64),
                              "v": rng.rand(8000)}).into_partitions(8)

        def agg():
            return df.groupby("k").agg(pkg.col("v").sum().alias("s"))

        writes = []
        for _ in range(2):
            m = agg().write_parquet(str(tmp_path / pkg.__name__))
            c = m.stats.snapshot()["counters"]
            writes.append((len(m.to_pydict()["path"]), {k: c.get(k, 0) for k in keys}))
        files = sum(len(fs) for _, _, fs in os.walk(tmp_path / pkg.__name__))
        plain = [{k: c.get(k, 0) for k in keys}
                 for c in (agg().collect().stats.snapshot()["counters"] for _ in range(2))]
        return writes, files, plain

    ref, got = both(run, {"enable_result_cache": True, "plan_cache": True, "history_fdo": True})
    assert got == ref
    (n1, c1), (n2, c2) = got[0]
    assert n1 == n2 and got[1] == n1 + n2  # the second write wrote its own files
    assert c1 == c2 == {k: 0 for k in keys}
    assert got[2] == [{"result_cache_hits": 0, "plan_cache_hits": 0, "fdo_shuffle_resizes": 1},
                      {"result_cache_hits": 0, "plan_cache_hits": 1, "fdo_shuffle_resizes": 0}]


def test_write_with_no_input_partitions_yields_an_empty_manifest(tmp_path):
    p = str(tmp_path / "t.parquet")
    papq.write_table(pa.table({"a": list(range(100))}), p)

    def run(pkg):
        df = pkg.read_parquet(p).where(pkg.col("a") > 1000)
        m = df.write_parquet(str(tmp_path / pkg.__name__))
        return m.to_pydict(), m.stats.snapshot()["counters"].get("scan_tasks_pruned", 0)

    ref, got = both(run)
    assert got == ref == ({"path": []}, 1)


def test_a_file_url_target_writes_locally(tmp_path):
    def run(pkg):
        m = pkg.from_pydict({"a": [1, 2]}).write_parquet(f"file://{tmp_path}/{pkg.__name__}")
        paths = m.to_pydict()["path"]
        assert all(p.startswith("file://") for p in paths)
        return len(paths), pkg.read_parquet(paths).to_pydict()

    ref, got = both(run)
    assert got == ref == (1, {"a": [1, 2]})


def test_a_remote_target_raises(tmp_path, monkeypatch):
    # a remote target goes to the object-store client since ROADMAP Queue 1
    # item 9 (tests/test_torch_object_store.py writes to a mock store); a
    # store that refuses the connection raises the reference's transient
    # error from both packages, after the same retries
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    endpoint = f"http://127.0.0.1:{s.getsockname()[1]}"
    s.close()
    monkeypatch.setenv("AWS_ENDPOINT_URL", endpoint)
    monkeypatch.setenv("GCS_ENDPOINT_URL", endpoint)

    def run(pkg):
        io_stats = _sub(pkg, "io.scan").IO_STATS
        io_stats.reset()
        seen = []
        df = pkg.from_pydict({"a": [1]})
        for fmt in FORMATS:
            with pytest.raises(_sub(pkg, "io.object_store").TransientIOError) as err:
                getattr(df, f"write_{fmt}")("s3://bucket/out")
            seen.append(str(err.value).split(":", 1)[0])
        with pytest.raises(_sub(pkg, "io.object_store").TransientIOError) as err:
            _sub(pkg, "io.writer").write_tabular(_sub(pkg, "table").Table.from_pydict({"a": [1]}),
                                                 "gs://b/o")
        seen.append(str(err.value).split(":", 1)[0])
        return seen, io_stats.snapshot()["retries"]

    ref, got = both(run)
    assert got == ref
    assert got[1] == 4 * (len(FORMATS) + 1)
    assert all(m.startswith("PUT ") for m in got[0])


# ---------------------------------------------------------------------------
# constructors and conversions
# ---------------------------------------------------------------------------

def test_pylist_and_pandas_round_trips():
    records = [{"a": 1, "b": "x"}, {"a": 2, "c": 1.5}, {"b": None, "a": 3}]
    frame = pd.DataFrame({"i": [1, 2, 3], "f": [0.5, None, 2.5], "s": ["p", "q", None]})

    def run(pkg):
        lst = pkg.from_pylist(records)
        pdf = pkg.from_pandas(frame)
        return (lst.to_pylist(), lst.to_pydict(), lst.schema.field_names(),
                pdf.to_pylist(), pdf.to_pandas(), lst.to_pandas(),
                pkg.from_pandas(pdf.to_pandas()).to_pydict(), pdf.to_table().to_pydict())

    ref, got = both(run)
    assert got[0] == ref[0] == [{"a": 1, "b": "x", "c": None}, {"a": 2, "b": None, "c": 1.5},
                                {"a": 3, "b": None, "c": None}]
    assert got[1:3] == ref[1:3]
    assert got[3] == ref[3]
    pd.testing.assert_frame_equal(got[4], ref[4])
    pd.testing.assert_frame_equal(got[4], frame)
    pd.testing.assert_frame_equal(got[5], ref[5])
    assert got[6] == ref[6] == got[7]
