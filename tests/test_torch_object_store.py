"""The object-store client of daft_tpu_torch (io/object_store.py) and the
``url`` functions (multimodal.py), held against daft_tpu on the CPU.

Each case runs one input through both packages against the reference's own
mock servers (tests/test_object_store.py's ``MockS3Handler``,
tests/test_cloud_sources.py's GCS, Azure and Hugging Face handlers), each
listening on 127.0.0.1 at a free port and shut down after this module, and
compares what came back: bytes, paths and rows, the ``IO_STATS`` counters
(bytes read and written, retries), the mock's record of the requests
(ranges, multipart steps, auth headers), the connection budget's high water
and the error raised. The mock state is reset before each package's run.

Every case of tests/test_object_store.py and tests/test_cloud_sources.py
has a counterpart here; none is left out. Added: the SigV4 headers byte for
byte at a fixed clock (GET, PUT with ``If-None-Match``, a multipart part,
a session token) and Azure's shared-key headers likewise; the connection
budget under the pool and the readahead; the ``io.get`` fault site; remote
scans never cached; and objects one package writes read back by the other.
"""

import io
import threading
import time
from importlib import import_module

import pyarrow as pa
import pyarrow.parquet as papq
import pytest

import daft_tpu
import daft_tpu_torch
from test_cloud_sources import MockAzureHandler, MockGCSHandler, MockHFHandler
from test_object_store import MockS3Handler
from torch_parity import (counters, fresh_ledgers_and_faults, restore_port_config,  # noqa: F401
                          under_both)

PKGS = (daft_tpu, daft_tpu_torch)
BASE = {"enable_result_cache": False}
RETRY = dict(attempts=4, backoff_s=0.01)


def _mod(pkg, name: str):
    return import_module(f"{pkg.__name__}.{name}")


def _osm(pkg):
    return _mod(pkg, "io.object_store")


def _io_stats(pkg):
    return _mod(pkg, "io.scan").IO_STATS


def _parquet_bytes(tbl: pa.Table, **kw) -> bytes:
    buf = io.BytesIO()
    papq.write_table(tbl, buf, **kw)
    return buf.getvalue()


def _serve(handler_cls):
    from http.server import ThreadingHTTPServer

    server = ThreadingHTTPServer(("127.0.0.1", 0), handler_cls)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_port}"


@pytest.fixture(scope="module")
def servers():
    made = {name: _serve(h) for name, h in (("s3", MockS3Handler), ("gcs", MockGCSHandler),
                                            ("azure", MockAzureHandler), ("hf", MockHFHandler))}
    yield {name: ep for name, (_srv, ep) in made.items()}
    for srv, _ep in made.values():
        srv.shutdown()
        srv.server_close()


@pytest.fixture(autouse=True)
def fresh_state(servers, monkeypatch):
    # every store points at its mock: no case may reach a real endpoint
    monkeypatch.setenv("AWS_ENDPOINT_URL", servers["s3"])
    monkeypatch.setenv("GCS_ENDPOINT_URL", servers["gcs"])
    monkeypatch.setenv("AZURE_ENDPOINT_URL", servers["azure"])
    monkeypatch.setenv("AZURE_STORAGE_ACCOUNT", "acct")
    monkeypatch.setenv("AZURE_STORAGE_KEY", "c2VjcmV0")
    monkeypatch.setenv("HF_ENDPOINT", servers["hf"])
    for var in ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY", "AWS_SESSION_TOKEN",
                "AWS_REGION", "GCS_TOKEN", "GOOGLE_OAUTH_TOKEN", "AZURE_STORAGE_SAS_TOKEN",
                "HF_TOKEN"):
        monkeypatch.delenv(var, raising=False)
    fresh_ledgers_and_faults()
    _reset_mocks()
    yield
    fresh_ledgers_and_faults()
    _reset_mocks()


def _reset_mocks() -> None:
    S = MockS3Handler
    for d in (S.store, S.fail_counts, S.uploads):
        d.clear()
    S.range_requests.clear()
    S.multipart_events.clear()
    S.redirects = {}
    S.put_count = S.inflight = S.max_inflight = 0
    MockGCSHandler.store.clear()
    MockGCSHandler.auth_seen.clear()
    MockAzureHandler.store.clear()
    MockAzureHandler.saw_versions.clear()
    MockHFHandler.files.clear()
    MockHFHandler.tokens_seen.clear()


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # the error is part of what is compared
        return ("raised", type(e).__name__, str(e))


def on_both(op, seed=lambda: None):
    """``op(pkg)`` for each package from the same seeded mock state; returns
    [(outcome, IO_STATS snapshot), ...] for the reference, then the port."""
    out = []
    for pkg in PKGS:
        _reset_mocks()
        seed()
        st = _io_stats(pkg)
        st.reset()
        out.append((_outcome(lambda: op(pkg)), st.snapshot()))
    return out


def s3_client(pkg, endpoint, **kw):
    m = _osm(pkg)
    return m.IOClient(s3_config=m.S3Config(endpoint_url=endpoint, anonymous=True),
                      retry=m.RetryPolicy(**RETRY), **kw)


# ---------------------------------------------------------------------------
# tests/test_object_store.py: TestClient and TestGlobSemantics
# ---------------------------------------------------------------------------

def _seed_objects():
    S = MockS3Handler.store
    S[("b", "x.bin")] = b"hello world"
    S[("b", "r.bin")] = bytes(range(100))
    S[("b", "flaky.bin")] = b"ok"
    MockS3Handler.fail_counts[("b", "flaky.bin")] = 2  # two 500s, then fine
    S[("b", "dead.bin")] = b"ok"
    MockS3Handler.fail_counts[("b", "dead.bin")] = 99
    for i in range(5):
        S[("b", f"data/part-{i}.parquet")] = b"x"
    S[("b", "data/readme.txt")] = b"x"
    S[("b", "data/archive/old.parquet")] = b"x"
    S[("b", "d/file.parquet")] = b"x"
    S[("b", "d/file.parquet.bak")] = b"y"


CLIENT_CASES = {
    # TestClient
    "get": (lambda c: c.get("s3://b/x.bin"), b"hello world"),
    "get_size": (lambda c: c.get_size("s3://b/x.bin"), 11),
    "range_read": (lambda c: c.get("s3://b/r.bin", (10, 20)), bytes(range(10, 20))),
    "retry_survives_injected_500s": (lambda c: c.get("s3://b/flaky.bin"), b"ok"),
    "glob_with_pagination": (lambda c: [m.path for m in c.glob("s3://b/data/part-*.parquet")],
                             [f"s3://b/data/part-{i}.parquet" for i in range(5)]),
    # page size 2 forces 4 list round trips
    "ls_with_pagination": (lambda c: len(c.ls("s3://b/data/")), 7),
    # TestGlobSemantics
    "star_does_not_cross_slash": (lambda c: [m.path for m in c.glob("s3://b/data/*.parquet")],
                                  [f"s3://b/data/part-{i}.parquet" for i in range(5)]),
    "double_star_crosses_slash": (
        lambda c: "s3://b/data/archive/old.parquet" in [
            m.path for m in c.glob("s3://b/data/**/*.parquet")], True),
    "exact_key_not_prefix": (lambda c: [m.path for m in c.glob("s3://b/d/file.parquet")],
                             ["s3://b/d/file.parquet"]),
}


@pytest.mark.parametrize("case", sorted(CLIENT_CASES))
def test_client(servers, case):
    op, want = CLIENT_CASES[case]
    ref, got = on_both(lambda pkg: op(s3_client(pkg, servers["s3"])), _seed_objects)
    assert got == ref
    assert got[0] == ("ok", want)


def test_retries_exhausted_raises(servers):
    ref, got = on_both(lambda pkg: s3_client(pkg, servers["s3"]).get("s3://b/dead.bin"),
                       _seed_objects)
    assert got == ref
    (kind, name, _msg), st = got
    assert (kind, name, st["retries"]) == ("raised", "TransientIOError", 4)


def test_retry_counts_retries(servers):
    ref, got = on_both(lambda pkg: s3_client(pkg, servers["s3"]).get("s3://b/flaky.bin"),
                       _seed_objects)
    assert got == ref and got[1]["retries"] == 2 and got[1]["bytes_read"] == 2


def _budget_peak(pkg, endpoint, calls: int = 8, budget: int = 2):
    """The most gets inside one client's semaphore section at once, over
    ``calls`` threads, and the mock's own in-flight high water."""
    client = s3_client(pkg, endpoint, max_connections=budget)
    src = client.source_for("s3://b/c.bin")
    orig, lk, state = src.get, threading.Lock(), {"cur": 0, "peak": 0}

    def counted(*a, **k):
        with lk:
            state["cur"] += 1
            state["peak"] = max(state["peak"], state["cur"])
        try:
            time.sleep(0.005)  # hold the connection, so that threads overlap
            return orig(*a, **k)
        finally:
            with lk:
                state["cur"] -= 1

    src.get = counted
    threads = [threading.Thread(target=lambda: client.get("s3://b/c.bin")) for _ in range(calls)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    return state["peak"], MockS3Handler.max_inflight


def test_connection_budget(servers):
    seed = lambda: MockS3Handler.store.__setitem__(("b", "c.bin"), b"z" * 1000)  # noqa: E731
    ref, got = on_both(lambda pkg: _budget_peak(pkg, servers["s3"]), seed)
    for (kind, (peak, server_high)), st in (ref, got):
        assert kind == "ok" and 1 <= peak <= 2  # the budget held, non-vacuously
        # +1 for the server's window outliving the client's hold (as the
        # reference's test allows)
        assert server_high <= 3
        assert st["bytes_read"] == 8000
    assert got[1] == ref[1]


def test_connection_budget_under_the_pool(servers, monkeypatch):
    """A scan of 8 objects on the pool (8 workers) with the readahead (depth
    2), through a client budgeted to 2 connections: the budget holds, with
    the reference's rows and IO counters."""
    tables = [pa.table({"v": list(range(i * 100, i * 100 + 100))}) for i in range(8)]

    def fn(pkg):
        _reset_mocks()
        for i, t in enumerate(tables):
            MockS3Handler.store[("bkt", f"pool/p{i}.parquet")] = _parquet_bytes(t)
        budget = s3_client(pkg, servers["s3"], max_connections=2)
        monkeypatch.setattr(_osm(pkg), "default_io_client", lambda: budget)
        src = budget.source_for("s3://bkt/pool")
        orig, lk, state = src.get, threading.Lock(), {"cur": 0, "peak": 0, "calls": 0}

        def counted(*a, **k):
            with lk:
                state["cur"] += 1
                state["calls"] += 1
                state["peak"] = max(state["peak"], state["cur"])
            try:
                return orig(*a, **k)
            finally:
                with lk:
                    state["cur"] -= 1

        monkeypatch.setattr(src, "get", counted)
        _io_stats(pkg).reset()
        out = pkg.read_parquet("s3://bkt/pool/*.parquet").sort("v").to_pydict()
        return out, state["peak"], state["calls"] > 8, _io_stats(pkg).snapshot()

    ref, got = under_both(fn, {**BASE, "executor_threads": 8, "scan_prefetch_depth": 2,
                                "scan_tasks_min_size_bytes": 1})
    assert got[0] == ref[0] == {"v": list(range(800))}
    assert 1 <= got[1] <= 2 and 1 <= ref[1] <= 2
    assert got[2] and ref[2]
    assert got[3] == ref[3]


# ---------------------------------------------------------------------------
# tests/test_object_store.py: TestRemoteParquet
# ---------------------------------------------------------------------------

def test_range_reads_not_full_download(servers):
    tbl = pa.table({"a": list(range(50_000)), "b": [float(i) for i in range(50_000)],
                    "c": ["x" * 20] * 50_000})
    raw = _parquet_bytes(tbl, row_group_size=10_000)

    def op(pkg):
        f = s3_client(pkg, servers["s3"]).open("s3://b/t.parquet")
        out = papq.ParquetFile(f).read_row_groups([0], columns=["a"])
        assert out.column("a").to_pylist() == list(range(10_000))
        return list(MockS3Handler.range_requests)

    ref, got = on_both(op, lambda: MockS3Handler.store.__setitem__(("b", "t.parquet"), raw))
    assert got == ref
    fetched = sum(hi - lo for (_k, lo, hi) in got[0][1])
    assert fetched < len(raw) // 2, "should not download the whole object"
    assert got[1]["bytes_read"] == fetched


def _seed_engine():
    for i in range(3):
        t = pa.table({"v": [i * 10 + j for j in range(4)]})
        MockS3Handler.store[("bkt", f"ds/part-{i}.parquet")] = _parquet_bytes(t)
    MockS3Handler.store[("bkt", "flaky/d.parquet")] = _parquet_bytes(pa.table({"v": [1, 2, 3]}))
    MockS3Handler.fail_counts[("bkt", "flaky/d.parquet")] = 1
    MockS3Handler.store[("bkt", "f.csv")] = b"a,b\n1,x\n2,y\n"


ENGINE_READS = {
    "engine_scan_s3_glob": (lambda pkg: pkg.read_parquet("s3://bkt/ds/part-*.parquet").sort("v"),
                            {"v": sorted(i * 10 + j for i in range(3) for j in range(4))}),
    "engine_scan_survives_500s": (lambda pkg: pkg.read_parquet("s3://bkt/flaky/d.parquet"),
                                  {"v": [1, 2, 3]}),
    "csv_over_s3": (lambda pkg: pkg.read_csv("s3://bkt/f.csv"), {"a": [1, 2], "b": ["x", "y"]}),
}


@pytest.mark.parametrize("case", sorted(ENGINE_READS))
def test_engine_read(case):
    build, want = ENGINE_READS[case]

    def fn(pkg):
        _reset_mocks()
        _seed_engine()
        _io_stats(pkg).reset()
        df = build(pkg).collect()
        return df.to_pydict(), counters(df), _io_stats(pkg).snapshot()

    ref, got = under_both(fn, BASE)
    assert got == ref
    assert got[0] == want
    assert got[2]["retries"] == (1 if case == "engine_scan_survives_500s" else 0)


def test_io_get_fault_counts_as_a_retry():
    """An armed ``io.get`` fires inside the client's retry loop: the read
    retries, counts one retry, and returns the same rows."""
    def fn(pkg):
        _reset_mocks()
        _seed_engine()
        faults = _mod(pkg, "faults")
        _io_stats(pkg).reset()
        faults.arm("io.get", "first_n", n=1)
        try:
            out = pkg.read_parquet("s3://bkt/ds/part-*.parquet").sort("v").to_pydict()
            injected = faults.snapshot()["injected"].get("io.get", 0)
        finally:
            faults.disarm()
        return out, injected, _io_stats(pkg).snapshot()["retries"]

    ref, got = under_both(fn, BASE)
    assert got == ref
    assert got[1:] == (1, 1)
    assert "io.get" in daft_tpu_torch.faults.SITES


def test_remote_scans_are_never_cached():
    def fn(pkg):
        _seed_engine()
        runners = _mod(pkg, "runners")
        df = pkg.read_parquet("s3://bkt/ds/part-*.parquet")
        return runners.plan_cache_key(df._plan)

    ref, got = under_both(fn, BASE)
    assert got is None and ref is None


# ---------------------------------------------------------------------------
# tests/test_object_store.py: TestUrlDownload, TestUrlUpload, TestRedirects;
# tests/test_cloud_sources.py: TestHuggingFace.test_url_download_hf
# ---------------------------------------------------------------------------

def _seed_urls():
    MockS3Handler.store[("bkt", "obj1")] = b"one"
    MockS3Handler.store[("bkt", "obj2")] = b"two"
    MockS3Handler.fail_counts[("bkt", "obj1")] = 1
    MockS3Handler.store[("web", "page")] = b"<html>"
    MockHFHandler.files["datasets/u/r"] = {"img/x.jpg": b"JPG"}


@pytest.mark.parametrize("case", ["s3_with_retry", "http", "hf"])
def test_url_download(servers, case):
    urls, kw, want = {
        "s3_with_retry": (["s3://bkt/obj1", "s3://bkt/obj2", None], {"on_error": "null"},
                          [b"one", b"two", None]),
        "http": ([f"{servers['s3']}/web/page"], {}, [b"<html>"]),
        "hf": (["hf://datasets/u/r/img/x.jpg"], {}, [b"JPG"]),
    }[case]

    def fn(pkg):
        _reset_mocks()
        _seed_urls()
        _io_stats(pkg).reset()
        df = pkg.from_pydict({"url": urls}).select(
            pkg.col("url").url.download(**kw).alias("data")).collect()
        return df.to_pydict(), _io_stats(pkg).snapshot()

    ref, got = under_both(fn, BASE)
    assert got == ref
    assert got[0]["data"] == want


def test_url_download_on_error_raise(servers):
    def fn(pkg):
        _reset_mocks()
        return _outcome(lambda: pkg.from_pydict({"url": ["s3://bkt/missing"]}).select(
            pkg.col("url").url.download().alias("d")).to_pydict())

    ref, got = under_both(fn, BASE)
    assert got == ref and got[:2] == ("raised", "NotFoundIOError")


def test_upload_remote_and_download_back():
    def fn(pkg):
        _reset_mocks()
        col = pkg.col
        out = pkg.from_pydict({"data": [b"one", b"two", None]}).select(
            col("data").url.upload("s3://bkt/up").alias("p")).to_pydict()
        back = pkg.from_pydict({"u": out["p"][:2]}).select(
            col("u").url.download().alias("d")).to_pydict()
        return [p is None for p in out["p"]], all(
            p.startswith("s3://bkt/up/") for p in out["p"][:2]), back

    ref, got = under_both(fn, BASE)
    assert got == ref == ([False, False, True], True, {"d": [b"one", b"two"]})


def test_upload_respects_connection_budget(servers, monkeypatch):
    def op(pkg):
        m = _osm(pkg)
        budget = m.IOClient(s3_config=m.S3Config(endpoint_url=servers["s3"], anonymous=True),
                            max_connections=2)
        monkeypatch.setattr(m, "default_io_client", lambda: budget)
        src = budget.source_for("s3://bkt/budget")
        orig, lk, state = src.put, threading.Lock(), {"cur": 0, "peak": 0, "calls": 0}

        def counted_put(*a, **k):
            with lk:
                state["cur"] += 1
                state["calls"] += 1
                state["peak"] = max(state["peak"], state["cur"])
            try:
                time.sleep(0.005)
                return orig(*a, **k)
            finally:
                with lk:
                    state["cur"] -= 1

        monkeypatch.setattr(src, "put", counted_put)
        s = _mod(pkg, "series").Series.from_pylist([b"x" * 100] * 12, "data")
        out = _mod(pkg, "multimodal").url_upload(s, "s3://bkt/budget", max_connections=8)
        return all(p is not None for p in out.to_pylist()), state["calls"], state["peak"]

    (ref_out, ref_st), (got_out, got_st) = on_both(op)
    assert got_st == ref_st and got_st["bytes_written"] == 1200
    for kind, (all_written, calls, peak) in (ref_out, got_out):
        # every row went through the client, and the budget held
        assert kind == "ok" and all_written and calls == 12 and 1 <= peak <= 2


def test_upload_local_is_concurrent_capable(tmp_path):
    def op(pkg):
        s = _mod(pkg, "series").Series.from_pylist([b"a", b"b"], "data")
        root = tmp_path / pkg.__name__
        out = _mod(pkg, "multimodal").url_upload(s, str(root), max_connections=4).to_pylist()
        got = []
        for p in out:
            assert p.startswith(str(root))
            with open(p, "rb") as f:
                got.append(f.read())
        return got

    ref, got = on_both(op)
    assert got == ref and got[0] == ("ok", [b"a", b"b"])


def test_http_follows_redirect(servers):
    def seed():
        MockS3Handler.store[("web", "real")] = b"payload"
        MockS3Handler.redirects = {("web", "hop"): f"{servers['s3']}/web/real"}

    ref, got = on_both(lambda pkg: s3_client(pkg, servers["s3"]).get(
        f"{servers['s3']}/web/hop"), seed)
    assert got == ref and got[0] == ("ok", b"payload")


# ---------------------------------------------------------------------------
# tests/test_object_store.py: TestPut
# ---------------------------------------------------------------------------

def test_put_and_get(servers):
    def op(pkg):
        c = s3_client(pkg, servers["s3"])
        c.put("s3://b/w/obj.bin", b"payload")
        return MockS3Handler.store[("b", "w/obj.bin")], c.get("s3://b/w/obj.bin")

    ref, got = on_both(op)
    assert got == ref and got[0] == ("ok", (b"payload", b"payload"))
    assert got[1]["bytes_written"] == 7 and got[1]["bytes_read"] == 7


def test_put_if_absent(servers):
    def op(pkg):
        c = s3_client(pkg, servers["s3"])
        c.put("s3://b/commit/0.json", b"v0", if_none_match=True)
        second = _outcome(lambda: c.put("s3://b/commit/0.json", b"v0-again",
                                        if_none_match=True))
        return second, MockS3Handler.store[("b", "commit/0.json")]

    ref, got = on_both(op)
    assert got == ref
    (kind, ((second_kind, err, _msg), stored)), _st = got
    assert (second_kind, err, stored) == ("raised", "FileExistsError", b"v0")


def test_multipart_upload(servers):
    def op(pkg):
        c = s3_client(pkg, servers["s3"])
        src = c.source_for("s3://b/big.bin")
        src.multipart_threshold = 100
        src.part_size = 64
        data = bytes(range(256)) * 2  # 512 B -> 8 parts of 64
        c.put("s3://b/big.bin", data)
        return MockS3Handler.store[("b", "big.bin")] == data, list(MockS3Handler.multipart_events)

    ref, got = on_both(op)
    assert got == ref
    (_ok, (same, events)), _st = got
    kinds = [e[0] for e in events]
    assert same and kinds[0] == "create" and kinds[-1] == "complete"
    assert kinds.count("part") == 8


def test_delete(servers):
    def op(pkg):
        c = s3_client(pkg, servers["s3"])
        c.put("s3://b/gone.bin", b"x")
        c.delete("s3://b/gone.bin")
        return ("b", "gone.bin") in MockS3Handler.store, c.exists("s3://b/gone.bin")

    ref, got = on_both(op)
    assert got == ref and got[0] == ("ok", (False, False))


# ---------------------------------------------------------------------------
# tests/test_object_store.py: TestRemoteWrites, with each package reading
# what the other wrote
# ---------------------------------------------------------------------------

def _other(pkg):
    return daft_tpu if pkg is daft_tpu_torch else daft_tpu_torch


def test_write_parquet_roundtrip():
    def fn(pkg):
        _reset_mocks()
        manifest = pkg.from_pydict({"a": [1, 2, 3], "b": ["x", "y", "z"]}).write_parquet(
            "s3://bkt/out").to_pydict()
        back = pkg.read_parquet("s3://bkt/out/*.parquet").sort("a").to_pydict()
        across = _other(pkg).read_parquet("s3://bkt/out/*.parquet").sort("a").to_pydict()
        return all(p.startswith("s3://bkt/out/") for p in manifest["path"]), back, across

    ref, got = under_both(fn, BASE)
    want = {"a": [1, 2, 3], "b": ["x", "y", "z"]}
    assert got == ref == (True, want, want)


def test_write_csv_remote():
    def fn(pkg):
        _reset_mocks()
        pkg.from_pydict({"a": [1, 2]}).write_csv("s3://bkt/csvout")
        return pkg.read_csv("s3://bkt/csvout/*.csv").to_pydict()

    ref, got = under_both(fn, BASE)
    assert got == ref == {"a": [1, 2]}


@pytest.mark.parametrize("fmt", ["deltalake", "iceberg"])
def test_write_lake_roundtrip(fmt):
    """tests/test_object_store.py's test_write_deltalake_roundtrip and
    test_write_iceberg_roundtrip: append, overwrite, and the commit files
    put-if-absent; the other package reads each step back."""
    uri = f"s3://bkt/{fmt}_tbl"

    def fn(pkg):
        _reset_mocks()
        write = lambda df, **kw: getattr(df, f"write_{fmt}")(uri, **kw)  # noqa: E731
        read = lambda p: getattr(p, f"read_{fmt}")(uri)  # noqa: E731
        write(pkg.from_pydict({"v": [1, 2]}))
        write(pkg.from_pydict({"v": [3]}), mode="append")
        steps = [read(pkg).sort("v").to_pydict(), read(_other(pkg)).sort("v").to_pydict()]
        write(pkg.from_pydict({"v": [9]}), mode="overwrite")
        steps += [read(pkg).to_pydict(), read(_other(pkg)).to_pydict()]
        if fmt == "deltalake":
            keys = sorted(k for (_b, k) in MockS3Handler.store
                          if k.startswith(f"{fmt}_tbl/_delta_log/"))[:3]
        else:
            keys = sorted(k.rsplit("/", 1)[1] for (_b, k) in MockS3Handler.store
                          if k.startswith(f"{fmt}_tbl/metadata/")
                          and k.endswith(".metadata.json"))
        return steps, keys

    ref, got = under_both(fn, BASE)
    assert got == ref
    assert got[0] == [{"v": [1, 2, 3]}] * 2 + [{"v": [9]}] * 2
    if fmt == "deltalake":
        assert got[1] == [f"deltalake_tbl/_delta_log/{i:020d}.json" for i in range(3)]
    else:
        assert got[1] == ["v1.metadata.json", "v2.metadata.json", "v3.metadata.json"]


# ---------------------------------------------------------------------------
# the signatures, byte for byte at a fixed clock
# ---------------------------------------------------------------------------

FIXED = time.struct_time((2024, 5, 17, 12, 34, 56, 4, 138, 0))


@pytest.mark.parametrize("case", ["get", "get_range_query", "put_if_none_match",
                                  "multipart_part", "session_token", "quoted_key"])
def test_sigv4_headers_byte_for_byte(monkeypatch, case):
    monkeypatch.setattr(time, "gmtime", lambda *a: FIXED)
    url = "http://127.0.0.1:9/bkt/some/key.parquet"
    kw = {}
    if case == "get_range_query":
        url = "http://127.0.0.1:9/bkt?list-type=2&prefix=some%2F&continuation-token=4"
    elif case == "put_if_none_match":
        kw = dict(payload_hash="ab" * 32, extra={"If-None-Match": "*"})
    elif case == "multipart_part":
        url = "http://127.0.0.1:9/bkt/big.bin?partNumber=3&uploadId=up-0"
        kw = dict(payload_hash="cd" * 32)
    elif case == "quoted_key":
        url = "http://127.0.0.1:9/bkt/a%20b%2Bc%3D.parquet"
    method = {"put_if_none_match": "PUT", "multipart_part": "PUT"}.get(case, "GET")
    headers = []
    for pkg in PKGS:
        m = _osm(pkg)
        cfg = m.S3Config(endpoint_url="http://127.0.0.1:9", region="eu-west-1",
                         key_id="AKIDEXAMPLE", secret_key="wJalrXUtnFEMI/K7MDENG",
                         session_token="tok/123" if case == "session_token" else None)
        headers.append(m._sigv4_headers(cfg, method, url, **kw))
    assert headers[1] == headers[0]
    assert headers[1]["x-amz-date"] == "20240517T123456Z"
    assert headers[1]["Authorization"].startswith(
        "AWS4-HMAC-SHA256 Credential=AKIDEXAMPLE/20240517/eu-west-1/s3/aws4_request")


@pytest.mark.parametrize("method,query,extra,length", [
    ("GET", "", {"x-ms-range": "bytes=0-9"}, 0),
    ("PUT", "", {"x-ms-blob-type": "BlockBlob", "If-None-Match": "*"}, 11),
    ("GET", "restype=container&comp=list&prefix=d%2F&marker=2", {}, 0),
])
def test_azure_shared_key_byte_for_byte(monkeypatch, method, query, extra, length):
    monkeypatch.setattr(time, "gmtime", lambda *a: FIXED)
    headers = []
    for pkg in PKGS:
        m = _osm(pkg)
        src = m.AzureSource(m.AzureConfig(account="acct", key="c2VjcmV0",
                                          endpoint_url="http://127.0.0.1:9"))
        url = src._url("cont", "" if query else "dir/x.bin", query)
        headers.append(src._headers(method, url, content_length=length, extra=extra))
    assert headers[1] == headers[0]
    assert headers[1]["Authorization"].startswith("SharedKey acct:")


# ---------------------------------------------------------------------------
# tests/test_cloud_sources.py: TestGCS, TestAzure, TestHuggingFace
# ---------------------------------------------------------------------------

def test_gcs_get_put_roundtrip(servers):
    def op(pkg):
        m = _osm(pkg)
        src = m.GCSSource(m.GCSConfig(endpoint_url=servers["gcs"], token="tok"))
        src.put("gs://bkt/a/b.bin", b"payload")
        return (src.get("gs://bkt/a/b.bin"), src.get("gs://bkt/a/b.bin", range=(1, 4)),
                src.get_size("gs://bkt/a/b.bin"), list(MockGCSHandler.auth_seen))

    ref, got = on_both(op)
    assert got == ref
    data, part, size, auth = got[0][1]
    assert (data, part, size) == (b"payload", b"ayl", 7) and "Bearer tok" in auth


def test_gcs_put_if_absent_uses_generation_match(servers):
    def op(pkg):
        m = _osm(pkg)
        src = m.GCSSource(m.GCSConfig(endpoint_url=servers["gcs"]))
        src.put("gs://bkt/commit/0.json", b"v0", if_none_match=True)
        again = _outcome(lambda: src.put("gs://bkt/commit/0.json", b"again",
                                         if_none_match=True))
        return again[:2], MockGCSHandler.store[("bkt", "commit/0.json")]

    ref, got = on_both(op)
    assert got == ref and got[0] == ("ok", (("raised", "FileExistsError"), b"v0"))


def test_azure_get_put_roundtrip(servers):
    def op(pkg):
        m = _osm(pkg)
        src = m.AzureSource(m.AzureConfig(account="acct", key="c2VjcmV0",
                                          endpoint_url=servers["azure"]))
        src.put("az://cont/dir/x.bin", b"hello azure")
        return (src.get("az://cont/dir/x.bin"), src.get("az://cont/dir/x.bin", range=(0, 5)),
                src.get_size("az://cont/dir/x.bin"), "2021-08-06" in MockAzureHandler.saw_versions)

    ref, got = on_both(op)
    assert got == ref and got[0] == ("ok", (b"hello azure", b"hello", 11, True))


def test_azure_put_if_absent(servers):
    def op(pkg):
        m = _osm(pkg)
        src = m.AzureSource(m.AzureConfig(account="acct", key="c2VjcmV0",
                                          endpoint_url=servers["azure"]))
        src.put("az://cont/c.json", b"v0", if_none_match=True)
        return _outcome(lambda: src.put("az://cont/c.json", b"again", if_none_match=True))[:2]

    ref, got = on_both(op)
    assert got == ref and got[0] == ("ok", ("raised", "FileExistsError"))


def test_azure_ls_paginates_and_glob(servers):
    def seed():
        for i in range(5):
            MockAzureHandler.store[("cont", f"d/p{i}.parquet")] = b"x"
        MockAzureHandler.store[("cont", "d/readme.txt")] = b"x"

    def op(pkg):
        m = _osm(pkg)
        src = m.AzureSource(m.AzureConfig(account="acct", key="c2VjcmV0",
                                          endpoint_url=servers["azure"]))
        return len(src.ls("az://cont/d/")), [m.path for m in src.glob("az://cont/d/p*.parquet")]

    ref, got = on_both(op, seed)
    assert got == ref
    assert got[0] == ("ok", (6, [f"az://cont/d/p{i}.parquet" for i in range(5)]))


def test_hf_get_ls_glob(servers):
    def seed():
        MockHFHandler.files["datasets/u/r"] = {
            "data/a.parquet": b"A", "data/b.parquet": b"B", "README.md": b"#"}

    def op(pkg):
        m = _osm(pkg)
        src = m.HuggingFaceSource(m.HFConfig(endpoint_url=servers["hf"], token="hftok"))
        return (src.get("hf://datasets/u/r/data/a.parquet"),
                src.get_size("hf://datasets/u/r/README.md"),
                sorted(x.path for x in src.ls("hf://datasets/u/r/")),
                sorted(x.path for x in src.glob("hf://datasets/u/r/data/*.parquet")),
                "Bearer hftok" in MockHFHandler.tokens_seen)

    ref, got = on_both(op, seed)
    assert got == ref
    assert got[0] == ("ok", (b"A", 1, ["hf://datasets/u/r/README.md",
                                       "hf://datasets/u/r/data/a.parquet",
                                       "hf://datasets/u/r/data/b.parquet"],
                             ["hf://datasets/u/r/data/a.parquet",
                              "hf://datasets/u/r/data/b.parquet"], True))


def _seed_cloud_tables():
    for i in range(2):
        t = pa.table({"v": [i * 10 + j for j in range(3)]})
        MockGCSHandler.store[("bkt", f"ds/p{i}.parquet")] = _parquet_bytes(t)
    MockAzureHandler.store[("cont", "tbl/f.parquet")] = _parquet_bytes(pa.table({"v": [5, 6]}))
    MockHFHandler.files["datasets/u/r"] = {
        "data/part0.parquet": _parquet_bytes(pa.table({"v": [7, 8, 9]}))}


@pytest.mark.parametrize("path,want", [
    ("gs://bkt/ds/p*.parquet", [0, 1, 2, 10, 11, 12]),
    ("az://cont/tbl/*.parquet", [5, 6]),
    ("abfs://cont/tbl/f.parquet", [5, 6]),  # abfs:// routes to the same source
    ("hf://datasets/u/r/data/*.parquet", [7, 8, 9]),
])
def test_engine_read_parquet_cloud(path, want):
    def fn(pkg):
        _reset_mocks()
        _seed_cloud_tables()
        _io_stats(pkg).reset()
        df = pkg.read_parquet(path).sort("v").collect()
        return df.to_pydict(), counters(df), _io_stats(pkg).snapshot()

    ref, got = under_both(fn, BASE)
    assert got == ref
    assert got[0] == {"v": want}


# ---------------------------------------------------------------------------
# no remote path raises for being remote
# ---------------------------------------------------------------------------

def test_no_local_only_guard_is_left():
    assert not hasattr(daft_tpu_torch.io.object_store, "check_local_path")
    for path in ("s3://b/k", "gs://b/k", "az://c/k", "abfs://c/k", "abfss://c/k", "hf://u/r/k",
                 "http://127.0.0.1/k", "https://127.0.0.1/k"):
        assert daft_tpu_torch.io.object_store.is_remote_path(path)
        assert daft_tpu.io.object_store.is_remote_path(path)
