"""The SQL front end of the port (daft_tpu_torch/sql.py), held against
daft_tpu's on the CPU.

- tests/test_sql.py's cases run through both packages: equal results, equal
  to that file's expected values, and the same errors.
- The 22 TPC-H texts of benchmarks/tpch_queries.SQL plan in the port exactly
  where they plan in the reference: the 8 that plan have the reference's
  schemas, and the other 14 are the same strict xfails, with the reasons
  of tests/test_sql_tpch_parse.py. The breadth floor and the repeated-call
  check (the package's ``sql`` attribute stays the function) carry over.
- The 8 texts that plan run in both packages in the 32-bit device mode at
  ``device_min_rows=8``, the four large tables in 3 partitions: rows under
  tests/device32/test_tpch_suite32.py's rule, and the routing counters of
  tests/torch_parity.COUNTERS equal, and the aggregate routes those of
  ``chip_smoke.SQL_ROUTES_3P``. Q1 and Q6 read SF0.005 (seed 7). The
  other six list their tables with commas, which the front end (the
  reference's) plans as cross joins under the WHERE filter, so they run
  over a few joined rows of SF0.005 (``chip_smoke.sql_toy_catalogs``: the
  rows that satisfy the text and as many that do not). SQL builds its joins
  in the text's FROM order, so the texts are held against the reference's
  SQL, not against the port's DataFrame queries.
"""

import datetime

import pytest

import daft_tpu
import daft_tpu_torch
from benchmarks import tpch_full, tpch_queries
from chip_smoke import SQL_PLANNING, SQL_ROUTES_3P, SQL_SINGLE_TABLE, sql_toy_catalogs
from test_sql_tpch_parse import UNSUPPORTED
from torch_parity import counters, restore_port_config, run_both  # noqa: F401

BIG = ("lineitem", "orders", "customer", "partsupp")


def _base(pkg):
    return pkg.from_pydict({
        "a": [1, 2, 3, 4, 5, None],
        "b": [10.0, 20.0, 30.0, 40.0, 50.0, 60.0],
        "s": ["apple", "banana", "cherry", "date", "apple", None],
        "g": ["x", "y", "x", "y", "x", "y"],
    })


def _join_frames(pkg, right_key="rid"):
    left = pkg.from_pydict({"id": [1, 2, 3], "v": ["a", "b", "c"]})
    right = pkg.from_pydict({right_key: [2, 3, 4], "w": [20, 30, 40]})
    return left, right


def _sql_expr_case(pkg):
    d = pkg.from_pydict({"a": [1, 3], "b": [1.0, None]})
    where = d.where(pkg.sql_expr("a + 1 > 3 AND b IS NOT NULL")).to_pydict()
    return {"where": where, "abs": d.select(pkg.sql_expr("ABS(a - 4)").alias("x")).to_pydict()}


# name -> (case(pkg) -> a column dict, the value tests/test_sql.py expects)
CASES = {
    "select_where": (lambda pkg: pkg.sql("SELECT a, b * 2 AS b2 FROM t WHERE a > 2",
                                         t=_base(pkg)).to_pydict(),
                     {"a": [3, 4, 5], "b2": [60.0, 80.0, 100.0]}),
    "select_star_limit": (lambda pkg: pkg.sql("SELECT * FROM t LIMIT 2", t=_base(pkg)).to_pydict(),
                          {"a": [1, 2], "b": [10.0, 20.0], "s": ["apple", "banana"],
                           "g": ["x", "y"]}),
    "arith_precedence": (lambda pkg: pkg.sql(
        "SELECT 1 + x * 3 AS y, (1 + x) * 3 AS z FROM t",
        t=pkg.from_pydict({"x": [2, 3]})).to_pydict(), {"y": [7, 10], "z": [9, 12]}),
    "groupby_agg_having": (lambda pkg: pkg.sql(
        "SELECT g, SUM(b) AS sb, COUNT(a) AS ca FROM t GROUP BY g HAVING SUM(b) > 80 "
        "ORDER BY g", t=_base(pkg)).to_pydict(),
        {"g": ["x", "y"], "sb": [90.0, 120.0], "ca": [3, 2]}),
    "compound_agg": (lambda pkg: pkg.sql(
        "SELECT g, SUM(b) / COUNT(b) AS avg_b FROM t GROUP BY g ORDER BY g",
        t=_base(pkg)).to_pydict(), {"g": ["x", "y"], "avg_b": [30.0, 40.0]}),
    "count_star": (lambda pkg: pkg.sql("SELECT COUNT(*) FROM t", t=_base(pkg)).to_pydict(),
                   {"count": [6]}),
    "global_agg": (lambda pkg: pkg.sql("SELECT SUM(a) AS s, MAX(b) AS m FROM t",
                                       t=_base(pkg)).to_pydict(), {"s": [15], "m": [60.0]}),
    "case_when": (lambda pkg: pkg.sql(
        "SELECT a, CASE WHEN a >= 4 THEN 'hi' WHEN a >= 2 THEN 'mid' ELSE 'lo' END AS tier "
        "FROM t WHERE a IS NOT NULL", t=_base(pkg)).to_pydict(),
        {"a": [1, 2, 3, 4, 5], "tier": ["lo", "mid", "mid", "hi", "hi"]}),
    "like": (lambda pkg: pkg.sql("SELECT s FROM t WHERE s LIKE 'a%'", t=_base(pkg)).to_pydict(),
             {"s": ["apple", "apple"]}),
    "in_list": (lambda pkg: pkg.sql("SELECT a FROM t WHERE a IN (1, 3, 5)",
                                    t=_base(pkg)).to_pydict(), {"a": [1, 3, 5]}),
    "between": (lambda pkg: pkg.sql("SELECT a FROM t WHERE a BETWEEN 2 AND 4",
                                    t=_base(pkg)).to_pydict(), {"a": [2, 3, 4]}),
    "string_functions": (lambda pkg: pkg.sql(
        "SELECT UPPER(s) AS u, LENGTH(s) AS l FROM t WHERE s = 'date'",
        t=_base(pkg)).to_pydict(), {"u": ["DATE"], "l": [4]}),
    "cast_and_null": (lambda pkg: pkg.sql(
        "SELECT CAST(b AS INT) AS bi, COALESCE(a, 0) AS a0 FROM t LIMIT 6",
        t=_base(pkg)).to_pydict(),
        {"bi": [10, 20, 30, 40, 50, 60], "a0": [1, 2, 3, 4, 5, 0]}),
    "join": (lambda pkg: pkg.sql(
        "SELECT l.id, l.v, r.w FROM l JOIN r ON l.id = r.rid ORDER BY id",
        **dict(zip("lr", _join_frames(pkg)))).to_pydict(),
        {"id": [2, 3], "v": ["b", "c"], "w": [20, 30]}),
    "left_join_using": (lambda pkg: pkg.sql(
        "SELECT id, v, w FROM l LEFT JOIN r USING (id) ORDER BY id",
        **dict(zip("lr", _join_frames(pkg, "id")))).to_pydict(),
        {"id": [1, 2, 3], "v": ["a", "b", "c"], "w": [None, 20, 30]}),
    "subquery": (lambda pkg: pkg.sql(
        "SELECT SUM(x2) AS s FROM (SELECT x * x AS x2 FROM t WHERE x > 1) sq",
        t=pkg.from_pydict({"x": [1, 2, 3, 4]})).to_pydict(), {"s": [29]}),
    "order_by_desc_nulls": (lambda pkg: pkg.sql(
        "SELECT a FROM t ORDER BY a DESC NULLS LAST", t=_base(pkg)).to_pydict(),
        {"a": [5, 4, 3, 2, 1, None]}),
    "distinct": (lambda pkg: pkg.sql("SELECT DISTINCT g FROM t ORDER BY g",
                                     t=_base(pkg)).to_pydict(), {"g": ["x", "y"]}),
    "group_by_position": (lambda pkg: pkg.sql(
        "SELECT g AS grp, SUM(b) AS s FROM t GROUP BY 1 ORDER BY 1", t=_base(pkg)).to_pydict(),
        {"grp": ["x", "y"], "s": [90.0, 120.0]}),
    "group_by_alias": (lambda pkg: pkg.sql(
        "SELECT g AS grp, SUM(b) AS s FROM t GROUP BY grp ORDER BY grp",
        t=_base(pkg)).to_pydict(), {"grp": ["x", "y"], "s": [90.0, 120.0]}),
    "date_literal": (lambda pkg: pkg.sql(
        "SELECT d FROM t WHERE d >= DATE '2024-03-01'",
        t=pkg.from_pydict({"d": [datetime.date(2024, 1, 1), datetime.date(2024, 6, 1)]}))
        .to_pydict(), {"d": [datetime.date(2024, 6, 1)]}),
    "sql_expr": (_sql_expr_case, {"where": {"a": [], "b": []}, "abs": {"x": [3, 1]}}),
    "where_sql_text": (lambda pkg: _base(pkg).where("a > 2 AND s <> 'date'").select("a")
                       .to_pydict(), {"a": [3, 5]}),
    "order_by_dropped_column": (lambda pkg: pkg.sql(
        "SELECT b FROM t WHERE a IS NOT NULL ORDER BY a DESC", t=_base(pkg)).to_pydict(),
        {"b": [50.0, 40.0, 30.0, 20.0, 10.0]}),
    "order_by_computed_alias": (lambda pkg: pkg.sql(
        "SELECT a*a sq FROM t WHERE a IS NOT NULL ORDER BY sq DESC LIMIT 2",
        t=_base(pkg)).to_pydict(), {"sq": [25, 16]}),
    "order_by_agg": (lambda pkg: pkg.sql("SELECT g FROM t GROUP BY g ORDER BY SUM(b) DESC",
                                         t=_base(pkg)).to_pydict(), {"g": ["y", "x"]}),
    "qualified_duplicate_after_join": (lambda pkg: pkg.sql(
        "SELECT l.id, l.v AS lv, r.v AS rv FROM l JOIN r ON l.id = r.id ORDER BY 1",
        l=pkg.from_pydict({"id": [1, 2], "v": ["a", "b"]}),
        r=pkg.from_pydict({"id": [1, 2], "v": ["X", "Y"]})).to_pydict(),
        {"id": [1, 2], "lv": ["a", "b"], "rv": ["X", "Y"]}),
    "distinct_order_by_partitions": (lambda pkg: pkg.sql(
        "SELECT DISTINCT x FROM t ORDER BY x",
        t=pkg.from_pydict({"x": [9, 1, 9, 3, 1, 7, 3, 5] * 10}).repartition(4)).to_pydict(),
        {"x": [1, 3, 5, 7, 9]}),
    "group_by_input_precedence": (lambda pkg: pkg.sql(
        "SELECT -x AS x, SUM(z) AS s FROM t GROUP BY x ORDER BY s",
        t=pkg.from_pydict({"x": [1, 2, 1], "z": [10, 20, 30]})).to_pydict(),
        {"x": [-2, -1], "s": [20, 40]}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sql_case_matches_reference(name):
    case, want = CASES[name]
    daft_tpu_torch.set_execution_config(device="cpu")
    ref, got = case(daft_tpu), case(daft_tpu_torch)
    assert got == ref == want


# (name, query, the catalog of a package, the error's pattern): tests/test_sql.py's errors
ERRORS = {
    "unknown_table": ("SELECT * FROM missing", lambda pkg: {"t": _base(pkg)}, "unknown table"),
    "agg_without_group_by": ("SELECT a, SUM(b) AS s FROM t", lambda pkg: {"t": _base(pkg)},
                             "GROUP BY"),
    "empty_select": ("SELECT FROM t", lambda pkg: {"t": _base(pkg)}, "expected"),
    "unknown_qualified_column": (
        "SELECT r.nope FROM l JOIN r ON l.id = r.id",
        lambda pkg: {"l": pkg.from_pydict({"id": [1]}), "r": pkg.from_pydict({"id": [1]})},
        "not found in table"),
    "chained_comparison": ("SELECT a FROM t WHERE 1 < a < 3", lambda pkg: {"t": _base(pkg)},
                           "chained comparisons"),
    "outer_join_non_equi": (
        "SELECT * FROM l LEFT JOIN r ON l.id = r.rid AND r.w > 40",
        lambda pkg: {"l": pkg.from_pydict({"id": [1, 2], "v": [1, 2]}),
                     "r": pkg.from_pydict({"rid": [1, 2], "w": [5, 50]})},
        "OUTER JOIN"),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_sql_error_matches_reference(name):
    text, catalog, pattern = ERRORS[name]
    daft_tpu_torch.set_execution_config(device="cpu")
    msgs = []
    for pkg in (daft_tpu, daft_tpu_torch):
        with pytest.raises(ValueError, match=pattern) as ei:
            pkg.sql(text, **catalog(pkg))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("qn", (1, 6))
def test_tpch_sql_over_lineitem_matches_reference(qn):
    """tests/test_sql.py's Q1 and Q6 parity texts at SF0.002 (seed 11), in the
    64-bit device mode, the reference's default in this process."""
    from benchmarks import tpch

    text = {1: """
        SELECT l_returnflag, l_linestatus,
               SUM(l_quantity) AS sum_qty,
               SUM(l_extendedprice) AS sum_base_price,
               SUM(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
               SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
               AVG(l_quantity) AS avg_qty,
               AVG(l_extendedprice) AS avg_price,
               AVG(l_discount) AS avg_disc,
               COUNT(l_quantity) AS count_order
        FROM lineitem
        WHERE l_shipdate <= DATE '1998-09-02'
        GROUP BY l_returnflag, l_linestatus
        ORDER BY l_returnflag, l_linestatus""",
            6: """
        SELECT SUM(l_extendedprice * l_discount) AS revenue
        FROM lineitem
        WHERE l_shipdate >= DATE '1994-01-01' AND l_shipdate < DATE '1995-01-01'
          AND l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < 24"""}[qn]
    li = tpch.generate_tables(scale=0.002, seed=11)["lineitem"]
    daft_tpu_torch.set_execution_config(device="cpu", device_x64=True)
    ref = daft_tpu.sql(text, lineitem=daft_tpu.from_arrow(li)).to_pydict()
    got = daft_tpu_torch.sql(text, lineitem=daft_tpu_torch.from_arrow(li)).to_pydict()
    assert list(got) == list(ref)
    for k in ref:
        for a, b in zip(got[k], ref[k]):
            assert a == (pytest.approx(b, rel=1e-9) if isinstance(b, float) else b)


# ---------------------------------------------------------------------------
# the 22 TPC-H texts: tests/test_sql_tpch_parse.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    return tpch_full.generate(scale=0.001, seed=7)


@pytest.mark.parametrize("qn", sorted(tpch_queries.SQL))
def test_tpch_sql_plans_as_the_reference(qn, tiny, request):
    """The port plans a text exactly where the reference plans it, with its
    schema; the 14 texts the reference cannot plan are the same strict
    xfails, with the same reasons."""
    if qn in UNSUPPORTED:
        request.applymarker(pytest.mark.xfail(strict=True, reason=f"q{qn}: {UNSUPPORTED[qn]}"))
    ref = daft_tpu.sql(tpch_queries.SQL[qn], **{k: daft_tpu.from_arrow(v)
                                                for k, v in tiny.items()})
    got = daft_tpu_torch.sql(tpch_queries.SQL[qn], **{k: daft_tpu_torch.from_arrow(v)
                                                      for k, v in tiny.items()})
    assert got.column_names == ref.column_names
    assert [str(f.dtype) for f in got.schema] == [str(f.dtype) for f in ref.schema]


def test_supported_breadth_floor(tiny):
    """The same texts plan in both packages, and at least 8 of them."""
    ok = {}
    for pkg in (daft_tpu, daft_tpu_torch):
        catalog = {k: pkg.from_arrow(v) for k, v in tiny.items()}
        ok[pkg.__name__] = []
        for qn in sorted(tpch_queries.SQL):
            try:
                pkg.sql(tpch_queries.SQL[qn], **catalog)
                ok[pkg.__name__].append(qn)
            except Exception:  # noqa: BLE001
                pass
    assert ok["daft_tpu_torch"] == ok["daft_tpu"] == list(SQL_PLANNING)


def test_repeated_sql_calls_stay_callable():
    """The first real import of the daft_tpu_torch.sql SUBMODULE must not
    rebind the package's ``sql`` attribute (the function) to the module."""
    import importlib

    importlib.import_module("daft_tpu_torch.sql")
    daft_tpu_torch.set_execution_config(device="cpu")
    df = daft_tpu_torch.from_pydict({"a": [1, 2, 3]})
    for _ in range(3):
        out = daft_tpu_torch.sql("SELECT a FROM t WHERE a > 1", t=df)
        assert callable(daft_tpu_torch.sql)
    assert out.collect().to_pydict() == {"a": [2, 3]}


# ---------------------------------------------------------------------------
# the 8 planning texts executed: rows and routing against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sf0005():
    data = tpch_full.generate(scale=0.005, seed=7)
    return data, sql_toy_catalogs(data, tpch_queries.SQL)


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


def assert_suite_rows(got: dict, want: dict) -> None:
    """tests/device32/test_tpch_suite32.py's rule: floats rounded to 2
    decimals, then within max(5e-4 relative, 0.02); everything else equal."""
    assert list(got) == list(want)
    g, w = _rows(got), _rows(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        for x, y in zip(a, b):
            if isinstance(x, float) or isinstance(y, float):
                assert x is not None and y is not None
                assert abs(float(x) - float(y)) <= max(5e-4 * abs(float(y)), 0.02), (a, b)
            else:
                assert x == y, (a, b)


@pytest.mark.parametrize("qn", SQL_PLANNING)
def test_planning_text_runs_as_the_reference(qn, sf0005):
    data, toys = sf0005
    tables = data if qn in SQL_SINGLE_TABLE else toys[qn]

    def build(pkg):
        frames = {}
        for name, tbl in tables.items():
            df = pkg.from_arrow(tbl)
            frames[name] = df.into_partitions(3) if name in BIG else df
        return pkg.sql(tpch_queries.SQL[qn], **frames)

    ref, got = run_both(build, min_rows=8)
    assert_suite_rows(got.to_pydict(), ref.to_pydict())
    assert counters(got) == counters(ref)
    c = got.stats.snapshot()["counters"]
    assert c.get("device_agg_fallbacks", 0) == 0
    # chip_smoke.py's phase 15 holds the card to the same routes
    assert (c.get("device_aggregations", 0), c.get("host_aggregations", 0)) == SQL_ROUTES_3P[qn]
