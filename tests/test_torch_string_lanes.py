"""The port's transform and joint-dictionary string lanes held against
daft_tpu in its 32-bit device mode, on the CPU
(daft_tpu_torch/kernels/device.py ``string_transform_env``,
``transform_cmp_env``, ``string_joint_env``).

- Each case runs one query over the same pyarrow table, made from a numpy
  seed, through daft_tpu under tests/device_mode.real_tpu_mode_cfg and
  through the port under that configuration with device="cpu". Rows,
  strings and order are equal; float sums agree at the reference test's
  rtol 1e-5; every routing counter is the reference's.
- The cases are those of tests/device32/test_real_tpu_mode.py: the transform
  cases of TestStringDictPred32, TestDeviceStringColCol32,
  TestStringChoiceCompare32 and
  TestDeviceDistinct32::test_two_string_key_groupby_codes_on_device.
- K2 runs an aggregate grouped by a transformed string (its ids feed the
  group codes) and declines a program that reads a transform's values or
  a joint remap, exactly where the reference's deep kernel does.
- Hypothesis properties mirror tests/test_property_device_strings.py, with
  both packages run on each example.
"""

import dataclasses

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu_torch.kernels import fused_expr_sums as fes
from device_mode import real_tpu_mode_cfg

ROUTES = ("device_filters", "host_filters", "device_projections", "host_projections",
          "device_fused_maps", "host_fused_maps", "device_aggregations", "host_aggregations",
          "device_agg_fallbacks", "device_sorts", "host_sorts", "device_group_codes",
          "device_distincts", "host_distincts")
OPS = ("==", "!=", "<", "<=", ">", ">=")


@pytest.fixture(autouse=True)
def _restore_port_config():
    ctx = daft_tpu_torch.get_context()
    saved = ctx.execution_config
    yield
    ctx.execution_config = saved


def _strings(rng, pool, n, every=None):
    """Strings drawn from ``pool``; every ``every``-th one null."""
    return pa.array(np.array(pool)[rng.randint(0, len(pool), n)].tolist(), pa.large_string(),
                    mask=None if every is None else np.arange(n) % every == 0)


def _table(n=3000, seed=7):
    """m: a mode column with padded and mixed-case values; a, b: two columns
    whose dictionaries overlap in part; v: floats; i: small ints."""
    rng = np.random.RandomState(seed)
    return pa.table({
        "m": _strings(rng, ["  Mail ", "ship", "AIR", "rail", "TRUCK-X", "MAIL"], n, 89),
        "a": _strings(rng, ["MAIL", "SHIP", "AIR", "RAIL", "TRUCK", " ship"], n, 83),
        "b": _strings(rng, ["MAIL", "SHIP", "BARGE", "RAIL", "DRONE"], n, 101),
        "v": rng.rand(n) * 100,
        "i": rng.randint(0, 3, n).astype(np.int64),
        # null-free keys, whose several-key group codes pack on the card
        "rf": _strings(rng, ["A", "N", "R"], n),
        "ls": _strings(rng, ["F", "O"], n),
        "mk": _strings(rng, ["  Foo ", "foo", "BAR", "bar "], n),
    })


def _run_both(build, table, deep=False, min_rows=8):
    """``build(pkg, frame)`` through both packages; returns (reference frame,
    port frame, reference deep traces, port K2 builds)."""
    from daft_tpu.kernels import pallas_ops

    with real_tpu_mode_cfg(device_min_rows=min_rows) as cfg:
        saved = cfg.use_pallas_deep_fusion
        cfg.use_pallas_deep_fusion = deep
        traces = pallas_ops.DEEP_FUSED_TRACES[0]
        try:
            ref = build(daft_tpu, daft_tpu.from_arrow(table)).collect()
        finally:
            cfg.use_pallas_deep_fusion = saved
        traces = pallas_ops.DEEP_FUSED_TRACES[0] - traces
        d = dataclasses.asdict(cfg)
    d["jax_enable_x64"] = False
    d["use_pallas_deep_fusion"] = deep
    daft_tpu_torch.set_execution_config(
        daft_tpu_torch.execution_config_from_dict(d, device="cpu"))
    builds = fes.BUILDS
    got = build(daft_tpu_torch, daft_tpu_torch.from_arrow(table)).collect()
    return ref, got, traces, fes.BUILDS - builds


def _routes(df):
    c = df.stats.snapshot()["counters"]
    return {k: c.get(k, 0) for k in ROUTES}


def _cmp(l, r, op):
    return {"==": l == r, "!=": l != r, "<": l < r, "<=": l <= r, ">": l > r, ">=": l >= r}[op]


def _cases(pkg):
    c, lit = pkg.col, pkg.lit
    strip_upper = c("m").str.lstrip().str.rstrip().str.upper()
    cases = {
        # TestStringDictPred32: transforms as values, keys and compare sides
        "groupby_transformed_key": lambda f: f.groupby(strip_upper.alias("k")).agg(
            c("v").sum().alias("s"), c("v").count().alias("c")).sort("k"),
        "groupby_fill_null_key": lambda f: f.groupby(c("m").fill_null("<none>").alias("k")).agg(
            c("v").count().alias("c")).sort("k"),
        "distinct_transformed": lambda f: f.select(
            c("m").str.lower().alias("k"), c("v")).distinct("k").sort("k"),
        "cross_upper_eq_column": lambda f: f.where(c("a").str.lstrip().str.upper() == c("b")),
        "cross_transform_lt_transform": lambda f: f.where(
            c("a").str.upper() < c("b").str.lstrip()),
        "cross_ne_projection": lambda f: f.select(
            (c("a").str.upper() != c("b")).alias("d"), c("v")),
        "cross_fused_agg": lambda f: f.where(c("a").str.lstrip().str.upper() >= c("b")).agg(
            c("v").count().alias("c")),
        "transformed_projection": lambda f: f.select(
            strip_upper.alias("u"), c("m").fill_null("?").str.lower().alias("l")),
        "sort_by_transformed": lambda f: f.select(c("m")).sort(c("m").str.lower(), desc=True),
        "minmax_of_transformed": lambda f: f.groupby(c("m").is_null().alias("g")).agg(
            c("m").str.upper().min().alias("lo"), c("m").str.upper().max().alias("hi")).sort("g"),
        "int_transform_projection_and_sort": lambda f: f.select(
            c("m").str.length().alias("n"), c("m")).sort([c("m").str.length(), c("m")]),
        "int_transform_group_key": lambda f: f.groupby(c("m").str.length().alias("n")).agg(
            c("v").count().alias("c")).sort("n"),
        "int_transform_sum": lambda f: f.groupby(c("m").is_null().alias("g")).agg(
            c("m").str.length().sum().alias("tot"), c("v").count().alias("c")).sort("g"),
        "left_of_concat_projection": lambda f: f.select((c("m") + "!").str.left(3).alias("x")),
        # TestDeviceStringColCol32
        "colcol_projection": lambda f: f.select((c("a") == c("b")).alias("eq"),
                                                (c("a") < c("b")).alias("lt")),
        "colcol_self": lambda f: f.select((c("a") == c("a")).alias("eq")),
        "fill_null_literal": lambda f: f.select(c("a").fill_null("MISSING").alias("f")),
        "fill_null_column": lambda f: f.select(c("a").fill_null(c("b")).alias("f")),
        "if_else_columns": lambda f: f.select((c("v") > 50).if_else(c("a"), c("b")).alias("p")),
        "if_else_literal_branch": lambda f: f.select(
            (c("v") > 50).if_else(c("a"), "OTHER").alias("p"),
            (c("a") == c("b")).if_else("SAME", c("b")).alias("tag")),
        "if_else_null_branch": lambda f: f.select(
            (c("v") > 50).if_else(c("a"), None).alias("p")),
        "sort_by_fill_null": lambda f: f.select(
            c("a").fill_null(c("b")).alias("k"), c("v")).sort(["k", "v"]),
        # TestStringChoiceCompare32
        "choice_fill_null_vs_column": lambda f: f.where(c("a").fill_null(c("b")) == c("b")),
        "choice_if_else_vs_literal": lambda f: f.select(
            ((c("v") > 50).if_else(c("a"), c("b")) >= "MAIL").alias("m")),
        "choice_vs_choice": lambda f: f.select(
            (c("a").fill_null("zz") < c("b").fill_null("aa")).alias("c")),
        "choice_predicate_in_agg": lambda f: f.where(c("a").fill_null(c("b")) >= c("b"))
        .groupby("b").agg(c("i").sum().alias("s")).sort("b"),
        "choice_minmax": lambda f: f.groupby("b").agg(
            c("a").fill_null("zzz").min().alias("lo"),
            c("a").fill_null("zzz").max().alias("hi")).sort("b"),
        # TestDeviceDistinct32::test_two_string_key_groupby_codes_on_device
        "two_string_keys_groupby": lambda f: f.groupby("rf", "ls").agg(
            c("v").sum().alias("s"), c("v").count().alias("c")).sort(["rf", "ls"]),
        # multi-key packing of a transform lane with an int lane (null-free)
        "transformed_plus_int_keys": lambda f: f.groupby(
            c("mk").str.lstrip().str.rstrip().str.lower().alias("k"), c("i")).agg(
            c("v").count().alias("c")).sort(["k", "i"]),
    }
    for op in OPS:
        cases[f"colcol_filter_{op}"] = (lambda op: lambda f: f.where(_cmp(c("a"), c("b"), op)))(op)
        cases[f"choice_vs_column_{op}"] = (lambda op: lambda f: f.select(
            _cmp(c("a").fill_null(c("b")), c("b"), op).alias("p")))(op)
    return cases


@pytest.mark.parametrize("case", sorted(_cases(daft_tpu)))
def test_string_lane_matches_reference(case):
    ref, got, _t, _b = _run_both(lambda pkg, f: _cases(pkg)[case](f), _table())
    r, g = ref.to_pydict(), got.to_pydict()
    assert list(g) == list(r)
    for name in r:
        if name in ("s",) or (name == "v" and case == "sort_by_fill_null"):
            np.testing.assert_allclose(g[name], r[name], rtol=1e-5)
        else:
            assert g[name] == r[name], name
    assert _routes(got) == _routes(ref)
    routes = _routes(got)
    # each runs on the card (a sort's later select and a distinct's sort
    # may not: then in both packages alike)
    assert not any(routes[k] for k in ("host_filters", "host_aggregations", "host_distincts",
                                       "device_agg_fallbacks"))
    if case.startswith(("groupby", "int_transform_group", "transformed_plus", "two_string")):
        assert routes["device_group_codes"] >= 1


def test_computed_string_keys_stay_host_when_ineligible():
    # concatenation makes new strings, which no dictionary holds
    ref, got, _t, _b = _run_both(
        lambda pkg, f: f.select((pkg.col("a") + pkg.col("b")).alias("c")), _table())
    assert got.to_pydict() == ref.to_pydict()
    assert _routes(got) == _routes(ref)
    assert _routes(got)["device_projections"] == 0


def test_all_null_side_of_a_cross_column_compare():
    # an all-null column has an empty dictionary: its remap is a one-lane
    # stub and every compared row is null
    n = 3000
    table = pa.table({"a": pa.nulls(n, pa.large_string()),
                      "b": pa.array(["x"] * n, pa.large_string()),
                      "v": np.arange(n, dtype=np.int64)})
    ref, got, _t, _b = _run_both(
        lambda pkg, f: f.where(pkg.col("a").str.upper() == pkg.col("b")), table)
    assert got.to_pydict()["v"] == ref.to_pydict()["v"] == []
    assert _routes(got) == _routes(ref)


# ---------------------------------------------------------------------------
# K2 beside the string lanes
# ---------------------------------------------------------------------------

def _deep_cases(pkg):
    c = pkg.col
    return {
        # (query, K2 engages in the reference)
        "transformed_group_key": (lambda f: f.groupby(c("m").str.upper().alias("k")).agg(
            c("v").sum().alias("s")).sort("k"), True),
        "int_transform_value": (lambda f: f.groupby("i").agg(
            (c("m").str.length() * c("v")).sum().alias("s")).sort("i"), False),
        "joint_remap_predicate": (lambda f: f.where(c("a") < c("b")).groupby("i").agg(
            c("v").sum().alias("s")).sort("i"), False),
        "string_choice_predicate": (lambda f: f.where(c("a").fill_null("X") == "X").groupby(
            "i").agg(c("v").sum().alias("s")).sort("i"), False),
    }


@pytest.mark.parametrize("case", sorted(_deep_cases(daft_tpu)))
def test_deep_kernel_beside_string_lanes(case):
    ref, got, traces, builds = _run_both(lambda pkg, f: _deep_cases(pkg)[case][0](f),
                                         _table(), deep=True)
    r, g = ref.to_pydict(), got.to_pydict()
    assert list(g) == list(r)
    np.testing.assert_allclose(g["s"], r["s"], rtol=1e-5)
    assert {k: v for k, v in g.items() if k != "s"} == {k: v for k, v in r.items() if k != "s"}
    assert _routes(got) == _routes(ref)
    assert traces == builds == int(_deep_cases(daft_tpu)[case][1])


# ---------------------------------------------------------------------------
# hypothesis: tests/test_property_device_strings.py, both packages
# ---------------------------------------------------------------------------

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

_POOL = st.sampled_from(["", "a", "aa", "ab", "z", "émé", "ZZ", "mail", "MAIL", "é", "0"])
_ELEM = st.one_of(st.none(), _POOL)
_TRANSFORMS = {
    "upper": lambda e: e.str.upper(),
    "lower": lambda e: e.str.lower(),
    "lstrip": lambda e: e.str.lstrip(),
    "reverse": lambda e: e.str.reverse(),
    "left2": lambda e: e.str.left(2),
    "concat_lit": lambda e: e + "_x",
    "fill_then_upper": lambda e: e.fill_null("zz").str.upper(),
}


@st.composite
def _two_cols(draw):
    n = draw(st.integers(min_value=1, max_value=24))
    return (draw(st.lists(_ELEM, min_size=n, max_size=n)),
            draw(st.lists(_ELEM, min_size=n, max_size=n)))


def _prop_both(case, build, same_routes=True):
    a, b = case
    table = pa.table({"a": pa.array(a, pa.large_string()), "b": pa.array(b, pa.large_string())})
    ref, got, _t, _b = _run_both(build, table, min_rows=1)
    assert got.to_pydict() == ref.to_pydict()
    if same_routes:
        assert _routes(got) == _routes(ref)


@given(_two_cols(), st.sampled_from(sorted(_TRANSFORMS)))
@settings(max_examples=25, deadline=None)
def test_transform_producer_property(case, tname):
    _prop_both(case, lambda pkg, f: f.select(_TRANSFORMS[tname](pkg.col("a")).alias("t")))


@given(_two_cols(), st.sampled_from(sorted(_TRANSFORMS)))
@settings(max_examples=25, deadline=None)
def test_transform_groupby_and_sort_property(case, tname):
    def build(pkg, f):
        key = _TRANSFORMS[tname](pkg.col("a"))
        return (f.groupby(key.alias("k")).agg(pkg.col("b").count().alias("c")).sort("k")
                if len(case[0]) % 2 else f.sort([key, pkg.col("b")]))

    _prop_both(case, build)


@given(_two_cols(), st.sampled_from(OPS), st.sampled_from(sorted(_TRANSFORMS)))
@settings(max_examples=25, deadline=None)
def test_cross_column_transform_compare_property(case, op, tname):
    _prop_both(case, lambda pkg, f: f.select(
        _cmp(_TRANSFORMS[tname](pkg.col("a")), pkg.col("b"), op).alias("p")))


@given(_two_cols(), st.sampled_from(OPS), _POOL)
@settings(max_examples=25, deadline=None)
def test_colcol_and_choice_compare_property(case, op, lit):
    def build(pkg, f):
        c = pkg.col
        if len(case[0]) % 2:
            return f.select(_cmp(c("a"), c("b"), op).alias("p"))
        return f.select(_cmp(c("a").fill_null(c("b")),
                             (c("a") <= c("b")).if_else(c("b"), lit), op).alias("q"))

    # the choice's predicate a <= b is a group of its own, (a, b) with no
    # literal, which the reference's group key does not tell from (a, b)
    # with the literal "": its device program then fails and it projects on
    # the host (see the test below); the port's projects on the card
    _prop_both(case, build, same_routes=len(case[0]) % 2 == 1 or lit != "")


def test_empty_literal_group_is_its_own_joint_group():
    """The groups (a, b) and (a, b) with the literal "" get distinct keys in
    the port, so both build their remaps and literal codes (the reference's
    key merges them, and whichever it builds first wins). Held against the
    port's host path."""
    c = daft_tpu_torch.col
    t = pa.table({"a": pa.array(["", None, "x", "y"] * 300, pa.large_string()),
                  "b": pa.array(["x", "", None, "y"] * 300, pa.large_string())})

    def query():
        return daft_tpu_torch.from_arrow(t).select(
            (c("a") == c("b")).alias("p"),
            (c("a").fill_null(c("b")) < (c("a") <= c("b")).if_else(c("b"), "")).alias("q"))

    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=1)
    dev = query().collect()
    assert dev.stats.snapshot()["counters"].get("device_projections") == 1
    daft_tpu_torch.set_execution_config(use_device_kernels=False)
    assert dev.to_pydict() == query().collect().to_pydict()


@given(_two_cols(), _POOL)
@settings(max_examples=25, deadline=None)
def test_string_choice_property(case, lit):
    def build(pkg, f):
        c = pkg.col
        return f.select(c("a").fill_null(c("b")).alias("f"),
                        (c("a") <= c("b")).if_else(c("a"), lit).alias("pick")).sort(["f", "pick"])

    _prop_both(case, build)
