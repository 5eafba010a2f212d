"""The single-op device hooks (a lone filter, projection or distinct on the
card), hash repartition and the string-literal comparison lane of the
expression compiler, held against daft_tpu in its 32-bit device mode, on the
CPU.

Every case runs one query over the same partitions in both packages:
daft_tpu under tests/device_mode.real_tpu_mode_cfg (x64 off, device kernels
on), the port under execution_config_from_dict(...) of that config with
device="cpu". Rows, their order and the routing counters must be equal;
floats agree at rtol 1e-6 (a projection computes float64 as float32 in both).
"""

import dataclasses
import datetime

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch
from device_mode import real_tpu_mode_cfg
from test_torch_two_stage_agg import _assert_same

MIN_ROWS = 8
ROUTE = ("device_filters", "device_filter_dispatches", "host_filters",
         "device_projections", "device_projection_dispatches", "host_projections",
         "device_distincts", "host_distincts", "shuffles", "fused_chains",
         "device_fused_maps", "host_fused_maps")


@pytest.fixture(autouse=True)
def _restore_port_config():
    ctx = daft_tpu_torch.context.get_context()
    saved = ctx.execution_config
    yield
    ctx.execution_config = saved


def _table(n: int, seed: int, words) -> pa.Table:
    """int64 key with nulls, float64 values with nulls, a date, and a
    string column over ``words`` with nulls (each partition draws from its
    own words, so the partitions' dictionaries differ)."""
    rng = np.random.RandomState(seed)
    k = rng.randint(0, 12, n)
    v = rng.randn(n) * 100
    s = rng.choice(words, n)
    day0 = datetime.date(1995, 1, 1)
    return pa.table({
        "k": pa.array([None if i % 11 == 3 else int(x) for i, x in enumerate(k)], pa.int64()),
        "v": pa.array([None if i % 7 == 2 else float(x) for i, x in enumerate(v)],
                      pa.float64()),
        "d": pa.array([day0 + datetime.timedelta(days=int(x)) for x in rng.randint(0, 400, n)],
                      pa.date32()),
        "s": pa.array([None if i % 9 == 4 else str(x) for i, x in enumerate(s)],
                      pa.large_string()),
    })


WORDS = (["BUILDING", "MACHINERY", "AUTOMOBILE"], ["FURNITURE", "BUILDING", "HOUSEHOLD"],
         ["MACHINERY", "HOUSEHOLD", "AUTOMOBILE", "ZEBRA"])


def _parts(nparts: int, n: int = 400):
    return [_table(n, 3 + i, WORDS[i % len(WORDS)]) for i in range(nparts)]


def _both(parts, query, min_rows=MIN_ROWS):
    """``query(pkg, frame)`` over ``parts`` in both packages; returns
    ((reference dict, counters), (port dict, counters))."""
    out = []
    with real_tpu_mode_cfg(device_min_rows=min_rows) as cfg:
        ref = query(daft_tpu, daft_tpu.from_arrow(parts)).collect()
        out.append((ref.to_pydict(), ref.stats.snapshot()["counters"]))
        d = dataclasses.asdict(cfg)
    d["jax_enable_x64"] = False
    daft_tpu_torch.set_execution_config(
        daft_tpu_torch.execution_config_from_dict(d, device="cpu"))
    got = query(daft_tpu_torch, daft_tpu_torch.from_arrow(parts)).collect()
    out.append((got.to_pydict(), got.stats.snapshot()["counters"]))
    return out


def _route(c):
    return {k: c.get(k, 0) for k in ROUTE}


# ---------------------------------------------------------------------------
# a lone filter, projection and distinct
# ---------------------------------------------------------------------------

SINGLE = {
    "filter_numeric": (lambda pkg, f: f.where(pkg.col("v") > 10.0), "device_filters"),
    "filter_date": (lambda pkg, f: f.where(pkg.col("d") <= datetime.date(1995, 6, 1)),
                    "device_filters"),
    "filter_string": (lambda pkg, f: f.where(pkg.col("s") == "BUILDING"), "device_filters"),
    "projection": (lambda pkg, f: f.select((pkg.col("v") * 2).alias("v2"), pkg.col("k"),
                                           (pkg.col("k") + 1).alias("k1"), pkg.col("s")),
                   "device_projections"),
    "projection_compare": (lambda pkg, f: f.select((pkg.col("s") >= "HOUSEHOLD").alias("ge"),
                                                   (pkg.col("v") < 0).alias("neg")),
                           "device_projections"),
    "distinct_one_key": (lambda pkg, f: f.select("k").distinct(), "device_distincts"),
    "distinct_string": (lambda pkg, f: f.select("s").distinct(), "device_distincts"),
    "distinct_two_keys_nullable": (lambda pkg, f: f.select("k", "s").distinct(),
                                   "host_distincts"),
    "distinct_two_keys": (lambda pkg, f: f.select("d", "s").where(pkg.col("s") >= "")
                          .distinct(), "device_distincts"),
}


@pytest.mark.parametrize("nparts", [1, 3])
@pytest.mark.parametrize("case", sorted(SINGLE))
def test_single_op_matches_reference(case, nparts):
    query, counter = SINGLE[case]
    (ref, rc), (got, gc) = _both(_parts(nparts), query)
    _assert_same(got, ref)
    assert _route(gc) == _route(rc)
    # the distincts: each partition, then the merge after the shuffle
    assert gc.get(counter, 0) >= nparts, gc


def test_filter_below_device_min_rows_takes_the_host():
    (ref, rc), (got, gc) = _both(_parts(1, n=40), SINGLE["filter_numeric"][0], min_rows=64)
    assert got == ref
    assert _route(gc) == _route(rc) and gc.get("host_filters") == 1
    assert "device_filters" not in gc


def test_single_filter_keeps_nulls_out():
    """A predicate that is null on a row drops the row (SQL WHERE), on the
    card as on the host."""
    (ref, rc), (got, gc) = _both(_parts(1), lambda pkg, f: f.where(pkg.col("k") > 5))
    assert got == ref and None not in got["k"]
    assert gc.get("device_filters") == 1


# ---------------------------------------------------------------------------
# the string-literal comparison lane
# ---------------------------------------------------------------------------

def _cmp(op, lit, flipped=False):
    def q(pkg, f):
        s, lv = pkg.col("s"), pkg.lit(lit)
        a, b = (lv, s) if flipped else (s, lv)
        pred = {"==": a == b, "!=": a != b, "<": a < b, "<=": a <= b,
                ">": a > b, ">=": a >= b}[op]
        return f.where(pred)
    return q


STRING_CASES = (
    [(op, "HOUSEHOLD", False) for op in ("==", "!=", "<", "<=", ">", ">=")]
    # the flipped form: the literal on the left
    + [(op, "HOUSEHOLD", True) for op in ("<", ">=")]
    # a literal no partition has, between and past the dictionaries' words
    + [(op, "CAR", False) for op in ("==", "!=", "<", ">")]
    + [("<=", "ZZZ", False), (">", "", False)]
    # present in some partitions' dictionaries only
    + [("==", "FURNITURE", False), ("!=", "ZEBRA", False)]
)


@pytest.mark.parametrize("op,lit,flipped", STRING_CASES,
                         ids=[f"{'flip' if f else ''}{o}{l or 'empty'}"
                              for o, l, f in STRING_CASES])
def test_string_literal_comparison_matches_reference(op, lit, flipped):
    (ref, rc), (got, gc) = _both(_parts(3), _cmp(op, lit, flipped))
    assert got == ref
    assert gc.get("device_filters") == rc.get("device_filters") == 3
    assert "host_filters" not in gc


def test_string_comparison_with_a_null_literal_is_all_null():
    def query(pkg, f):
        s = pkg.col("s")
        null = pkg.lit(None)
        return f.select((s == null).alias("eq"), (null < s).alias("lt"), s)

    (ref, rc), (got, gc) = _both(_parts(3), query)
    assert got == ref
    assert set(got["eq"]) == set(got["lt"]) == {None}
    assert gc.get("device_projections") == rc.get("device_projections") == 3


def test_string_literal_bounds_follow_each_partition_dictionary():
    """One compiled program serves the three partitions; only the 0-d code
    bounds in the env change with each partition's dictionary."""
    from daft_tpu_torch.kernels import device
    from daft_tpu_torch.expressions import normalize_literals
    from daft_tpu_torch.table import Table

    pred = daft_tpu_torch.col("s") == "BUILDING"
    bounds = []
    for t in _parts(3):
        tbl = Table.from_arrow(t)
        node = normalize_literals(pred._node, tbl.schema)
        staged = device.stage_table_columns(tbl, ["s"], device.size_bucket(len(tbl)), {},
                                            "cpu")
        env = device.string_literal_env([node], tbl.schema, staged[1], staged[0])
        keq, klt, kle = device._strlit_keys("s", "BUILDING")
        assert env[keq].dim() == 0 and env[keq].dtype == device.torch.int32
        bounds.append((int(env[keq]), int(env[klt]), int(env[kle])))
    # dictionaries: [AUTOMOBILE, BUILDING, MACHINERY], [BUILDING, FURNITURE,
    # HOUSEHOLD], [AUTOMOBILE, HOUSEHOLD, MACHINERY, ZEBRA]
    assert bounds == [(1, 1, 2), (0, 0, 1), (-1, 1, 1)]


def test_string_literal_key_in_a_join_and_group_key():
    """A string-literal comparison inside an integer join key and a group
    key compiles through the same lane (both stagers merge the bounds)."""
    def query(pkg, f):
        c = pkg.col
        keyed = f.with_column("b", (c("s") == "BUILDING").cast(pkg.DataType.int64()))
        flags = pkg.from_pydict({"b2": [0, 1], "label": ["other", "building"]})
        return (keyed.join(flags, left_on="b", right_on="b2")
                .groupby("label").agg(c("v").sum().alias("sv"), c("k").count().alias("n"))
                .sort("label"))

    (ref, rc), (got, gc) = _both(_parts(1), query)
    _assert_same(got, ref)
    assert gc.get("device_join_probes") == rc.get("device_join_probes") == 1


# ---------------------------------------------------------------------------
# hash repartition, and the failures the hooks must not swallow
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num", [1, 2, 4])
def test_hash_repartition_matches_reference(num):
    def query(pkg, f):
        return f.repartition(num, "k")

    (ref, rc), (got, gc) = _both(_parts(3, n=100), query)
    assert got == ref
    assert gc.get("shuffles") == rc.get("shuffles") == 1


def test_random_repartition_is_not_ported():
    """The random repartition is ported now: without keys, repartition(n)
    draws each row's partition as the reference does (a RandomState seeded
    by the source partition's index), partition for partition. The name
    dates from before its port and is kept, so that test reports stay
    comparable across versions."""
    def query(pkg, f):
        return f.repartition(4)

    (ref, rc), (got, gc) = _both(_parts(3, n=100), query)
    assert got == ref
    assert gc.get("shuffles") == rc.get("shuffles") == 1


HOOKS = ("filter", "projection", "distinct")
BREAKER = ("device_breaker_trips", "degraded_completions", "device_filter_fallbacks",
           "device_projection_fallbacks", "device_distincts", "host_distincts")


def _break_hook(monkeypatch, pkg, hook: str, exc: type, raised=None):
    """Make ``pkg``'s device layer raise ``exc`` at ``hook``: the group-codes
    kernel of a distinct, or the resolver of a launched filter or
    projection; each raise appends to ``raised`` when given. Returns the
    query."""
    import importlib

    device = importlib.import_module(pkg.__name__ + ".kernels.device")
    device_agg = importlib.import_module(pkg.__name__ + ".kernels.device_agg")

    def broken(*a, **kw):
        if raised is not None:
            raised.append(hook)
        raise exc("device failure")

    if hook == "distinct":
        monkeypatch.setattr(device_agg, "_group_codes_kernel", broken)
        return SINGLE["distinct_one_key"][0]
    real = device.eval_projection_device_async

    def launch_then_fail(*a, **kw):
        resolve = real(*a, **kw)
        return None if resolve is None else broken

    monkeypatch.setattr(device, "eval_projection_device_async", launch_then_fail)
    return SINGLE["filter_numeric" if hook == "filter" else "projection"][0]


@pytest.mark.parametrize("hook", HOOKS)
def test_a_failure_on_the_card_reaches_the_caller(monkeypatch, hook):
    """A failure of the port itself (``DaftKernelError``: a kernel that does
    not build, load or launch, or a missing card) is caught by no resolver
    and no device attempt: it reaches collect(), and the breaker counts
    nothing."""
    from daft_tpu_torch.errors import DaftKernelError

    query = _break_hook(monkeypatch, daft_tpu_torch, hook, DaftKernelError)
    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=MIN_ROWS)
    df = query(daft_tpu_torch, daft_tpu_torch.from_arrow(_parts(1)))
    with pytest.raises(DaftKernelError, match="device failure"):
        df.collect()
    assert df.stats.snapshot()["counters"].get("device_breaker_trips", 0) == 0


@pytest.mark.parametrize("hook", HOOKS)
def test_a_device_error_completes_on_the_host(monkeypatch, hook):
    """A failure of the device layer the breaker takes (here an
    out-of-memory error on the card) at the same hooks is a breaker failure,
    as in the reference: each partition completes on the host (the filter's
    and projection's resolvers take back their device count and bump
    ``*_fallbacks``), the third failure trips the breaker, and the rows and
    counters equal the reference's under the same patch. Each failure
    raised shows in ``device_attempt_failures``."""
    import torch

    query = _break_hook(monkeypatch, daft_tpu, hook, torch.cuda.OutOfMemoryError)
    raised = []
    _break_hook(monkeypatch, daft_tpu_torch, hook, torch.cuda.OutOfMemoryError, raised)
    (ref, rc), (got, gc) = _both(_parts(3), query)
    _assert_same(got, ref)
    assert _route(gc) == _route(rc)
    assert {k: gc.get(k, 0) for k in BREAKER} == {k: rc.get(k, 0) for k in BREAKER}
    assert gc.get("device_breaker_trips", 0) == 1, gc
    assert gc.get("device_attempt_failures", 0) == len(raised) >= 3, gc


@pytest.mark.parametrize("hook", HOOKS)
def test_any_other_device_error_reaches_the_caller(monkeypatch, hook):
    """An exception the breaker does not take (a RuntimeError, as a defect
    of the port's own code would raise) at the same hooks is caught by no
    resolver and no device attempt, unlike the reference's catch-all: it
    reaches collect(), and nothing counts a failure."""
    query = _break_hook(monkeypatch, daft_tpu_torch, hook, RuntimeError)
    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=MIN_ROWS)
    df = query(daft_tpu_torch, daft_tpu_torch.from_arrow(_parts(3)))
    with pytest.raises(RuntimeError, match="device failure"):
        df.collect()
    c = df.stats.snapshot()["counters"]
    assert c.get("device_breaker_trips", 0) == c.get("device_attempt_failures", 0) == 0, c
