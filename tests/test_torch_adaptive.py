"""Adaptive execution of the port (daft_tpu_torch/adaptive.py, run by
``runners.NativeRunner`` under ``enable_aqe``) held against daft_tpu on the
CPU: the cases of tests/test_adaptive.py at a smaller size, each through both
packages from emptied caches (tests/torch_parity.py ``run_seq``: the 32-bit
device mode, ``device_min_rows=8``). The stages, the strategies, the
resizes and the rows must be equal; so must the counters of
``torch_parity.COUNTERS`` and ``ADAPT_COUNTERS``.
"""

import numpy as np
import pytest

import daft_tpu_torch
from torch_parity import (adapt_counters, assert_same_rows, clear_adapt,  # noqa: F401
                          restore_port_config, run_seq)

# a tight broadcast threshold, so that the data can stay small: the right
# side's source (5,000 rows of int64 and float64, 80,000 bytes) is far above
# it, the 3 rows its filter keeps far below
_THRESH = 5_000
RTOL = 1e-6  # the 32-bit mode's float32 sums (tests/test_torch_segment.py)


@pytest.fixture(autouse=True)
def _clean():
    clear_adapt()
    yield
    clear_adapt()


def _big_small_join(pkg):
    """Left: big. Right: a source over the threshold that a filter shrinks to
    3 rows: its static estimate (the source's) stays over the threshold, so
    only adaptive execution finds that the join should broadcast."""
    rng = np.random.RandomState(0)
    n = 5000
    left = pkg.from_pydict({"k": rng.randint(0, 1000, n).astype(np.int64), "v": rng.randn(n)})
    right = pkg.from_pydict({"k": np.arange(n, dtype=np.int64), "w": rng.randn(n)})
    return left.join(right.where(pkg.col("k") < 3), on="k")


def step(df) -> tuple:
    df = df.collect()
    return df.to_pydict(), adapt_counters(df)


def both(build, aqe: bool = True, **knobs):
    """``build(pkg)`` collected through both packages: (reference, port),
    each (rows, counters)."""
    knobs = {"enable_aqe": aqe, "broadcast_join_size_bytes_threshold": _THRESH, **knobs}
    ref, got = run_seq(lambda pkg, set_knobs: step(build(pkg)), knobs=knobs)
    assert got[1] == ref[1]
    assert_same_rows(got[0], ref[0], rtol=RTOL)
    return ref, got


def test_static_plan_uses_hash():
    _, (rows, c) = both(_big_small_join, aqe=False)
    assert c["broadcast_joins"] == 0 and c["aqe_stages"] == 0
    assert len(rows["k"]) > 0


def test_aqe_switches_to_broadcast():
    _, (rows, c) = both(_big_small_join)
    assert c["aqe_stages"] >= 1 and c["broadcast_joins"] >= 1
    assert c["device_join_probes"] >= 1
    assert len(rows["k"]) > 0


def test_aqe_result_parity():
    _, (with_aqe, _) = both(_big_small_join)
    _, (without, _) = both(_big_small_join, aqe=False)
    assert sorted(zip(with_aqe["k"], with_aqe["v"])) == sorted(zip(without["k"], without["v"]))


def test_no_join_no_stages():
    _, (rows, c) = both(lambda pkg: pkg.from_pydict({"a": [1, 2, 3]}).where(pkg.col("a") > 1))
    assert rows == {"a": [2, 3]} and c["aqe_stages"] == 0


def test_nested_joins():
    def build(pkg):
        col = pkg.col
        a = pkg.from_pydict({"k": [1, 2, 3], "x": [10, 20, 30]})
        b = pkg.from_pydict({"k": [2, 3, 4], "y": [200, 300, 400]}).where(col("k") > 0)
        c = pkg.from_pydict({"k": [3, 4, 5], "z": [99, 98, 97]}).where(col("k") > 0)
        return a.join(b, on="k").join(c, on="k").sort("k")

    _, (rows, c) = both(build)
    assert rows == {"k": [3], "x": [30], "y": [300], "z": [99]}
    # b's filter, then the inner join (a join can shrink), then c's filter
    assert c["aqe_stages"] == 3


def test_explicit_strategy_respected():
    """A strategy the user pinned is not second-guessed."""
    def build(pkg):
        a = pkg.from_pydict({"k": [1, 2], "x": [1, 2]})
        b = pkg.from_pydict({"k": [2, 3], "y": [5, 6]}).where(pkg.col("k") > 0)
        return a.join(b, on="k", strategy="hash")

    _, (rows, c) = both(build)
    assert rows["k"] == [2] and c["aqe_stages"] == 0


def test_tiny_input_shrinks_fanout():
    """100 tiny rows fanned out 20 ways: the adapted plan collapses the
    shuffle to one partition (shrink-only, from the source's known size)."""
    def build(pkg):
        return (pkg.from_pydict({"g": list(range(100)), "v": [1.0] * 100})
                .repartition(20, pkg.col("g"))
                .groupby("g").agg(pkg.col("v").sum().alias("s")).sort("g"))

    _, (rows, c) = both(build)
    assert c["aqe_shuffle_resizes"] >= 1
    assert rows["g"] == list(range(100)) and rows["s"] == [1.0] * 100


def test_large_input_keeps_fanout():
    from daft_tpu_torch.adaptive import adapt_shuffle_counts
    from daft_tpu_torch.logical import Repartition

    cfg = daft_tpu_torch.ExecutionConfig(device="cpu", shuffle_target_partition_bytes=64)
    df = daft_tpu_torch.from_pydict({"g": list(range(1000)),
                                     "v": [1.0] * 1000}).repartition(4, daft_tpu_torch.col("g"))
    plan = adapt_shuffle_counts(df._plan, cfg)

    def find(p):
        if isinstance(p, Repartition):
            return p
        for c in p.children():
            f = find(c)
            if f is not None:
                return f
        return None

    rep = find(plan)
    assert rep is not None and rep.num == 4  # never grows


def test_adaptation_is_shrink_only_and_parity():
    rng = np.random.RandomState(0)
    data = {"g": rng.randint(0, 30, 5000).astype(np.int64), "v": rng.rand(5000)}

    def build(pkg):
        return (pkg.from_pydict(data).repartition(20, pkg.col("g"))
                .groupby("g").agg(pkg.col("v").sum().alias("s")).sort("g"))

    _, (got, c) = both(build)
    _, (want, _) = both(build, aqe=False)
    assert c["aqe_shuffle_resizes"] >= 1
    assert got["g"] == want["g"]
    np.testing.assert_allclose(got["s"], want["s"], rtol=RTOL)


def test_stages_share_one_breaker_and_one_deadline(monkeypatch):
    """The port alone: run_iter builds the query's DeviceHealth and its
    absolute deadline once, and every stage's ExecutionContext gets the same
    ones (a dead card does not pay the breaker's threshold again per stage;
    the stages share one time budget)."""
    from daft_tpu_torch import execution, runners

    seen = []
    real = execution.ExecutionContext

    class Recording(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen.append((self.device_health, self.deadline))

    monkeypatch.setattr(runners, "ExecutionContext", Recording)
    daft_tpu_torch.set_execution_config(daft_tpu_torch.ExecutionConfig(
        device="cpu", device_min_rows=8, enable_aqe=True, execution_timeout_s=600.0,
        broadcast_join_size_bytes_threshold=_THRESH))
    q = _big_small_join(daft_tpu_torch).collect()
    assert q.stats.snapshot()["counters"]["aqe_stages"] >= 1
    assert len(seen) >= 2
    assert len({id(h) for h, _ in seen}) == 1 and len({d for _, d in seen}) == 1
    assert seen[0][1] is not None
