"""The port's planning layer for repeat-shaped traffic (daft_tpu_torch/adapt/:
the plan cache, the feedback history and feedback-directed planning; the
whole-plan result cache of ``DataFrame.collect``) held against daft_tpu on the
CPU: the cases of tests/test_adapt.py that need no scan, with the join flip
over in-memory frames instead of parquet files.

Each case empties both packages' plan caches, histories and result caches
and runs one input, made from a numpy seed, through both packages in the
same order (tests/torch_parity.py ``run_seq``: the 32-bit device mode with
``device_min_rows=8``, which keeps the aggregates and probes on the device
path). The decisions must be equal: hit or miss, flip or not, resize to
what, mispredict or not; so must the rows (as multisets for joins) and the
counters of ``torch_parity.COUNTERS`` and ``ADAPT_COUNTERS``. The
fingerprints themselves differ between the packages (their node classes
do); the relations between them must not.
"""

import contextlib
import gc
import importlib
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from torch_parity import (adapt_counters, assert_same_rows, clear_adapt,  # noqa: F401
                          restore_port_config, run_seq)

PKGS = [daft_tpu, daft_tpu_torch]
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mod(pkg, name: str):
    return importlib.import_module(f"{pkg.__name__}.{name}")


@pytest.fixture(autouse=True)
def _clean():
    from daft_tpu import faults as ref_faults
    from daft_tpu_torch import faults

    clear_adapt()
    yield
    faults.disarm()
    ref_faults.disarm()
    clear_adapt()


def step(df) -> tuple:
    """One collect: (rows, counters)."""
    df = df.collect()
    return df.to_pydict(), adapt_counters(df)


# float sums of the 32-bit mode: the packages' float32 reductions may differ
# in the last places (tests/test_torch_segment.py holds them to the same)
RTOL = 1e-6


def assert_same_steps(ref: list, got: list, ordered: bool = True):
    """Each step's counters equal in both packages, and its rows (floats
    within RTOL). Within one package the cases compare rows exactly."""
    assert len(ref) == len(got)
    for i, ((rrows, rc), (grows, gc_)) in enumerate(zip(ref, got)):
        assert gc_ == rc, (i, gc_, rc)
        assert_same_rows(grows, rrows, rtol=RTOL, ordered=ordered)


@contextlib.contextmanager
def counting_planner(pkg):
    """Count every optimize, translate, map-chain compile and plan-segment
    compile call of ``pkg``: what the warm path must not pay."""
    optimizer = _mod(pkg, "optimizer")
    physical = _mod(pkg, "physical")
    fuse = _mod(pkg, "fuse")
    fuse_compile = _mod(pkg, "fuse.compile")
    calls = {"optimize": 0, "translate": 0, "compile_chain": 0, "compile_plan_segments": 0}
    targets = [(optimizer, "optimize"), (physical, "translate"),
               (fuse_compile, "compile_chain"), (fuse, "compile_plan_segments")]
    real = [getattr(m, n) for m, n in targets]

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    for (m, n), fn in zip(targets, real):
        setattr(m, n, counted(n, fn))
    try:
        yield calls
    finally:
        for (m, n), fn in zip(targets, real):
            setattr(m, n, fn)


def _kv(n: int = 2000, keys: int = 5, seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    return {"k": rng.randint(0, keys, n).astype(np.int64), "v": rng.rand(n) * 100.0}


# ---------------------------------------------------------------------------
# canonical fingerprints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS, ids=["reference", "port"])
def test_same_shape_same_fp(pkg):
    fp = _mod(pkg, "adapt.fingerprint")
    df = pkg.from_pydict({"a": [1, 2, 3], "b": [1.0, 2.0, 3.0]})
    p1 = df.where(pkg.col("a") > 2).select(pkg.col("b"))._plan
    p2 = df.where(pkg.col("a") > 2).select(pkg.col("b"))._plan
    assert fp.canonical_fingerprint(p1) == fp.canonical_fingerprint(p2)


@pytest.mark.parametrize("pkg", PKGS, ids=["reference", "port"])
def test_literals_masked_structure_not(pkg):
    fp = _mod(pkg, "adapt.fingerprint")
    col = pkg.col
    df = pkg.from_pydict({"a": [1, 2, 3], "b": [1.0, 2.0, 3.0]})
    base = fp.canonical_fingerprint(df.where(col("a") > 2).select(col("b"))._plan)
    assert fp.canonical_fingerprint(df.where(col("a") > 9).select(col("b"))._plan) == base
    assert fp.canonical_fingerprint(df.where(col("b") > 2).select(col("b"))._plan) != base
    assert fp.canonical_fingerprint(df.where(col("a") < 2).select(col("b"))._plan) != base
    assert fp.literal_values(df.where(col("a") > 9).select(col("b"))._plan) == [9]


@pytest.mark.parametrize("pkg", PKGS, ids=["reference", "port"])
def test_literal_dtype_stays_identity(pkg):
    fp = _mod(pkg, "adapt.fingerprint")
    df = pkg.from_pydict({"a": [1, 2, 3]})
    weak = df.where(pkg.col("a") > pkg.lit(2))._plan
    strong = df.where(pkg.col("a") > pkg.lit(2, pkg.DataType.int8()))._plan
    assert fp.canonical_fingerprint(weak) != fp.canonical_fingerprint(strong)


@pytest.mark.parametrize("pkg", PKGS, ids=["reference", "port"])
def test_site_fp_distinguishes_data_identity(pkg):
    fp = _mod(pkg, "adapt.fingerprint")
    a = pkg.from_pydict({"a": [1, 2, 3]})._plan
    b = pkg.from_pydict({"a": [4, 5, 6]})._plan
    assert fp.canonical_fingerprint(a) == fp.canonical_fingerprint(b)
    assert fp.canonical_site_fp(a) != fp.canonical_site_fp(b)


_STABILITY_SCRIPT = """
import json
import sys
sys.path.insert(0, {root!r})
import daft_tpu_torch as d
from daft_tpu_torch import col
from daft_tpu_torch.adapt.fingerprint import canonical_fingerprint, literal_values
from daft_tpu_torch.optimizer import optimize
from daft_tpu_torch.physical import translate
d.set_execution_config(device="cpu", device_min_rows=8)
df = d.from_pydict({{"a": [1, 2, 3], "b": [1.0, 2.0, 3.0], "l": [[1], [2, 3], []],
                    "s": ["x", "y", "x"]}})
other = d.from_pydict({{"a": [4], "b": [4.0], "l": [[4]], "s": ["z"]}})
out = []
for lit in (5, 9):
    plans = [
        df.where(col("a") > lit).select(col("b")),
        df.concat(other).where(col("a") > lit),
        df.sample(0.5, seed=7).where(col("a") > lit),
        df.explode("l").where(col("a") > lit),
        df.unpivot("a", ["b"]).where(col("a") > lit),
        df.pivot("a", "s", "b", "sum", names=["x", "y"]).where(col("a") > lit),
        df.with_monotonically_increasing_id().where(col("a") > lit),
    ]
    for q in plans:
        out.append(canonical_fingerprint(q._plan))
    q = plans[0]
    out.append(repr(literal_values(q._plan)))
    out.append(translate(optimize(q._plan)).display_tree())
print(json.dumps(out))
"""


def test_cross_process_stability():
    """The port alone, in two interpreters (this one and a spawned one): one
    plan shape gives one canonical fingerprint in both and for both
    literals; the literals the fingerprint masked and the physical plan
    repeat across the processes. The plans cover the in-memory nodes of the
    relational surface (concat, sample, explode, unpivot, pivot, monotonic
    ids), whose attributes must not put an address or a per-process value
    into the identity scope."""
    import io

    script = _STABILITY_SCRIPT.format(root=_ROOT)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    here = io.StringIO()
    with contextlib.redirect_stdout(here):
        exec(compile(script, "<stability>", "exec"), {})
    a = json.loads(here.getvalue().strip().splitlines()[-1])
    b = json.loads(res.stdout.strip().splitlines()[-1])
    assert a == b  # process-invariant
    n = 7
    assert a[:n] == a[n + 2:2 * n + 2]  # literal-invariant, node by node
    assert len(set(a[:n])) == n  # structure-sensitive
    assert a[n] == "[5]" and a[2 * n + 2] == "[9]"  # the masked literals


# ---------------------------------------------------------------------------
# the plan cache: the warm path
# ---------------------------------------------------------------------------

def _chain_agg(pkg, df, scale: float = 2.0):
    col = pkg.col
    return (df.with_column("w", col("v") * scale).where(col("w") > 10.0)
            .groupby("k").agg(col("w").sum().alias("s")).sort("k"))


def test_second_run_zero_planning_and_byte_identical():
    def seq(pkg, set_knobs):
        df = pkg.from_pydict(_kv())
        out = []
        with counting_planner(pkg) as calls:
            cold = _chain_agg(pkg, df).collect()
            cold_calls = dict(calls)
            warm = _chain_agg(pkg, df).collect()
            warm_calls = dict(calls)
        assert cold_calls["optimize"] == cold_calls["translate"] == 1
        assert cold_calls["compile_chain"] >= 1 and cold_calls["compile_plan_segments"] >= 1
        assert warm_calls == cold_calls, (warm_calls, cold_calls)
        assert warm.to_arrow() == cold.to_arrow()
        c = warm.stats.snapshot()["counters"]
        assert c["plan_cache_hits"] == 1 and c["planning_wall_ns"] > 0
        out += [(cold.to_pydict(), adapt_counters(cold)), (warm.to_pydict(), adapt_counters(warm))]
        set_knobs(plan_cache=False)
        off = _chain_agg(pkg, df).collect()
        assert off.to_arrow() == cold.to_arrow()
        assert "plan_cache_hits" not in off.stats.snapshot()["counters"]
        out.append((off.to_pydict(), adapt_counters(off)))
        return out

    ref, got = run_seq(seq, knobs={"enable_result_cache": False})
    assert_same_steps(ref, got)
    assert got[0][1]["device_aggregations"] >= 1


def _threaded(pkg, query, nthreads: int, runs: int, barrier: bool, switch_s=None):
    results, errors = [], []
    lock = threading.Lock()
    gate = threading.Barrier(nthreads) if barrier else None

    def worker():
        try:
            if gate is not None:
                gate.wait(30)
            for _ in range(runs):
                got = query().to_pydict()
                with lock:
                    results.append(got)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(nthreads)]
    interval = sys.getswitchinterval()
    if switch_s is not None:
        sys.setswitchinterval(switch_s)  # switch threads often: a lost update shows
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return results


def test_concurrent_hammer_exactly_once_compile():
    def seq(pkg, set_knobs):
        df = pkg.from_pydict(_kv(seed=1))

        def query():
            return _chain_agg(pkg, df, 1.5)

        with counting_planner(pkg) as calls:
            want = query().to_pydict()  # the one cold plan, sequential
            results = _threaded(pkg, query, 8, 2, barrier=False)
            assert calls["optimize"] == 1 and calls["translate"] == 1, calls
        assert len(results) == 16 and all(r == want for r in results)
        snap = _mod(pkg, "adapt").PLAN_CACHE.snapshot()
        return snap["hits"], snap["misses"]

    ref, got = run_seq(seq, knobs={"enable_result_cache": False})
    assert got == ref == (16, 1)


def test_concurrent_cold_misses_single_flight():
    """8 threads racing one cold shape plan it once."""
    def seq(pkg, set_knobs):
        df = pkg.from_pydict(_kv(seed=2))

        def query():
            col = pkg.col
            return (df.with_column("w", col("v") * 3.0)
                    .groupby("k").agg(col("w").max().alias("m")).sort("k"))

        with counting_planner(pkg) as calls:
            results = _threaded(pkg, query, 8, 1, barrier=True, switch_s=1e-5)
            assert calls["optimize"] == 1, calls
        assert len(results) == 8 and len(set(map(str, results))) == 1
        return results[0]

    ref, got = run_seq(seq, knobs={"enable_result_cache": False})
    assert_same_rows(got, ref, rtol=RTOL, ordered=True)


# ---------------------------------------------------------------------------
# the plan cache: invalidation
# ---------------------------------------------------------------------------

def _planned(pkg, df, toggles):
    """The chain aggregate once, then once after each (knob, value) of
    ``toggles``: each run's rows and the optimize calls in all."""
    out = []
    with counting_planner(pkg) as calls:
        out.append(step(_chain_agg(pkg, df)))
        for set_knobs, kw in toggles:
            set_knobs(**kw)
            out.append(step(_chain_agg(pkg, df)))
    return out, calls["optimize"]


def test_config_delta_invalidates():
    def seq(pkg, set_knobs):
        df = pkg.from_pydict(_kv(seed=3))
        steps, n = _planned(pkg, df, [(set_knobs, {"sample_size_for_sort": 21})])
        assert n == 2  # a changed knob plans afresh
        return steps

    ref, got = run_seq(seq, knobs={"enable_result_cache": False})
    assert_same_steps(ref, got)
    assert got[1][1]["plan_cache_misses"] == 1 and got[1][0] == got[0][0]


def test_integrity_and_lineage_knobs_invalidate():
    def seq(pkg, set_knobs):
        df = pkg.from_pydict(_kv(seed=4))
        steps, n = _planned(pkg, df, [(set_knobs, {"partition_integrity": False}),
                                      (set_knobs, {"lineage_recomputation": False})])
        assert n == 3  # one plan per toggle
        return steps

    ref, got = run_seq(seq, knobs={"enable_result_cache": False})
    assert_same_steps(ref, got)


def test_new_frame_of_one_shape_plans_afresh():
    """The in-memory counterpart of the reference's rewritten file: a new
    frame of the same shape shares the canonical entry but not the binding
    (its source's token), so it plans afresh and serves its own rows."""
    def seq(pkg, set_knobs):
        out = []
        with counting_planner(pkg) as calls:
            out.append(step(_chain_agg(pkg, pkg.from_pydict(_kv(seed=5)))))
            out.append(step(_chain_agg(pkg, pkg.from_pydict(_kv(seed=6)))))
            assert calls["optimize"] == 2
        return out

    ref, got = run_seq(seq, knobs={"enable_result_cache": False})
    assert_same_steps(ref, got)
    assert got[0][0] != got[1][0]


def test_version_and_generation_bump_invalidate(monkeypatch):
    def seq(pkg, set_knobs):
        pc = _mod(pkg, "adapt.plancache")
        df = pkg.from_pydict(_kv(seed=7))
        want = _chain_agg(pkg, df).to_pydict()
        with monkeypatch.context() as m:
            m.setattr(pc, "CACHE_VERSION", pc.CACHE_VERSION + 1)
            with counting_planner(pkg) as calls:
                assert _chain_agg(pkg, df).to_pydict() == want
                assert calls["optimize"] == 1  # the version bump plans afresh
                pc.PLAN_CACHE.bump_generation()
                assert _chain_agg(pkg, df).to_pydict() == want
                assert calls["optimize"] == 2  # so does the generation bump
        return want

    ref, got = run_seq(seq, knobs={"enable_result_cache": False})
    assert_same_rows(got, ref, rtol=RTOL, ordered=True)


def test_byte_cap_lru_sheds():
    """A cap of about two and a half plans (each package's own plan bytes,
    since the estimate reads the plans' display trees): six literal variants
    shed, the cache stays under the cap and the ledger's account equals the
    cache's bytes."""
    def seq(pkg, set_knobs):
        pc = _mod(pkg, "adapt.plancache").PLAN_CACHE
        ledger = _mod(pkg, "spill").MEMORY_LEDGER
        df = pkg.from_pydict(_kv(seed=8))
        _chain_agg(pkg, df, 1.0).collect()
        one = pc.snapshot()["bytes"]
        pc.clear()
        cap = int(2.5 * one)
        set_knobs(plan_cache_bytes=cap)
        for lit in (1.0, 2.0, 3.0, 4.0, 5.0, 6.0):
            _chain_agg(pkg, df, lit).collect()
        snap = pc.snapshot()
        assert 0 < snap["bytes"] <= cap
        assert ledger.snapshot()["plan_cache_bytes"] == snap["bytes"]
        return snap["evictions"], snap["bindings"]

    ref, got = run_seq(seq, knobs={"enable_result_cache": False})
    assert got == ref and got[0] > 0


def test_lookup_fault_fails_open():
    def seq(pkg, set_knobs):
        faults = _mod(pkg, "faults")
        df = pkg.from_pydict(_kv(seed=9))
        out = [step(_chain_agg(pkg, df))]
        with faults.inject("plancache.lookup", "always"):
            out.append(step(_chain_agg(pkg, df)))  # degraded, never failed
        assert out[1][0] == out[0][0]
        assert out[1][1]["plan_cache_errors"] >= 1 and out[1][1]["plan_cache_hits"] == 0
        return out

    ref, got = run_seq(seq, knobs={"enable_result_cache": False})
    assert_same_steps(ref, got)


def test_armed_faults_stand_cache_down():
    """Any armed fault plan stands the cache down: a cached plan would let an
    armed site (fuse.compile here) never fire."""
    def seq(pkg, set_knobs):
        faults = _mod(pkg, "faults")
        df = pkg.from_pydict(_kv(seed=10))
        out = [step(_chain_agg(pkg, df))]  # a warm entry exists now
        with faults.inject("fuse.compile", "always"):
            q = _chain_agg(pkg, df).collect()
            c = q.stats.snapshot()["counters"]
            out.append((q.to_pydict(), adapt_counters(q)))
        # the unfused chain rounds its float32 products on their own
        assert_same_rows(out[1][0], out[0][0], rtol=RTOL, ordered=True)
        assert "plan_cache_hits" not in c and "fused_chains" not in c
        return out

    ref, got = run_seq(seq, knobs={"enable_result_cache": False})
    assert_same_steps(ref, got)


def test_device_and_mode_are_part_of_the_key():
    """The port alone: the config key holds ``device`` and ``device_x64``,
    so a plan made for the CPU never serves the card and a 32-bit plan never
    serves the 64-bit mode."""
    from daft_tpu_torch.adapt.plancache import _cfg_key

    cfg = daft_tpu_torch.ExecutionConfig(device="cpu", device_min_rows=8,
                                         enable_result_cache=False)
    key = _cfg_key(cfg)
    assert "device='cpu'" in key and "device_x64=False" in key
    daft_tpu_torch.set_execution_config(cfg)
    df = daft_tpu_torch.from_pydict(_kv(seed=11))
    with counting_planner(daft_tpu_torch) as calls:
        a = _chain_agg(daft_tpu_torch, df).collect()
        daft_tpu_torch.set_execution_config(device_x64=True)
        b = _chain_agg(daft_tpu_torch, df).collect()
        assert calls["optimize"] == 2
    assert "plan_cache_hits" not in b.stats.snapshot()["counters"]
    assert_same_rows(b.to_pydict(), a.to_pydict(), rtol=1e-6, ordered=True)


# ---------------------------------------------------------------------------
# feedback-directed planning: the join flip over in-memory frames
# ---------------------------------------------------------------------------

# the broadcast threshold of the flip cases: the dim side's static estimate
# (2,000 rows of a 100-character payload, about 230 KB) is far above it, its
# filtered rows (k < 5: about 600 bytes) far below half of it, and most of
# it (k < 1900) far above one and a half times it
_THRESH = 20_000


def _join_frames(pkg):
    rng = np.random.RandomState(7)
    fact = pkg.from_pydict({"k": (np.arange(5000) % 500).astype(np.int64),
                            "v": np.arange(5000, dtype=np.int64)}).into_partitions(4)
    dim = pkg.from_pydict({"k": np.arange(2000, dtype=np.int64),
                           "w": [rng.bytes(50).hex() for _ in range(2000)]})
    return fact, dim


def _flip_query(pkg, fact, dim, lit=5, dim_left=False):
    d = dim.where(pkg.col("k") < lit)
    j = d.join(fact, on="k") if dim_left else fact.join(d, on="k")
    # the payload column stays in the plan, so the side's bytes are its rows'
    return (j.groupby("k").agg(pkg.col("v").sum().alias("s"), pkg.col("w").count().alias("n"))
            .sort("k"))


def _observed(pkg) -> list:
    """The feedback history's sites: (EWMA rows, EWMA bytes) each."""
    h = _mod(pkg, "adapt.history").HISTORY
    with h._lock:
        return sorted((int(s.rows), int(s.bytes)) for s in h._sites.values())


def test_flip_on_second_run_and_for_a_new_literal():
    def seq(pkg, set_knobs):
        fact, dim = _join_frames(pkg)
        out = [step(_flip_query(pkg, fact, dim))]
        print(pkg.__name__, "observed (rows, bytes):", _observed(pkg))
        out.append(step(_flip_query(pkg, fact, dim)))
        # a different literal shares the shape: it flips on its first run too
        out.append(step(_flip_query(pkg, fact, dim, lit=7)))
        return out

    ref, got = run_seq(seq, knobs={"enable_result_cache": False,
                                   "broadcast_join_size_bytes_threshold": _THRESH})
    assert_same_steps(ref, got)
    (cold_rows, cold), (flip_rows, flip), (_, lit7) = got
    assert cold["broadcast_joins"] == 0 and cold["device_join_probes"] >= 1
    assert flip["fdo_join_flips"] == 1 and flip["broadcast_joins"] >= 1
    assert flip["device_join_probes"] >= 1
    assert flip_rows == cold_rows
    assert lit7["fdo_join_flips"] == 1


def test_warm_runs_reuse_flipped_plan():
    def seq(pkg, set_knobs):
        fact, dim = _join_frames(pkg)
        return [step(_flip_query(pkg, fact, dim)) for _ in range(3)]

    ref, got = run_seq(seq, knobs={"enable_result_cache": False,
                                   "broadcast_join_size_bytes_threshold": _THRESH})
    assert_same_steps(ref, got)
    assert got[2][1]["plan_cache_hits"] == 1 and got[2][1]["broadcast_joins"] >= 1
    assert got[2][0] == got[0][0]


def test_mispredict_demotes_and_degrades():
    """The site key masks the literal: history says the side is small, and
    a literal that keeps most of it arrives big. The query completes on the
    broadcast plan, the shape's cached plans are demoted, and the next plan
    joins by hash."""
    def seq(pkg, set_knobs):
        pc = _mod(pkg, "adapt.plancache").PLAN_CACHE
        fact, dim = _join_frames(pkg)
        out = [step(_flip_query(pkg, fact, dim)), step(_flip_query(pkg, fact, dim))]
        demotions = pc.snapshot()["demotions"]
        out.append(step(_flip_query(pkg, fact, dim, lit=1900)))
        out.append(step(_flip_query(pkg, fact, dim, lit=1900)))
        print(pkg.__name__, "observed (rows, bytes):", _observed(pkg))
        return out, pc.snapshot()["demotions"] > demotions

    (ref, ref_demoted), (got, demoted) = run_seq(
        seq, knobs={"enable_result_cache": False,
                    "broadcast_join_size_bytes_threshold": _THRESH})
    assert_same_steps(ref, got)
    assert ref_demoted and demoted
    assert got[1][1]["fdo_join_flips"] == 1
    big, after = got[2][1], got[3][1]
    assert big["fdo_mispredicts"] >= 1 and big["broadcast_joins"] >= 1
    assert after["fdo_join_flips"] == 0 and after["broadcast_joins"] == 0
    assert after["device_join_probes"] >= 1
    assert got[3][0] == got[2][0]


def test_small_left_side_of_inner_join_flips_too():
    """An inner join consults both sides: a left side history calls small
    flips, though the static planner's preferred side (right) stays big."""
    def seq(pkg, set_knobs):
        fact, dim = _join_frames(pkg)
        return [step(_flip_query(pkg, fact, dim, dim_left=True)) for _ in range(2)]

    ref, got = run_seq(seq, knobs={"enable_result_cache": False,
                                   "broadcast_join_size_bytes_threshold": _THRESH})
    assert_same_steps(ref, got)
    assert got[1][1]["fdo_join_flips"] == 1 and got[1][1]["broadcast_joins"] >= 1


def test_history_fdo_off_never_flips():
    def seq(pkg, set_knobs):
        fact, dim = _join_frames(pkg)
        return [step(_flip_query(pkg, fact, dim)) for _ in range(2)]

    ref, got = run_seq(seq, knobs={"enable_result_cache": False, "history_fdo": False,
                                   "broadcast_join_size_bytes_threshold": _THRESH})
    assert_same_steps(ref, got)
    assert got[1][1]["fdo_join_flips"] == 0 and got[1][1]["broadcast_joins"] == 0


# ---------------------------------------------------------------------------
# feedback-directed planning: the fan-out resize
# ---------------------------------------------------------------------------

def _fanout_frame(pkg):
    return pkg.from_pydict(_kv(4000, 7, seed=12)).into_partitions(8).collect()


def _fanout_query(pkg, df):
    return df.groupby("k").agg(pkg.col("v").sum().alias("s")).sort("k")


def test_aggregate_exchange_resized_from_history():
    """The second run's exchange emits the partitions its recorded payload
    needs (one), merging adjacent buckets: the rows equal the cold run's,
    and the sort above reads the resized count (no range shuffle over one
    partition)."""
    def seq(pkg, set_knobs):
        df = _fanout_frame(pkg)
        out = [step(_fanout_query(pkg, df)), step(_fanout_query(pkg, df))]
        out.append(step(_fanout_query(pkg, df)))  # the resized plan, warm
        return out

    ref, got = run_seq(seq, knobs={"enable_result_cache": False})
    assert_same_steps(ref, got)
    cold, resized, warm = (c for _, c in got)
    assert cold["fdo_shuffle_resizes"] == 0 and cold["shuffles"] == 2
    assert resized["fdo_shuffle_resizes"] == 1 and resized["fdo_reduced_partitions"] == 7
    assert resized["shuffles"] == 1
    assert warm["plan_cache_hits"] == 1 and warm["fdo_reduced_partitions"] == 7
    assert got[1][0] == got[0][0]


def test_resized_exchange_shows_in_the_plan():
    from daft_tpu_torch.adapt import fdo
    from daft_tpu_torch.adapt.history import HISTORY
    from daft_tpu_torch.optimizer import optimize
    from daft_tpu_torch.physical import translate

    cfg = daft_tpu_torch.ExecutionConfig(device="cpu", device_min_rows=8)
    daft_tpu_torch.set_execution_config(cfg)
    df = _fanout_frame(daft_tpu_torch)
    plan = optimize(_fanout_query(daft_tpu_torch, df)._plan)
    agg = plan.input if type(plan).__name__ == "Sort" else plan
    with fdo.collecting(cfg, None):
        HISTORY.observe(fdo.agg_observation_key(agg), 70, 1000)
        tree = translate(plan, cfg).display_tree()
    assert "Shuffle[hash] -> 8 by [col(k)] <fdo-reduce 1>" in tree
    assert "Shuffle[range]" not in tree


def test_failed_runs_never_feed_history():
    """A non-ok run's site observations are dropped: a partly consumed
    exchange must never seed a broadcast flip."""
    for pkg in PKGS:
        stats = _mod(pkg, "execution").RuntimeStats()
        history = _mod(pkg, "adapt.history").HISTORY
        stats.fdo_observe("deadbeef00000000", 10, 100)
        history.fold("", stats, {"outcome": "error", "wall_s": 0.1, "counters": {}})
        assert history.size("deadbeef00000000") is None
        stats.fdo_observe("deadbeef00000000", 10, 100)
        history.fold("", stats, {"outcome": "ok", "wall_s": 0.1, "counters": {}})
        assert history.size("deadbeef00000000") == (10, 100, 1)


def test_timed_out_query_leaves_no_observation():
    """The engine's own outcome: a query past its deadline folds as a
    timeout, and its exchange's observations never reach the history."""
    def seq(pkg, set_knobs):
        errors = _mod(pkg, "errors")
        df = _fanout_frame(pkg)
        set_knobs(execution_timeout_s=0.0)
        with pytest.raises(errors.DaftTimeoutError):
            _fanout_query(pkg, df).collect()
        return _mod(pkg, "adapt.history").HISTORY.snapshot()["sites"]

    ref, got = run_seq(seq, knobs={"enable_result_cache": False})
    assert got == ref == 0


def test_fanout_off_with_knob():
    def seq(pkg, set_knobs):
        df = _fanout_frame(pkg)
        return [step(_fanout_query(pkg, df)) for _ in range(2)]

    ref, got = run_seq(seq, knobs={"enable_result_cache": False, "history_fdo": False})
    assert_same_steps(ref, got)
    assert got[1][1]["fdo_shuffle_resizes"] == 0 and got[1][1]["shuffles"] == 2


# ---------------------------------------------------------------------------
# rehydration (the clone of a cached plan)
# ---------------------------------------------------------------------------

def _find(op, cls, out=None):
    out = [] if out is None else out
    if isinstance(op, cls):
        out.append(op)
    for c in op.children:
        _find(c, cls, out)
    return out


def test_clone_resets_per_query_state():
    """The port's per-query latches (FusedMapOp._recorded_for,
    DeviceSegmentOp._recorded_for and _resident_for) reset in the clone;
    the compiled programs are shared."""
    from daft_tpu_torch.adapt.plancache import clone_plan
    from daft_tpu_torch.fuse.compile import FusedMapOp
    from daft_tpu_torch.fuse.segment import DeviceSegmentOp
    from daft_tpu_torch.optimizer import optimize
    from daft_tpu_torch.physical import translate

    col = daft_tpu_torch.col
    cfg = daft_tpu_torch.ExecutionConfig(device="cpu", device_min_rows=8)
    df = daft_tpu_torch.from_pydict({"k": [1, 2, 1, 2], "v": [1.0, 2.0, 3.0, 4.0]})
    fused_plan = df.with_column("w", col("v") + 1.0).where(col("w") > 3.0)._plan
    seg_plan = (df.with_column("w", col("v") + 1.0).groupby("k")
                .agg(col("w").sum().alias("s")))._plan
    for plan, cls in ((fused_plan, FusedMapOp), (seg_plan, DeviceSegmentOp)):
        phys = translate(optimize(plan), cfg)
        (op,) = _find(phys, cls)
        marker = object()
        op._recorded_for = marker  # a prior execution's latches
        if cls is DeviceSegmentOp:
            op._resident_for = marker
        (cop,) = _find(clone_plan(phys), cls)
        assert cop is not op and cop._recorded_for is None
        assert getattr(cop, "_resident_for", None) is None
        assert cop.program is op.program  # immutable, shared
        assert op._recorded_for is marker  # the cached tree is untouched


def test_join_filter_slots_fresh_and_paired():
    from daft_tpu_torch.adapt.plancache import clone_plan
    from daft_tpu_torch.optimizer import optimize
    from daft_tpu_torch.physical import ShuffleOp, translate

    cfg = daft_tpu_torch.ExecutionConfig(device="cpu", device_min_rows=8)
    a = daft_tpu_torch.from_pydict({"k": list(range(100)),
                                    "v": list(range(100))}).into_partitions(2)
    b = daft_tpu_torch.from_pydict({"k": list(range(50)),
                                    "w": list(range(50))}).into_partitions(2)
    phys = translate(optimize(a.join(b, on="k", strategy="hash")._plan), cfg)
    orig = _find(phys, ShuffleOp)
    feed = [s for s in orig if s.filter_feed is not None]
    probe = [s for s in orig if s.probe_filter is not None]
    assert feed and probe and feed[0].filter_feed is probe[0].probe_filter
    cs = _find(clone_plan(phys), ShuffleOp)
    cfeed = [s for s in cs if s.filter_feed is not None][0]
    cprobe = [s for s in cs if s.probe_filter is not None][0]
    assert cfeed.filter_feed is cprobe.probe_filter  # still paired
    assert cfeed.filter_feed is not feed[0].filter_feed  # but fresh


# ---------------------------------------------------------------------------
# the ledger's account and the whole-plan result cache
# ---------------------------------------------------------------------------

def test_ledger_carries_the_plan_cache_account():
    def seq(pkg, set_knobs):
        ledger = _mod(pkg, "spill").MEMORY_LEDGER
        pc = _mod(pkg, "adapt").PLAN_CACHE
        assert "plan_cache_bytes" in ledger.snapshot()
        _chain_agg(pkg, pkg.from_pydict(_kv(seed=13))).collect()
        assert ledger.snapshot()["plan_cache_bytes"] == pc.snapshot()["bytes"] > 0
        pc.clear()
        return ledger.snapshot()["plan_cache_bytes"]

    ref, got = run_seq(seq, knobs={"enable_result_cache": False})
    assert got == ref == 0


def test_second_collect_of_one_plan_hits_the_result_cache():
    """While the DataFrame that collected a plan lives, a second collect of
    the same plan is served from its result (``result_cache_hits``, no
    planning); the entry goes when that DataFrame goes."""
    def seq(pkg, set_knobs):
        psets = _mod(pkg, "runners").partition_set_cache()
        df = pkg.from_pydict(_kv(seed=14))
        first = _chain_agg(pkg, df).collect()
        out = [(first.to_pydict(), adapt_counters(first))]
        second = _chain_agg(pkg, df).collect()
        out.append((second.to_pydict(), adapt_counters(second)))
        held = len(psets)
        del first, second
        gc.collect()
        out.append(step(_chain_agg(pkg, df)))
        return out, held - len(psets)

    (ref, ref_freed), (got, freed) = run_seq(seq)
    assert_same_steps(ref, got)
    assert got[1][1]["result_cache_hits"] == 1 and got[1][1]["plan_cache_misses"] == 0
    assert got[1][1]["device_aggregations"] == 0
    assert got[2][1]["result_cache_hits"] == 0 and got[2][1]["plan_cache_hits"] == 1
    assert freed == ref_freed >= 1


def test_result_cache_keys_on_the_config():
    """The port alone, a pinned difference: its result cache keys on the
    config too, so a result collected in the 32-bit mode never serves the
    64-bit mode (the reference keys on the plan alone; its mode is a
    process-wide jax flag, not a knob of its config)."""
    daft_tpu_torch.set_execution_config(daft_tpu_torch.ExecutionConfig(
        device="cpu", device_min_rows=8))
    df = daft_tpu_torch.from_pydict(_kv(seed=15))
    first = _chain_agg(daft_tpu_torch, df).collect()
    again = _chain_agg(daft_tpu_torch, df).collect()
    assert again.stats.snapshot()["counters"]["result_cache_hits"] == 1
    daft_tpu_torch.set_execution_config(device_x64=True)
    x64 = _chain_agg(daft_tpu_torch, df).collect()
    c = x64.stats.snapshot()["counters"]
    assert "result_cache_hits" not in c and c["device_aggregations"] >= 1
    assert first is not None
