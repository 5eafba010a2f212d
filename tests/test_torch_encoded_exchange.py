"""The encoded exchange and the combine's ledger and budget gate, held
against daft_tpu on the CPU (tests/test_exchange.py's encode and combiner
tests, tests/test_integrity.py TestEncodedExchangeIntegrity).

Each engine case runs one input, built from a seed with numpy, through both
packages under one budget (the reference on one executor thread, the 32-bit
device mode at ``device_min_rows=8``): equal rows, and equal
``exchange_pieces_encoded``, ``spilled_partitions``,
``exchange_precombined_rows`` and routing counters. ``exchange_bytes``,
``exchange_bytes_encoded`` and ``spill_write_bytes`` are held within each
package (encoded against raw): they follow ``Table.size_bytes`` and the
arrow buffers each package holds, which the cases here find equal but the
reference does not promise.
"""

import datetime

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu import col as ref_col
from daft_tpu import faults as ref_faults
from daft_tpu.spill import MEMORY_LEDGER as REF_LEDGER
from daft_tpu_torch import col, faults
from daft_tpu_torch.errors import DaftCorruptionError
from daft_tpu_torch.exchange.encode import (ENCODE_MIN_ROWS, EncodedExchangeTask,
                                            encode_exchange_partition)
from daft_tpu_torch.micropartition import MicroPartition
from daft_tpu_torch.spill import MEMORY_LEDGER, MemoryLedger
from torch_parity import SPILL_BASE as BASE
from torch_parity import assert_same_rows, restore_port_config, run_both  # noqa: F401
from torch_parity import spill_counters as _counters
from torch_parity import spill_dirs as _spill_dirs


@pytest.fixture(autouse=True)
def clean_ledgers(tmp_path, monkeypatch):
    """As tests/test_torch_spill.py's: spill directories in the case's own
    temp directory, ledgers from 0, plans disarmed, nothing left behind."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    before = _spill_dirs()
    MEMORY_LEDGER.reset()
    REF_LEDGER.reset()
    yield
    faults.disarm()
    ref_faults.disarm()
    assert MEMORY_LEDGER.current == 0 and MEMORY_LEDGER.async_spill_inflight == 0
    assert _spill_dirs() == before


def _lowcard(n: int, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    status = ["PENDING", "SHIPPED", "DELIVERED", "RETURNED"]
    return {"k": rng.randint(0, 300, n).tolist(),
            "s": [status[i % 4] for i in range(n)],
            "d": [datetime.date(1995, 1, 1 + i % 28) for i in range(n)],
            "v": rng.rand(n).tolist()}


def _both(build, **knobs):
    ref, got = run_both(build, knobs={**BASE, **knobs})
    assert_same_rows(got.to_pydict(), ref.to_pydict())
    assert _counters(got) == _counters(ref)
    return ref, got


def _c(df, key):
    return df.stats.snapshot()["counters"].get(key, 0)


# ---------------------------------------------------------------------------
# the budgeted exchange: tests/test_exchange.py TestEncodedExchange
# ---------------------------------------------------------------------------

def test_budgeted_exchange_encodes_and_matches():
    data = _lowcard(12_000, 2)

    def build(pkg):
        return pkg.from_pydict(data).into_partitions(4).repartition(4, "k")

    ref, on = _both(build, memory_budget_bytes=60_000)
    ref_off, off = _both(build, memory_budget_bytes=60_000, exchange_payload_encoding=False)
    assert_same_rows(on.to_pydict(), off.to_pydict())
    assert _c(on, "exchange_pieces_encoded") > 0 and _c(off, "exchange_pieces_encoded") == 0
    assert _c(on, "exchange_bytes_encoded") < _c(on, "exchange_bytes")
    assert _c(on, "exchange_bytes_encodable") == _c(on, "exchange_bytes")
    assert _c(on, "exchange_bytes") == _c(off, "exchange_bytes")
    # the spilled exchange bytes shrink too: the encoded payload hits disk
    assert 0 < _c(on, "spill_write_bytes") < _c(off, "spill_write_bytes")
    assert _c(ref, "spill_write_bytes") < _c(ref_off, "spill_write_bytes")


def test_spilled_encoded_pieces_decode_to_the_unbudgeted_schema():
    """Every column of the merged buckets has the unbudgeted run's dtype
    (strings, dates, integers, floats), and the partitions are equal, row
    for row, in order."""
    data = _lowcard(8_000, 3)
    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=8)
    plain = daft_tpu_torch.from_pydict(data).into_partitions(3).repartition(3, "s").collect()
    daft_tpu_torch.set_execution_config(device="cpu", device_min_rows=8,
                                        memory_budget_bytes=1)
    enc = daft_tpu_torch.from_pydict(data).into_partitions(3).repartition(3, "s").collect()
    assert _c(enc, "exchange_pieces_encoded") > 0 and _c(enc, "spilled_partitions") > 0
    for a, b in zip(enc._result.partitions, plain._result.partitions):
        assert a.is_loaded()
        assert a.schema == b.schema
        assert a.table().schema == b.table().schema
        assert a.table().to_arrow().equals(b.table().to_arrow())


def test_unbudgeted_exchange_does_not_encode():
    data = _lowcard(6_000, 4)
    ref, got = _both(lambda pkg: pkg.from_pydict(data).into_partitions(3).repartition(3, "k"))
    assert _c(got, "exchange_pieces_encoded") == 0 and _c(got, "spilled_partitions") == 0


def test_hostile_columns_ship_raw():
    n = 6000
    data = {"k": list(range(n)), "v": np.random.RandomState(1).rand(n).tolist()}
    ref, got = _both(lambda pkg: pkg.from_pydict(data).into_partitions(2).repartition(2, "k"),
                     memory_budget_bytes=50_000)
    assert _c(got, "exchange_pieces_encoded") == 0


def test_encode_failure_ships_raw():
    n = 4000
    data = {"k": (np.arange(n) % 100).tolist(), "s": [f"v{i % 4}" for i in range(n)]}

    def build(pkg):
        return pkg.from_pydict(data).into_partitions(4).repartition(4, "k")

    ref_faults.arm("exchange.encode", "always")
    faults.arm("exchange.encode", "always")
    ref, got = _both(build, memory_budget_bytes=20_000)
    assert _c(got, "exchange_encode_failures") == _c(ref, "exchange_encode_failures") >= 1
    assert _c(got, "exchange_pieces_encoded") == 0
    faults.disarm()
    ref_faults.disarm()
    _, raw = _both(build, memory_budget_bytes=20_000, exchange_payload_encoding=False)
    assert_same_rows(got.to_pydict(), raw.to_pydict())


def test_grouped_aggregate_over_encoded_spilled_exchange():
    """A two-stage aggregate by a string key under a budget: the stage-1
    partials encode, spill and fold (the combine's budget gate), and the
    aggregates above the exchange run on the device path."""
    data = _lowcard(12_000, 5)

    def build(pkg):
        return (pkg.from_pydict(data).into_partitions(4).repartition(4, "s").groupby("s", "d")
                .agg(pkg.col("k").sum().alias("ks"), pkg.col("v").count().alias("n")))

    ref, got = _both(build, memory_budget_bytes=24_000)
    assert _c(got, "device_aggregations") >= 4
    assert _c(got, "exchange_pieces_encoded") > 0 and _c(got, "spilled_partitions") > 0


# ---------------------------------------------------------------------------
# the encode: tests/test_exchange.py, tests/test_integrity.py
# ---------------------------------------------------------------------------

def _nulls_part(pkg, n: int = 2000):
    return pkg.micropartition.MicroPartition.from_pydict({
        "i": [None if i % 7 == 0 else i % 9 for i in range(n)],
        "s": [None if i % 5 == 0 else f"s{i % 6}" for i in range(n)],
        "d": [datetime.date(2024, 1, 1 + (i % 3)) for i in range(n)],
    })


def test_encode_roundtrip_equals_the_reference():
    import daft_tpu.micropartition  # noqa: F401
    from daft_tpu.exchange.encode import encode_exchange_partition as ref_encode

    part, rpart = _nulls_part(daft_tpu_torch), _nulls_part(daft_tpu)
    enc, renc = encode_exchange_partition(part), ref_encode(rpart)
    assert enc is not None and renc is not None
    assert not enc.is_loaded()
    assert (enc.size_bytes() or 0) < (part.size_bytes() or 0)
    assert enc.size_bytes() == renc.size_bytes()
    assert enc.scan_task().crc == renc.scan_task().crc
    assert enc.schema == part.schema
    assert enc.table().to_pydict() == part.table().to_pydict() == renc.table().to_pydict()
    assert enc.table().schema == part.table().schema


def test_encode_declines_tiny_pieces_and_python_objects():
    assert encode_exchange_partition(MicroPartition.from_pydict({"a": [1, 1, 2]})) is None
    objs = MicroPartition.from_pydict({"o": [object()] * (2 * ENCODE_MIN_ROWS)})
    assert encode_exchange_partition(objs) is None


def _encoded(integrity=True):
    part = MicroPartition.from_pydict({"g": [f"g{i % 4}" for i in range(4000)],
                                       "a": list(range(4000))})
    enc = encode_exchange_partition(part, integrity=integrity)
    assert enc is not None and isinstance(enc.scan_task(), EncodedExchangeTask)
    return part, enc


def test_clean_roundtrip_verified():
    part, enc = _encoded()
    assert enc.scan_task().crc is not None
    assert enc.table().to_arrow().equals(part.table().to_arrow())


def test_damaged_payload_raises_corruption():
    from daft_tpu_torch.execution import RuntimeStats

    part = MicroPartition.from_pydict({"g": [f"g{i % 4}" for i in range(4000)]})
    stats = RuntimeStats()
    enc = encode_exchange_partition(part, stats=stats)
    enc.scan_task().crc ^= 0xFF
    with pytest.raises(DaftCorruptionError):
        enc.table()
    assert stats.counters["corruption_detected"] == 1


def test_integrity_off_no_crc():
    part, enc = _encoded(integrity=False)
    assert enc.scan_task().crc is None
    assert enc.table().to_arrow().equals(part.table().to_arrow())


def test_encoded_piece_spills_encoded_and_reads_back():
    from daft_tpu_torch.spill import PartitionBuffer

    part, enc = _encoded()
    buf = PartitionBuffer(1, integrity=True)
    buf.append(enc)
    (s,) = buf.parts()
    task = s.scan_task()
    with pa.OSFile(task.path) as f:
        on_disk = pa.ipc.open_file(f).read_all()
    assert pa.types.is_dictionary(on_disk.schema.field("g").type)
    assert s.table().to_arrow().equals(part.table().to_arrow())
    buf.release()
    buf.scope.cleanup()


# ---------------------------------------------------------------------------
# the combine under a ledger: tests/test_exchange.py TestHierarchicalCombine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["daft_tpu", "daft_tpu_torch"])
def test_combiner_budget_gate(pkg):
    if pkg == "daft_tpu":
        import daft_tpu.micropartition as mp
        from daft_tpu.exchange.combine import BucketCombiner
        from daft_tpu.spill import MemoryLedger as Ledger
        c = ref_col
    else:
        import daft_tpu_torch.micropartition as mp
        from daft_tpu_torch.exchange.combine import BucketCombiner
        Ledger, c = MemoryLedger, col
    led = Ledger()
    comb = BucketCombiner([c("x").sum().alias("x")], [c("g")], ledger=led, budget=1)
    flushed = comb.add(0, mp.MicroPartition.from_pydict({"g": [1, 1], "x": [1, 2]}))
    assert comb.failed
    assert flushed is not None and len(flushed) == 1
    assert led.current == 0


def test_combiner_abandons_on_poor_shrink_and_balances():
    from daft_tpu_torch.exchange.combine import FOLD_EVERY, BucketCombiner

    led = MemoryLedger()
    comb = BucketCombiner([col("x").sum().alias("x")], [col("g")], ledger=led)
    flushed = None
    for i in range(FOLD_EVERY + 1):
        piece = MicroPartition.from_pydict({"g": list(range(i * 8, i * 8 + 8)), "x": [1] * 8})
        flushed = comb.add(0, piece)
        if flushed is not None:
            break
    assert comb.failed and flushed is not None
    assert sum(len(p) for _, p in flushed) == (FOLD_EVERY + 1) * 8
    assert led.current == 0 and led.negative_releases == 0


def test_combiner_ledger_balanced_through_folds():
    from daft_tpu_torch.exchange.combine import FOLD_EVERY, BucketCombiner

    led = MemoryLedger()
    comb = BucketCombiner([col("x").sum().alias("x")], [col("g")], ledger=led)
    for i in range(3 * FOLD_EVERY):
        assert comb.add(i % 2, MicroPartition.from_pydict({"g": [1, 2], "x": [i, i]})) is None
        assert led.current > 0
    out = list(comb.finish())
    assert [b for b, _ in out] == [0, 1]
    assert led.current == 0 and led.negative_releases == 0


def test_budgeted_combine_abandons_with_parity():
    """Under a small budget the fold of a two-stage aggregate abandons past
    half the budget, and the staged pieces go to the spillable buckets."""
    rng = np.random.RandomState(6)
    n = 24_000
    data = {"g": rng.randint(0, 400, n), "c": rng.randint(0, 100, n)}

    def build(pkg):
        return (pkg.from_pydict(data).into_partitions(12).groupby("g")
                .agg(pkg.col("c").sum().alias("s"), pkg.col("c").count().alias("n")))

    ref, tight = _both(build, memory_budget_bytes=8_000)
    _, loose = _both(build)
    assert_same_rows(tight.to_pydict(), loose.to_pydict())
    assert _c(tight, "exchange_precombined_rows") < _c(loose, "exchange_precombined_rows")


def test_a_defect_in_the_encode_reaches_the_caller(monkeypatch):
    """Pinned difference: the reference's catch around the encode takes any
    exception and ships the piece raw; the port's takes the injected fault
    and arrow errors only, so a defect of the encode reaches the caller."""
    import daft_tpu.exchange.encode as ref_encode

    import daft_tpu_torch.exchange.encode as encode

    def broken(arr):
        raise KeyError("a defect")

    data = _lowcard(2_000, 7)

    def build(pkg):
        return pkg.from_pydict(data).into_partitions(2).repartition(2, "k")

    monkeypatch.setattr(ref_encode, "_encode_column", broken)
    monkeypatch.setattr(encode, "_encode_column", broken)
    with pytest.raises(KeyError):
        run_both(build, knobs={**BASE, "memory_budget_bytes": 10_000})
    from daft_tpu.context import get_context

    cfg = get_context().execution_config
    saved = (cfg.memory_budget_bytes, cfg.enable_result_cache)
    cfg.memory_budget_bytes, cfg.enable_result_cache = 10_000, False
    try:
        q = build(daft_tpu)
        q.collect()
    finally:
        cfg.memory_budget_bytes, cfg.enable_result_cache = saved
    assert _c(q, "exchange_encode_failures") >= 1
