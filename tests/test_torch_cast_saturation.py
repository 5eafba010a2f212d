"""The device cast of a float to an integer, and NaN in a 32-bit grouped
float sum: the port against daft_tpu on the CPU, in both device modes.

XLA's conversion saturates (NaN to 0, +inf and values past the top to the
type's maximum, -inf and values past the bottom to its minimum) and
truncates toward zero. torch's own conversion of those values is undefined,
so the port's Cast converts explicitly (``kernels/device.py``
``float_to_int``), and K2's emitted row function does the same
(``fes_f2sat``). The cases run ``[1.5, nan, inf, -inf, 3e10, -2.5]`` from
float32 and float64 columns into every integer kind at
``device_min_rows=8``, where both packages cast on the device path
(``device_projections`` 1).
"""

import ctypes

import numpy as np
import pyarrow as pa
import pytest
import torch

from test_torch_fused_expr_sums import _gxx_lib
from torch_parity import check, counters, restore_port_config, run_both  # noqa: F401

NAN = float("nan")
VALUES = [1.5, NAN, float("inf"), float("-inf"), 3e10, -2.5] * 4
TARGETS = ("int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64")

# the one target the packages cannot agree on: in the 32-bit mode the
# reference computes uint64 in a uint32 lane, the port in an int32 lane
# (kernels/device.py _NARROW_64), so the port saturates at 2**31 - 1 where
# the reference saturates at 2**32 - 1; values in [0, 2**31) agree
PINNED_32 = {"uint64": ([1, 0, 4294967295, 0, 4294967295, 0],
                        [1, 0, 2147483647, 0, 2147483647, 0])}


def _cast_frame(pkg, src: str, tgt: str):
    t = pa.table({"v": pa.array(VALUES, type=getattr(pa, src)())})
    return pkg.from_arrow(t).select(pkg.col("v").cast(getattr(pkg.DataType, tgt)()))


@pytest.mark.parametrize("x64", [False, True], ids=["32bit", "x64"])
@pytest.mark.parametrize("src", ["float32", "float64"])
@pytest.mark.parametrize("tgt", TARGETS)
def test_float_cast_saturates_as_the_reference(x64, src, tgt):
    ref, got = run_both(lambda pkg: _cast_frame(pkg, src, tgt), x64=x64)
    assert counters(got) == counters(ref)
    assert counters(got)["device_projections"] == 1
    r, g = ref.to_pydict()["v"], got.to_pydict()["v"]
    if not x64 and tgt in PINNED_32:
        assert (r[:6], g[:6]) == PINNED_32[tgt]
        assert r == PINNED_32[tgt][0] * 4 and g == PINNED_32[tgt][1] * 4
    else:
        assert g == r


@pytest.mark.parametrize("x64,want", [
    (False, [1, 0, 2147483647, -2147483648, 2147483647, -2]),
    (True, [1, 0, 2**63 - 1, -2**63, 30000000000, -2]),
], ids=["32bit", "x64"])
def test_int64_cast_gives_the_reference_table(x64, want):
    # the input the fault was found with, from_pydict's float64 column
    def build(pkg):
        df = pkg.from_pydict({"v": VALUES})
        return df.select(pkg.col("v").cast(pkg.DataType.int64()))

    ref, got = run_both(build, x64=x64)
    assert ref.to_pydict()["v"] == want * 4
    assert got.to_pydict()["v"] == want * 4


def test_int32_cast_on_the_cpu_device_is_explicit():
    # the wrapper itself, on a CPU tensor: no value reaches torch's undefined
    # conversion, in both float widths and both int32 and the uint64 bits lane
    from daft_tpu_torch.datatypes import DataType
    from daft_tpu_torch.kernels.device import float_cast_bounds, float_to_int

    for fd in (torch.float32, torch.float64):
        v = torch.tensor(VALUES[:6], dtype=fd)
        lo, hi = float_cast_bounds(DataType.int32(), torch.int32)
        assert float_to_int(v, torch.int32, lo, hi).tolist() == [
            1, 0, 2**31 - 1, -2**31, 2**31 - 1, -2]
        lo, hi = float_cast_bounds(DataType.uint64(), torch.int64)
        bits = float_to_int(v, torch.int64, lo, hi).numpy().view(np.uint64).tolist()
        big = 30000001024 if fd == torch.float32 else 30000000000
        assert bits == [1, 0, 2**64 - 1, 0, big, 0]


def test_deep_row_function_casts_as_the_closures(tmp_path):
    # K2's emitted Cast (fes_f2sat), built with g++, against the torch
    # closures, for every integer kind of the 32-bit mode
    from daft_tpu_torch import col
    from daft_tpu_torch.datatypes import DataType as T
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels.device import (_compile_node, normalize_and_check,
                                               stage_table_columns)
    from daft_tpu_torch.table import Table

    rng = np.random.RandomState(5)
    f = (rng.randn(512) * 1e10).astype(np.float32)
    f[:8] = [np.nan, np.inf, -np.inf, 2.0**31, -2.0**31, 2.0**32, -0.5, 255.5]
    tbl = Table.from_arrow(pa.table({"f": pa.array(f, mask=rng.rand(512) < 0.1)}))
    cases = [col("f").cast(getattr(T, t)()) for t in TARGETS]
    nodes = normalize_and_check(cases, tbl.schema)
    assert nodes is not None
    n = len(tbl)
    env, _ = stage_table_columns(tbl, ["f"], n, None, torch.device("cpu"))
    src, lane_dts = fes.probe_source(nodes, tbl.schema, {"f": env["f"][0].dtype})
    assert "fes_f2sat" in src
    lib = _gxx_lib(src, tmp_path, "cast_probe")
    cols = [t.contiguous() for t in env["f"]]
    outs = []
    for dt in lane_dts:
        outs += [torch.empty(n, dtype=dt), torch.empty(n, dtype=torch.bool)]
    lib.fes_probe_rows.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    lib.fes_probe_rows((ctypes.c_void_p * len(cols))(*[t.data_ptr() for t in cols]), n,
                       (ctypes.c_void_p * len(outs))(*[t.data_ptr() for t in outs]))
    for j, (name, nd) in enumerate(zip(TARGETS, nodes)):
        wv, wm = _compile_node(nd, tbl.schema)[0](env)
        assert torch.equal(outs[2 * j + 1], wm), name
        assert torch.equal(outs[2 * j][wm], wv[wm]), name


# ---------------------------------------------------------------------------
# NaN in a 32-bit grouped float sum: a difference pinned, not a fault
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parts", [1, 3])
def test_nan_stays_in_its_group_where_the_reference_spreads_it(parts):
    # The reference's K1 multiplies a one-hot matrix by the values
    # (daft_tpu/kernels/pallas_ops.py:53-55), so one NaN makes every group
    # NaN. The port's K1 adds only a group's own unmasked rows
    # (csrc/segment_sums_common.cuh), which gives the reference's x64 and
    # host results. The routing is equal.
    def build(pkg):
        d = {"k": [1, 2, 3, 1, 2, 3] * 4, "v": [1.0, 2.0, NAN, 4.0, 5.0, 6.0] * 4}
        if parts == 1:
            df = pkg.from_pydict(d)
        else:
            t = pa.table(d)
            df = pkg.from_arrow([t.slice(0, 8), t.slice(8, 8), t.slice(16, 8)])
        return df.groupby("k").agg(pkg.col("v").sum()).sort("k")

    ref, got = run_both(build)
    r, g = ref.to_pydict(), got.to_pydict()
    assert r["k"] == g["k"] == [1, 2, 3]
    assert all(np.isnan(x) for x in r["v"])
    assert g["v"][:2] == [20.0, 28.0] and np.isnan(g["v"][2])
    assert counters(got) == counters(ref)
    assert counters(got)["device_aggregations"] == parts

    # the port's answer is the reference's on its x64 device path
    ref64, got64 = run_both(build, x64=True)
    assert ref64.to_pydict()["v"][:2] == [20.0, 28.0]
    assert got64.to_pydict()["v"][:2] == [20.0, 28.0]
