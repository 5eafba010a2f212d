"""The port's masked segment sums (daft_tpu_torch/kernels/segment_sums.py)
held against daft_tpu's Pallas kernel in interpret mode, on the CPU.

The CUDA kernel itself runs only on the card; chip_smoke.py holds it against
the plain version there. Here the wrapper takes the plain version because the
tensors lie on the CPU.

Tolerance: sums agree at rtol 1e-6 relative to the magnitudes summed
(sum over the group of |value|). Both sides accumulate in float32 within a
block in different orders, so a group whose values cancel (the randn case)
differs by float32 rounding of its terms, not of its total; for the
all-positive cases the bound is exactly rtol 1e-6 of the sum. Counts are
exact.
"""

import ctypes
import inspect
import shutil
import subprocess

import numpy as np
import pytest
import torch

from daft_tpu.kernels.pallas_ops import masked_segment_sums as pallas_sums
from daft_tpu_torch.kernels import nvcc, segment_sums


def _case_matches_numpy():
    rng = np.random.RandomState(0)
    n, g, k = 5000, 16, 3
    return rng.randint(0, g, n), rng.rand(n) < 0.8, rng.randn(n, k), g


def _case_no_mask_and_padding_row_isolation():
    # n deliberately not a multiple of the block size: padded rows must not leak
    return np.zeros(1030, np.int64), None, np.ones((1030, 1)), 4


def _case_nan_behind_mask():
    return (np.array([0, 0, 1]), np.array([True, False, True]),
            np.array([[1.0], [np.nan], [2.0]]), 2)


def _case_empty_group_zero():
    return np.array([2, 2]), None, np.array([[5.0], [7.0]]), 4


def _case_kahan_large_magnitude():
    # TPC-H-scale money sums: group sums ~1.8e9 where float32 ulp is 128;
    # a naive float32 running sum drifts past 1e-6 relative
    rng = np.random.RandomState(1)
    n, g = 200_000, 4
    return rng.randint(0, g, n), None, (rng.rand(n) * 68000 + 900)[:, None], g


CASES = {
    "matches_numpy": (_case_matches_numpy, 1e-5),
    "padding_isolation": (_case_no_mask_and_padding_row_isolation, 1e-6),
    "nan_behind_mask": (_case_nan_behind_mask, 1e-6),
    "empty_group_zero": (_case_empty_group_zero, 1e-6),
    "kahan_large_magnitude": (_case_kahan_large_magnitude, 1e-6),
}


def _exact(codes, mask, vals, g):
    sel = np.ones(len(codes), bool) if mask is None else mask
    sums = np.zeros((g, vals.shape[1]))
    mags = np.zeros((g, vals.shape[1]))
    for j in range(vals.shape[1]):
        np.add.at(sums[:, j], codes[sel], vals[sel, j])
        np.add.at(mags[:, j], codes[sel], np.abs(vals[sel, j]))
    return sums, mags, np.bincount(codes[sel], minlength=g)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_pallas_interpret(case):
    make, oracle_rtol = CASES[case]
    codes, mask, vals, g = make()
    want, want_counts = pallas_sums(codes, mask, vals, g, interpret=True)
    got, got_counts = segment_sums.masked_segment_sums(codes, mask, vals, g, device="cpu")
    exact, mags, exact_counts = _exact(codes, mask, vals, g)
    assert np.all(np.abs(got - want) <= 1e-6 * mags)
    np.testing.assert_array_equal(got_counts, want_counts)
    np.testing.assert_array_equal(got_counts, exact_counts)
    # the original test's own tolerance against the float64 oracle
    np.testing.assert_allclose(got, exact, rtol=oracle_rtol, atol=oracle_rtol)


def test_kahan_beats_naive_float32():
    # the case still shows the drift the compensation removes: a naive
    # float32 running sum of each group misses the bound the kernel holds
    codes, mask, vals, g = _case_kahan_large_magnitude()
    got, _ = segment_sums.masked_segment_sums(codes, mask, vals, g, device="cpu")
    exact, _, _ = _exact(codes, mask, vals, g)
    naive = np.array([np.cumsum(vals[codes == j, 0].astype(np.float32), dtype=np.float32)[-1]
                      for j in range(g)])
    assert np.max(np.abs(naive - exact[:, 0]) / exact[:, 0]) > 1e-6
    np.testing.assert_allclose(got, exact, rtol=1e-6)


def test_row_counts_only_in_own_group():
    # a NaN in a selected row poisons only its own group's sum, and a row
    # behind the mask contributes nothing even at the tensor level
    codes = torch.zeros((2048, 1), dtype=torch.int32)
    codes[1024:] = 1
    mask = torch.ones((2048, 1), dtype=torch.float32)
    mask[5] = 0
    vals = torch.ones((2048, 2), dtype=torch.float32)
    vals[5, 0] = float("nan")
    vals[2000, 1] = float("nan")
    out = segment_sums.masked_segment_sums_padded(codes, mask, vals, 16)
    assert out[0, 0].item() == 1023.0 and out[0, 1].item() == 1023.0
    assert out[1, 0].item() == 1024.0 and torch.isnan(out[1, 1])
    assert torch.all(out[2:] == 0)


def test_wrapper_checks_shapes_and_types():
    codes = torch.zeros((1024, 1), dtype=torch.int32)
    mask = torch.ones((1024, 1), dtype=torch.float32)
    vals = torch.ones((1024, 3), dtype=torch.float32)
    with pytest.raises(ValueError):
        segment_sums.masked_segment_sums_padded(codes.long(), mask, vals, 16)
    with pytest.raises(ValueError):
        segment_sums.masked_segment_sums_padded(codes[:1000], mask[:1000], vals[:1000], 16)
    with pytest.raises(ValueError):
        segment_sums.masked_segment_sums_padded(codes, mask, vals, 8192)
    before = (segment_sums.ENTRIES, segment_sums.LAUNCHES)
    segment_sums.masked_segment_sums_padded(codes, mask, vals, 16)
    # the CPU tensor took the plain version: an entry, no kernel launch
    assert (segment_sums.ENTRIES, segment_sums.LAUNCHES) == (before[0] + 1, before[1])


@pytest.mark.parametrize("n,g,k", [(8_388_608, 16, 7), (8_388_608, 16, 1),
                                   (1_048_576, 4096, 1), (1024, 16, 32), (67_108_864, 16, 7)])
def test_launch_shape_covers_every_block(n, g, k):
    threads, grid_x, bpc = segment_sums.launch_shape(n, g, k)
    nblocks = n // segment_sums.BLOCK_ROWS
    assert threads % 32 == 0 and 32 <= threads <= 256
    assert grid_x * bpc >= nblocks > (grid_x - 1) * bpc  # no CTA without a block
    assert grid_x * g * k <= 1 << 24  # scratch partials stay bounded


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    # no toolchain, no kernel: the build raises instead of falling back
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(segment_sums, "_LIB", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        segment_sums.build()


def test_builds_keep_their_own_logs(monkeypatch, tmp_path):
    # a stand-in nvcc that logs the source it compiles: each build reports its
    # own log, one source shares one run, and a library on disk is reused
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    fake = bindir / "nvcc"
    fake.write_text('#!/bin/bash\n[ "$1" = --version ] && { echo stand-in; exit 0; }\n'
                    'out=""; src=""\nwhile [ $# -gt 0 ]; do case "$1" in\n'
                    '  -o) out="$2"; shift 2;;\n  *.cu) src="$1"; shift;;\n  *) shift;;\n'
                    'esac; done\nread -r first < "$src"; echo "ptxas info: $first"\n: > "$out"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    a, b, a2 = (nvcc.start("// source a\n", "k"), nvcc.start("// source b\n", "k"),
                nvcc.start("// source a\n", "k"))
    assert a2 is a and a.so != b.so
    assert nvcc.finish(b) == b.so and b.so.exists()
    assert nvcc.finish(a) == a.so and nvcc.finish(a2) == a.so
    assert "source a" in a.log and "source b" not in a.log
    assert "source b" in b.log
    again = nvcc.start("// source a\n", "k")
    assert again is not a and again.done() and nvcc.finish(again) == a.so
    assert again.log is None  # nothing was built, so no log to report


# ---------------------------------------------------------------------------
# the order contract of pass 1's two loops
# ---------------------------------------------------------------------------

def _chain_walk(codes, mask, vals, g, grid_x, bpc):
    """Plain numpy float32 sums in the rows loop's order: per block and
    column, the block's rows in row order into code-indexed sums that start
    at +0.0 (a row adds only when its mask is set); then each span of bpc
    blocks Kahan-added in block order, then the spans in span order."""
    n, k = vals.shape
    nblk = n // segment_sums.BLOCK_ROWS
    c = codes.reshape(nblk, -1)
    on = mask.reshape(nblk, -1) != 0
    v = vals.reshape(nblk, -1, k).astype(np.float32)
    sums = np.zeros((nblk, g, k), np.float32)
    blocks = np.arange(nblk)
    with np.errstate(all="ignore"):
        for r in range(segment_sums.BLOCK_ROWS):
            b = blocks[on[:, r]]  # one row per block: no index repeats
            sums[b, c[b, r]] += v[b, r]

        def kahan(terms):
            acc = np.zeros((g, k), np.float32)
            comp = np.zeros((g, k), np.float32)
            for x in terms:
                y = x - comp
                t = acc + y
                comp = (t - acc) - y
                acc = t
            return acc, comp

        partials = []
        for x in range(grid_x):
            acc, comp = kahan(sums[x * bpc:min((x + 1) * bpc, nblk)])
            partials.append(acc - comp)
        return kahan(partials)[0]


def _edge_operands(case, nblk=1057, g=16, k=2, seed=21):
    """Seeded (codes, mask, vals) with one edge pattern. 1057 blocks is a
    span count that does not divide them: launch_shape gives 529 spans of 2."""
    rng = np.random.RandomState(seed)
    n = nblk * segment_sums.BLOCK_ROWS
    codes = rng.randint(0, 6, n).astype(np.int32)
    mask = (rng.rand(n) < 0.9).astype(np.float32)
    vals = (rng.rand(n, k) * 1e4 - 2e3).astype(np.float32)
    if case == "negative_zero":
        vals[rng.rand(n) < 0.3] = -0.0
        vals[codes == 5] = -0.0  # a group of -0.0 alone sums to +0.0
    elif case == "infinities":
        vals[rng.rand(n) < 1e-4, 0] = np.inf
        vals[rng.rand(n) < 1e-4, 0] = -np.inf
        vals[codes == 4, 1] = np.inf  # one column of one group only +inf
    elif case == "subnormals":
        vals = (rng.rand(n, k) * 1e-38 - 2e-39).astype(np.float32)
        vals[rng.rand(n) < 0.5, 0] = np.float32(1e-45)
    elif case == "nan_behind_mask":
        vals[mask == 0] = np.nan
    elif case == "all_masked_block":
        mask[5 * 1024:6 * 1024] = 0
        vals[5 * 1024:6 * 1024] = np.nan
    return codes, mask, vals, g


EDGE_CASES = ["negative_zero", "infinities", "subnormals", "nan_behind_mask",
              "all_masked_block", "spans_do_not_divide_blocks"]


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("case", EDGE_CASES)
def test_chain_order_equals_plain_version_bit_for_bit(case):
    codes, mask, vals, g = _edge_operands(case)
    n, k = vals.shape
    _threads, grid_x, bpc = segment_sums.launch_shape(n, g, k)
    assert grid_x * bpc > n // segment_sums.BLOCK_ROWS  # the last span is short
    want = segment_sums.masked_segment_sums_plain(
        torch.from_numpy(codes[:, None]), torch.from_numpy(mask[:, None]),
        torch.from_numpy(vals), g).numpy()
    got = _chain_walk(codes, mask, vals, g, grid_x, bpc)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if case == "infinities":
        # Kahan turns an infinite block sum into NaN (inf - inf in the compensation)
        assert not np.isfinite(want[4, 1]) and np.isfinite(want[:4, 1]).all()
    if case == "negative_zero":
        assert np.all(_bits(want[5]) == 0)  # +0.0, not -0.0


def test_pass1_loop_is_chosen_from_the_shapes_alone():
    assert list(inspect.signature(segment_sums.pass1_loop).parameters) == ["num_groups", "k"]
    for k in (1, 7, 32):
        assert segment_sums.pass1_loop(16, k) == segment_sums.LOOP_ROWS
        assert segment_sums.pass1_loop(4096, k) == segment_sums.LOOP_OUTPUTS
        # one crossover per k: rows up to some G, outputs above it
        loops = [segment_sums.pass1_loop(g, k) for g in range(1, segment_sums.MAX_GROUPS + 1)]
        top = loops.count(segment_sums.LOOP_ROWS)
        assert loops == [segment_sums.LOOP_ROWS] * top + [segment_sums.LOOP_OUTPUTS] * (len(loops) - top)
    # the main path's span partition (SF1 and SF10, Q1 and Q6) is unchanged,
    # and its rows-loop tiles fit the shared memory the launch takes
    assert segment_sums.launch_shape(8_388_608, 16, 7) == (128, 1024, 8)
    assert segment_sums.launch_shape(8_388_608, 16, 1) == (32, 1024, 8)
    assert segment_sums.launch_shape(67_108_864, 16, 7) == (128, 1041, 63)
    assert segment_sums.launch_shape(67_108_864, 16, 1) == (32, 1041, 63)
    for n in (8_388_608, 67_108_864):
        for k in (7, 1):
            threads, grid_x, bpc, loop, nb, t = segment_sums.pass1_args(n, 16, k)
            assert (grid_x, bpc) == segment_sums.launch_shape(n, 16, k)[1:]
            assert loop == segment_sums.LOOP_ROWS and nb * k <= threads
            assert t % 32 == 0 and segment_sums.BLOCK_ROWS % t == 0 and nb * t <= 1024
            assert segment_sums._row_smem_bytes(16, k, nb, t) <= segment_sums._ROW_SMEM_BYTES


# ---------------------------------------------------------------------------
# pass 1's CUDA source, run on the host: csrc/segment_sums_common.cuh and
# K1's fill step built with g++ under a shim that runs each CTA as one host
# thread per CUDA thread with a barrier for __syncthreads. It checks the
# loops' indexing and order of additions here; the card runs the real thing
# (chip_smoke.py phase 2).
# ---------------------------------------------------------------------------

_EMU_SHIM = r"""
#include <string.h>
#include <algorithm>
#include <barrier>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint4 {
  unsigned x, y, z, w;
};
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
using std::min;
thread_local dim3 threadIdx;
dim3 blockIdx, blockDim;
std::barrier<>* emu_barrier;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
float smem[1 << 14];
"""

_EMU_LAUNCHER = r"""
extern "C" int emu_sums(const int* codes, void* const* cols, float* partials, float* out,
                        long long n, long long n_real, int k, int g, int threads, int grid_x,
                        long long bpc, int loop, int nb, int t) {
  FILL_INIT
  const int gk = g * k;
  const int tiles_y = loop == SS_LOOP_ROWS ? 1
      : (gk + threads * OUTS_PER_THREAD - 1) / (threads * OUTS_PER_THREAD);
  if (loop == SS_LOOP_ROWS && ss_rows_smem_floats(g, k, nb, t) > (1 << 14)) return 1;
  blockDim = dim3(threads);
  for (int x = 0; x < grid_x; ++x) {
    for (int y = 0; y < tiles_y; ++y) {
      blockIdx = dim3(x, y);
      std::barrier<> bar(threads);
      emu_barrier = &bar;
      std::vector<std::thread> team;
      for (int i = 0; i < threads; ++i) {
        team.emplace_back([=] {
          threadIdx = dim3(i);
          if (loop == SS_LOOP_ROWS) ss_pass1_rows(codes, fill, partials, n, k, g, bpc, nb, t);
          else ss_pass1_outputs(codes, fill, partials, n, k, g, bpc);
        });
      }
      for (auto& th : team) th.join();
    }
  }
  blockDim = dim3(256);
  for (int b = 0; b < (gk + 255) / 256; ++b) {
    blockIdx = dim3(b);
    for (int i = 0; i < 256; ++i) {
      threadIdx = dim3(i);
      ss_pass2(partials, out, grid_x, gk);
    }
  }
  return 0;
}
"""


def _common_header() -> str:
    """segment_sums_common.cuh without its include and its launcher (which
    needs nvcc's <<<>>>)."""
    header = (nvcc.CSRC / "segment_sums_common.cuh").read_text()
    return header.split("#include <cuda_runtime.h>")[1].split("// Launch both passes")[0]


@pytest.fixture(scope="module")
def emulate_pass1(tmp_path_factory):
    """build(fill_source, fill_init) -> run(codes, cols, n_real, k, g, launch):
    pass 1 and 2 of the header with the given fill step, on the host."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.fail("g++ is needed to run pass 1's source on the host")
    tmp = tmp_path_factory.mktemp("emu_pass1")

    def build(fill_source: str, fill_init: str):
        i = len(list(tmp.iterdir()))
        src, so = tmp / f"emu{i}.cpp", tmp / f"emu{i}.so"
        src.write_text(_EMU_SHIM + _common_header() + fill_source
                       + _EMU_LAUNCHER.replace("FILL_INIT", fill_init))
        res = subprocess.run([gxx, "-O2", "-ffp-contract=off", "-std=c++20", "-pthread",
                              "-shared", "-fPIC", "-o", str(so), str(src)],
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        lib = ctypes.CDLL(str(so))
        lib.emu_sums.argtypes = ([ctypes.c_void_p] * 4
                                 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int])
        lib.emu_sums.restype = ctypes.c_int

        def run(codes, cols, n_real, k, g, launch, unaligned=False):
            threads, grid_x, bpc, loop, nb, t = launch
            codes = np.ascontiguousarray(codes, np.int32)
            cols = [np.ascontiguousarray(c) for c in cols]
            if unaligned:  # 4 bytes past a 16-byte boundary: the scalar copy
                codes, cols = _shifted(codes), [_shifted(c) for c in cols]
            ptrs = (ctypes.c_void_p * len(cols))(*[c.ctypes.data for c in cols])
            partials = np.zeros(grid_x * g * k, np.float32)
            out = np.zeros((g, k), np.float32)
            assert lib.emu_sums(codes.ctypes.data, ptrs, partials.ctypes.data, out.ctypes.data,
                                len(codes), n_real, k, g, threads, grid_x, bpc, loop, nb,
                                t) == 0
            return out

        return run

    return build


def _shifted(a):
    """A copy of ``a`` that starts 4 bytes past a 16-byte boundary."""
    buf = np.zeros(a.nbytes + 32, np.uint8)
    start = (-buf.ctypes.data) % 16 + 4
    out = buf[start:start + a.nbytes].view(a.dtype).reshape(a.shape)
    out[...] = a
    return out


def _k1_fill() -> str:
    k1 = (nvcc.CSRC / "masked_segment_sums.cu").read_text()
    return "struct MssFill" + k1.split("struct MssFill")[1].split('extern "C"')[0]


# (blocks, G, K, launch) with launch None for pass1_args, else (threads,
# grid_x, blocks_per_cta, loop, nb, t) chosen to give several block groups
# per span, a short last group and a short last span
EMU_CASES = {
    "rows_main_path_k7": (8, 16, 7, None),
    "rows_main_path_k1": (4, 16, 1, None),
    "rows_short_groups_and_span": (7, 16, 3, (256, 3, 3, 1, 2, 256)),
    "rows_largest_g": (2, 53, 7, None),
    "rows_unaligned_operands": (3, 16, 7, None),
    "outputs_smallest_g": (2, 54, 7, None),
    "outputs_g4096": (2, 4096, 1, None),
}


@pytest.mark.parametrize("case", list(EMU_CASES))
def test_cuda_pass1_run_on_host_equals_chain_order(case, emulate_pass1):
    nblk, g, k, launch = EMU_CASES[case]
    rng = np.random.RandomState(nblk * g + k)
    n = nblk * segment_sums.BLOCK_ROWS
    codes = rng.randint(0, g, n).astype(np.int32)
    mask = (rng.rand(n) < 0.8).astype(np.float32)
    vals = (rng.rand(n, k) * 1e4 - 2e3).astype(np.float32)
    vals[rng.rand(n) < 0.05] = -0.0
    vals[mask == 0, 0] = np.nan  # NaN behind the mask
    vals[rng.rand(n) < 0.01, k - 1] = np.float32(3e-41)  # subnormal
    mask[1024:2048] = 0  # an all-masked block
    if launch is None:
        launch = segment_sums.pass1_args(n, g, k)
        want = segment_sums.masked_segment_sums_plain(
            torch.from_numpy(codes[:, None]), torch.from_numpy(mask[:, None]),
            torch.from_numpy(vals), g).numpy()
    else:
        want = _chain_walk(codes, mask, vals, g, launch[1], launch[2])
    expect_loop = (segment_sums.LOOP_OUTPUTS if case.startswith("outputs")
                   else segment_sums.LOOP_ROWS)
    assert launch[3] == expect_loop
    run = emulate_pass1(_k1_fill(), "const MssFill fill{static_cast<const float*>(cols[0]), "
                                    "static_cast<const float*>(cols[1]), k};")
    got = run(codes, [mask, vals], n, k, g, launch, unaligned=case.endswith("unaligned_operands"))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("g", [16, 200])
def test_k2_fill_run_on_host_equals_composed_route(g, emulate_pass1):
    # K2's generated fill step (predicate, masking, derived columns, padding
    # rows) under both loops: equal to its plain version, the composed route
    from daft_tpu_torch import DataType, Field, Schema, col
    from daft_tpu_torch.kernels import fused_expr_sums as fes
    from daft_tpu_torch.kernels.device import normalize_and_check

    schema = Schema([Field("x", DataType.float64()), Field("y", DataType.float64()),
                     Field("d", DataType.int64())])
    pred, = normalize_and_check([col("d") < 60], schema)
    kids = normalize_and_check([col("x") * (1 - col("y")), col("x") * (1 - col("y")) * (1 + col("y")),
                                col("x") / col("y")], schema)
    prog = fes.FusedExprSums(pred, kids, schema, {"x": torch.float32, "y": torch.float32,
                                                  "d": torch.int32})
    rng = np.random.RandomState(g)
    b, n = 6 * segment_sums.BLOCK_ROWS, 6 * segment_sums.BLOCK_ROWS - 77
    x = (rng.rand(b) * 1000 + 1).astype(np.float32)
    d = rng.randint(0, 100, b).astype(np.int32)
    x[d >= 60] = np.nan  # NaN behind the predicate
    env = {"x": x, "y": (rng.rand(b) * 0.1).astype(np.float32), "d": d}
    env = {nm: (torch.from_numpy(v), torch.from_numpy(rng.rand(b) > 0.1)) for nm, v in env.items()}
    codes = torch.from_numpy(rng.randint(0, g, b).astype(np.int32))
    want = prog.plain(codes, env, n, g).numpy()
    launch = segment_sums.pass1_args(b, g, prog.k)
    assert launch[3] == (segment_sums.LOOP_ROWS if g == 16 else segment_sums.LOOP_OUTPUTS)
    source = prog.source.split('#include "segment_sums_common.cuh"')[1].split('extern "C" {')[0]
    init = ("FesFill fill;\n" + fes._bind_cols(prog.names, prog.dtypes, "fill.c")
            + "  fill.n = n_real;\n  fill.c0 = 0;\n  fill.kc = k;\n")
    cols = [t.numpy() for nm in prog.names for t in env[nm]]
    got = emulate_pass1(source, init)(codes.numpy(), cols, n, prog.k, g, launch)
    np.testing.assert_array_equal(_bits(got), _bits(want))
