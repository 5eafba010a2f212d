"""The scatter-sums kernel's CUDA source (csrc/segment_scatter_sums.cu), run
on the host: pass 1 and pass 2 built with g++ under a shim that runs each
CTA as one host thread per CUDA thread, with a barrier for __syncthreads and
one per warp for __syncwarp and the warp intrinsics (__match_any_sync,
__shfl_sync, __shfl_up_sync, __ballot_sync exchange each lane's value through
that warp's slots between two barriers; every intrinsic in the source runs
with all 32 lanes, which the shim relies on).

It checks pass 1's bucketing (count, scan, scatter, walk) and its order of
additions here: the result must equal the plain version,
scatter_sums.scatter_sum_kahan_plain, bit for bit. The card runs the real
thing (chip_smoke.py phases 2 and 3).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from daft_tpu_torch.kernels import nvcc, scatter_sums

_SHIM = r"""
#include <string.h>
#include <algorithm>
#include <barrier>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(x)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct int4 {
  int x, y, z, w;
};
struct float4 {
  float x, y, z, w;
};
thread_local dim3 threadIdx;
dim3 blockIdx, blockDim;
std::barrier<>* emu_barrier;
std::barrier<>* emu_warp_barrier[32];
long long emu_lanes[32][32];  // [warp][lane]: the values a warp exchanges
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_warp_barrier[threadIdx.x >> 5]->arrive_and_wait();
}
// every lane of the warp publishes v; f reads the 32 values once all have
template <class F>
inline auto emu_exchange(long long v, F f) {
  long long* lanes = emu_lanes[threadIdx.x >> 5];
  lanes[threadIdx.x & 31] = v;
  __syncwarp();
  const auto r = f(lanes);
  __syncwarp();  // every lane has read before the slots are reused
  return r;
}
inline unsigned __match_any_sync(unsigned, int v) {
  return emu_exchange(v, [v](const long long* a) {
    unsigned m = 0;
    for (int i = 0; i < 32; ++i) m |= (a[i] == v ? 1u : 0u) << i;
    return m;
  });
}
inline unsigned __ballot_sync(unsigned, int p) {
  return emu_exchange(p != 0, [](const long long* a) {
    unsigned m = 0;
    for (int i = 0; i < 32; ++i) m |= (a[i] ? 1u : 0u) << i;
    return m;
  });
}
inline int __shfl_sync(unsigned, int v, int src) {
  return static_cast<int>(emu_exchange(v, [src](const long long* a) { return a[src & 31]; }));
}
inline int __shfl_up_sync(unsigned, int v, unsigned d) {
  const int l = threadIdx.x & 31;
  return static_cast<int>(emu_exchange(v, [l, d](const long long* a) {
    return l >= static_cast<int>(d) ? a[l - d] : a[l];
  }));
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
int4 smem4[(8192 * 16 + 16384) / 16];
"""

_LAUNCHER = r"""
extern "C" int emu_scatter(const float* vals, const int* codes, float* partials, float* out,
                           long long b, int chunk, int g, int s_log2) {
  if (pass1_smem_bytes(chunk) > sizeof(smem4) || chunk % 128 != 0) return 1;
  const int nch = static_cast<int>(b / chunk);
  blockDim = dim3(kPass1Threads);
  for (int x = 0; x < nch; ++x) {
    for (int y = 0; y < (1 << s_log2); ++y) {
      blockIdx = dim3(x, y);
      std::barrier<> bar(kPass1Threads);
      emu_barrier = &bar;
      std::vector<std::unique_ptr<std::barrier<>>> warps;
      for (int w = 0; w < kWarps; ++w) {
        warps.emplace_back(new std::barrier<>(32));
        emu_warp_barrier[w] = warps.back().get();
      }
      std::vector<std::thread> team;
      for (int i = 0; i < kPass1Threads; ++i) {
        team.emplace_back([=] {
          threadIdx = dim3(i);
          scatter_pass1(vals, codes, partials, chunk, g, s_log2);
        });
      }
      for (auto& th : team) th.join();
    }
  }
  blockDim = dim3(kPass2Threads);
  for (int blk = 0; blk < (g + kPass2Threads - 1) / kPass2Threads; ++blk) {
    blockIdx = dim3(blk);
    for (int i = 0; i < kPass2Threads; ++i) {
      threadIdx = dim3(i);
      scatter_pass2(partials, out, nch, g);
    }
  }
  return 0;
}
"""


def _kernel_source() -> str:
    """The .cu's two passes, without its include, its anonymous namespace
    (so its ``extern __shared__`` array is the shim's) and its C launcher
    (which needs nvcc's <<<>>>)."""
    src = (nvcc.CSRC / "segment_scatter_sums.cu").read_text()
    body = src.split("#include <cuda_runtime.h>")[1].split('extern "C" {')[0]
    return body.replace("namespace {", "").replace("}  // namespace", "")


@pytest.fixture(scope="module")
def emulate(tmp_path_factory):
    """run(vals, codes, g, s_log2) -> the (G,) sums of the kernel's source."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.fail("g++ is needed to run the kernel's source on the host")
    tmp = tmp_path_factory.mktemp("emu_scatter")
    src, so = tmp / "emu.cpp", tmp / "emu.so"
    src.write_text(_SHIM + _kernel_source() + _LAUNCHER)
    res = subprocess.run([gxx, "-O2", "-ffp-contract=off", "-std=c++20", "-pthread",
                          "-shared", "-fPIC", "-o", str(so), str(src)],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(so))
    lib.emu_scatter.argtypes = ([ctypes.c_void_p] * 4
                                + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int])
    lib.emu_scatter.restype = ctypes.c_int

    def run(vals, codes, g, s_log2):
        b = len(vals)
        chunk = scatter_sums.chunk_rows(b)
        vals = np.ascontiguousarray(vals, np.float32)
        codes = np.ascontiguousarray(codes, np.int32)
        # NaN in every slot: a slot pass 1 does not zero shows in the result
        partials = np.full((b // chunk) * g, np.nan, np.float32)
        out = np.zeros(g, np.float32)
        assert lib.emu_scatter(vals.ctypes.data, codes.ctypes.data, partials.ctypes.data,
                               out.ctypes.data, b, chunk, g, s_log2) == 0
        return out

    return run


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.int32)


# (rows b, segments G, log2 of the CTAs per chunk S, codes): S = 1, 2 and 4,
# G above R = 32 S and below it (some owners hold no segment), one chunk and two
CASES = {
    "b4096_g100_s4_fewer_segments_than_owners": (4096, 100, 2, "random"),
    "b1024_g4097_s1_random": (1024, 4097, 0, "random"),
    "b8192_g4097_s4_random": (8192, 4097, 2, "random"),
    "b16384_g20000_s1_random": (16_384, 20_000, 0, "random"),
    "b16384_g4097_s4_sorted": (16_384, 4097, 2, "sorted"),
    "b8192_g20000_s4_few_codes": (8192, 20_000, 2, "few"),
    "b2048_g4097_s4_out_of_range": (2048, 4097, 2, "out_of_range"),
    "b8192_g5000_s1_zero_rows": (8192, 5000, 0, "zero_rows"),
    "b4096_g4097_s2_one_owner": (4096, 4097, 1, "one_owner"),
}


def _operands(b, g, kind, seed):
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, g, b).astype(np.int32)
    vals = (rng.rand(b) * 2e4 - 5e3).astype(np.float32)
    vals[rng.rand(b) < 0.2] = 0.0
    vals[rng.rand(b) < 0.05] = -0.0
    if kind == "sorted":
        codes.sort()
    elif kind == "few":  # long chains: many equal codes within a step
        codes = rng.randint(0, 7, b).astype(np.int32) * 3001
    elif kind == "out_of_range":  # codes outside [0, G) add nowhere
        bad = rng.rand(b) < 0.3
        codes[bad] = rng.choice([-1, -5000, g, g + 31, 1 << 30], bad.sum())
    elif kind == "zero_rows":  # every row +-0.0: every sum is +0.0
        vals[:] = np.where(rng.rand(b) < 0.5, 0.0, -0.0).astype(np.float32)
    elif kind == "one_owner":  # every row one owner's: one bucket takes the chunk
        codes = (rng.randint(0, g // 64, b) * 64 + 5).astype(np.int32)
    return codes, vals


@pytest.mark.parametrize("case", list(CASES))
def test_pass1_run_on_host_equals_plain_version(case, emulate):
    b, g, s_log2, kind = CASES[case]
    codes, vals = _operands(b, g, kind, seed=b + g + s_log2)
    want = scatter_sums.scatter_sum_kahan_plain(torch.from_numpy(vals),
                                                torch.from_numpy(codes), g).numpy()
    got = emulate(vals, codes, g, s_log2)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if kind == "zero_rows":
        assert (_bits(got) == 0).all()
    # S changes who adds, not the order of the additions
    np.testing.assert_array_equal(_bits(emulate(vals, codes, g, 0 if s_log2 else 1)),
                                  _bits(want))
