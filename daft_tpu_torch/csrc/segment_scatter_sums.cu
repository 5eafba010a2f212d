// Deterministic scatter sums for Hopper (sm_90a): the float-sum branch of the
// masked segment reductions above 4096 segments. Plain C interface, loaded
// with ctypes by daft_tpu_torch/kernels/scatter_sums.py, which also holds the
// plain version this kernel is checked against.
//
// It computes exactly what the reference's `_scatter_sum_kahan`
// (daft_tpu/kernels/device.py, an XLA scatter, not a Pallas kernel) computes
// in its 32-bit mode: the b padded rows (masked rows already 0.0) split into
// chunks of `chunk` rows; for chunk c and segment g, partials[c][g] is the
// sum of the chunk's rows with code g, added in row order starting at +0.0;
// then out[g] Kahan-adds partials[0..nch)[g] in chunk order with the
// operations of `_kahan_combine` (y = p - comp; t = s + y; comp = (t - s) - y;
// s = t). torch's CUDA index_add_ on float32 adds with atomics, in an order
// that changes from run to run; this kernel uses no float atomics, so two
// launches give the same bits.
//
//   pass 1: grid (nch, S). CTA (c, y) stages chunk c's codes and values in
//           shared memory (64 KB at 8192 rows), rows of value +-0.0 left
//           out (see the staging loop: that changes no bit). Its 32 warps
//           are owners W = 32 y + w of R = 32 S; owner W holds the segments g with
//           g % R == W. The CTA zeroes its owners' slots of partials[c];
//           then each warp walks the chunk 32 rows a step: a ballot finds
//           the lanes whose code it owns (most steps none), lanes with equal
//           codes are grouped (__match_any_sync), and the lowest lane of a
//           group loads partials[c][g], adds the group's values in lane
//           (= row) order and stores it back; __syncwarp orders that store
//           before the warp's next step (four steps' loads and ballots come
//           first, then their adds). So each (c, g) sum is one chain in row order,
//           written by one warp, and no two warps touch one address. S
//           spreads a chunk over several CTAs when there are few chunks (the
//           SF1 Q3 aggregate has 4); S changes who adds, not the order of the
//           additions, so the bits do not depend on it.
//           Rows whose code is outside [0, G) are skipped.
//   pass 2: one thread per segment runs the Kahan walk over the chunks.
//
// Bound on an H100: the bytes the function must move, b * 8 (codes and
// values read once) + G * 4 (out written once); at b = 262,144 rows and
// G = 148,152 that is about 2.7 MB, 0.8 us at 3.35 TB/s. What the design
// adds: the partials (nch * G * 4 bytes written, then read again: about
// 38 MB at that shape), every CTA of a chunk reading the chunk (S times in
// all, from L2 after the first), and a warp's walk, which is
// serial (chunk / 32 steps, each a shared-memory load and a ballot; a step
// with an owned row waits on a load of partials from L2, and a group of equal
// codes adds its values one after another). Build with
// -fmad=false (kernels/nvcc.py): no multiply here, but the flag keeps every
// kernel of the port under one rule.

#include <cuda_runtime.h>

namespace {

constexpr int kPass1Threads = 1024;
constexpr int kWarps = kPass1Threads / 32;
constexpr int kPass2Threads = 256;
constexpr int kMaxChunk = 8192;  // scatter_sums.CHUNK_ROWS
constexpr int kMaxDevices = 64;

// per device: the pass-1 shared-memory limit has been raised to kMaxChunk
// rows (a race between two first launches sets the same value twice)
bool g_smem_set[kMaxDevices];

__global__ void __launch_bounds__(kPass1Threads)
scatter_pass1(const float* __restrict__ vals, const int* __restrict__ codes,
              float* __restrict__ partials, int chunk, int g, int s_log2) {
  extern __shared__ int4 smem4[];
  int* s_codes = reinterpret_cast<int*>(smem4);
  float* s_vals = reinterpret_cast<float*>(s_codes + chunk);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long owners = 32LL << s_log2;  // R, a power of two
  const unsigned owner_mask = static_cast<unsigned>(owners - 1);
  const unsigned owner = blockIdx.y * 32u + static_cast<unsigned>(warp);
  const long long row0 = static_cast<long long>(blockIdx.x) * chunk;
  float* part = partials + static_cast<long long>(blockIdx.x) * g;

  // stage the chunk, four rows a thread per load, coalesced. A row whose
  // value is +-0.0 stages with code -1 and so joins no chain: every chain
  // starts at +0.0 and round-to-nearest gives -0.0 only as (-0.0) + (-0.0),
  // so no chain is ever -0.0, and adding +-0.0 to it changes no bit. The
  // masked rows and the padding of a size bucket (all of one code) drop out.
  const int4* c4 = reinterpret_cast<const int4*>(codes + row0);
  const float4* v4 = reinterpret_cast<const float4*>(vals + row0);
  for (int i = tid; i < chunk / 4; i += kPass1Threads) {
    int4 c = c4[i];
    const float4 v = v4[i];
    c.x = v.x == 0.0f ? -1 : c.x;
    c.y = v.y == 0.0f ? -1 : c.y;
    c.z = v.z == 0.0f ? -1 : c.z;
    c.w = v.w == 0.0f ? -1 : c.w;
    reinterpret_cast<int4*>(s_codes)[i] = c;
    reinterpret_cast<float4*>(s_vals)[i] = v;
  }
  // this CTA's slots start at +0.0: in each period of R segments, the 32
  // consecutive ones of owners 32 y .. 32 y + 31 (one warp per period)
  for (long long q = warp; q * owners < g; q += kWarps) {
    const long long s = q * owners + blockIdx.y * 32LL + lane;
    if (s < g) part[s] = 0.0f;
  }
  __syncthreads();  // the zeros are visible to every warp of the CTA

  // the walk, four steps of 32 rows at a time: the four code loads and
  // ballots first, then the owned rows of each step in step (= row) order
  const unsigned ug = static_cast<unsigned>(g);
  for (int base = 0; base < chunk; base += 4 * 32) {
    int cd[4];
    bool ow[4];
    unsigned own[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) cd[j] = s_codes[base + 32 * j + lane];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned uc = static_cast<unsigned>(cd[j]);
      ow[j] = uc < ug && (uc & owner_mask) == owner;
      own[j] = __ballot_sync(0xffffffffu, ow[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (own[j] == 0u) continue;
      if (ow[j]) {
        const unsigned peers = __match_any_sync(own[j], cd[j]);
        if (lane == __ffs(peers) - 1) {
          const int row = base + 32 * j;
          float p = part[cd[j]];
          for (unsigned m = peers; m != 0u; m &= m - 1u) p = p + s_vals[row + __ffs(m) - 1];
          part[cd[j]] = p;
        }
      }
      __syncwarp();  // this step's stores before the next step's loads
    }
  }
}

__global__ void __launch_bounds__(kPass2Threads)
scatter_pass2(const float* __restrict__ partials, float* __restrict__ out, int nch, int g) {
  const long long s = static_cast<long long>(blockIdx.x) * kPass2Threads + threadIdx.x;
  if (s >= g) return;
  float sum = 0.0f;
  float comp = 0.0f;
  for (int c = 0; c < nch; ++c) {
    const float p = partials[static_cast<long long>(c) * g + s];
    const float y = p - comp;
    const float t = sum + y;
    comp = (t - sum) - y;
    sum = t;
  }
  out[s] = sum;
}

}  // namespace

extern "C" {

// vals [b] float32 (masked rows 0.0), codes [b] int32, partials [nch, g]
// float32 scratch, out [g] float32, vals and codes 16-byte aligned. chunk is
// a multiple of 128 that divides b (nch = b / chunk), at most 8192 rows
// (64 KB of shared memory). Each chunk spreads over 2^s_log2 CTAs
// (0 <= s_log2 <= 5). Launches both passes on `stream`, does not
// synchronise, and returns the first nonzero CUDA error (0 when both
// launches were accepted). The first launch on a device raises pass 1's
// shared-memory limit to 64 KB; later ones only launch.
int segment_scatter_sums_f32(const void* vals, const void* codes, void* partials, void* out,
                             long long b, int chunk, int g, int s_log2, void* stream) {
  if (chunk > kMaxChunk || s_log2 < 0 || s_log2 > 5)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nch = static_cast<int>(b / chunk);
  const size_t smem = static_cast<size_t>(chunk) * 8;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!g_smem_set[dev]) {
    err = cudaFuncSetAttribute(scatter_pass1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxChunk * 8);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_smem_set[dev] = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid1(static_cast<unsigned>(nch), 1u << s_log2);
  scatter_pass1<<<grid1, kPass1Threads, smem, st>>>(static_cast<const float*>(vals),
                                                    static_cast<const int*>(codes),
                                                    static_cast<float*>(partials), chunk, g,
                                                    s_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (g + kPass2Threads - 1) / kPass2Threads;
  scatter_pass2<<<blocks, kPass2Threads, 0, st>>>(static_cast<const float*>(partials),
                                                  static_cast<float*>(out), nch, g);
  return static_cast<int>(cudaGetLastError());
}

const char* segment_scatter_sums_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
