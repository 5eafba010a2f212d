// Deterministic scatter sums for Hopper (sm_90a): the float-sum branch of the
// masked segment reductions above 4096 segments. Plain C interface, loaded
// with ctypes by daft_tpu_torch/kernels/scatter_sums.py, which also holds the
// plain version this kernel is checked against.
//
// It computes exactly what the reference's `_scatter_sum_kahan`
// (daft_tpu/kernels/device.py, an XLA scatter, not a Pallas kernel) computes:
// the b padded rows (masked rows already 0.0) split into chunks of `chunk`
// rows; for chunk c and segment g, partials[c][g] is the sum of the chunk's
// rows with code g, added in row order starting at +0.0; then out[g]
// Kahan-adds partials[0..nch)[g] in chunk order with the operations of
// `_kahan_combine` (y = p - comp; t = s + y; comp = (t - s) - y; s = t).
// Both passes are templates on the value type T: float for the reference's
// 32-bit mode (segment_scatter_sums_f32), double for its 64-bit mode
// (segment_scatter_sums_f64), with every addition in T. torch's CUDA
// index_add_ adds with atomics, in an order that changes from run to run;
// this kernel uses no float atomics, so two launches give the same bits.
//
//   pass 1: grid (nch, S). CTA (c, y) serves chunk c for the owners
//           W = 32 y + w (w its warp) of R = 32 S; owner W holds the segments
//           g with g % R == W, so a code's owner is a function of the code:
//           lanes with equal codes always have equal owners. The CTA stages
//           chunk c's codes and values in shared memory (rows of value +-0.0
//           left out, see the staging loop: that changes no bit) and zeroes
//           its owners' slots of partials[c]. Then it buckets the rows it
//           owns by owner, stably, in shared memory:
//             count:   warp w takes slice w, the w-th run of chunk / 32
//                      rows; per step of 32 rows, lanes with one local owner
//                      o = (code % R) - 32 y are grouped (__match_any_sync)
//                      and the group's lowest lane adds its size (__popc) to
//                      the (owner o, slice w) entry of a 32 x 32 table;
//             scan:    an exclusive scan of the table in (owner-major,
//                      slice-minor) order, one entry per thread, gives each
//                      (owner, slice) its offset in the bucket;
//             scatter: each warp walks its slice again; an owned row goes to
//                      its (owner, slice) offset + the rows of that owner
//                      the slice has placed before + its rank among the
//                      step's lanes of that owner (popc of the peers below).
//           So owner o's bucket holds its rows in row order. Last, warp o
//           walks only its own bucket, 32 rows a step: lanes with equal codes
//           are grouped, and the lowest lane of a group loads
//           partials[c][g], adds the group's values in lane (= row) order
//           and stores it back; __syncwarp orders that store before the
//           warp's next step. So each (c, g) sum is one chain in row order,
//           written by one warp, and no two warps touch one address. S
//           spreads a chunk over several CTAs when there are few chunks (the
//           SF1 Q3 aggregate has 4); S changes who adds, not the order of the
//           additions, so the bits do not depend on it. Rows whose code is
//           outside [0, G) belong to no owner and add nowhere. Every warp
//           intrinsic runs with all 32 lanes (tests/
//           test_torch_scatter_pass1_host.py runs both passes on the host
//           under a shim that relies on it).
//   pass 2: one thread per segment runs the Kahan walk over the chunks.
//
// Bound on an H100: the bytes the function must move, b * (4 + sizeof(T))
// (codes and values read once) + G * sizeof(T) (out written once); in
// float32 at b = 262,144 rows and G = 148,152 that is about 2.7 MB, 0.8 us
// at 3.35 TB/s. What the design adds: the partials (nch * G * sizeof(T)
// bytes written, then read again: about 38 MB at that shape in float32), every CTA of a chunk staging the chunk (S times in
// all, from L2 after the first), the count and scatter steps (chunk / 1024
// steps of each per warp, shared memory only), and the walk, which is
// serial within an owner (a step waits on a load of partials from L2, and
// a group of equal codes adds its values one after another). Build with
// -fmad=false (kernels/nvcc.py): no multiply here, but the flag keeps every
// kernel of the port under one rule.

#include <cuda_runtime.h>

namespace {

constexpr int kPass1Threads = 1024;
constexpr int kWarps = kPass1Threads / 32;
constexpr int kPass2Threads = 256;
constexpr int kMaxChunk = 8192;  // scatter_sums.CHUNK_ROWS
constexpr int kMaxDevices = 64;
constexpr unsigned kAll = 0xffffffffu;

// the (owner, slice) table's row stride: 33 words, so the entries of one
// slice (a warp's count and scatter steps) and of one owner (the scan) both
// fall in 32 different banks
constexpr int kTableStride = kWarps + 1;

// pass 1's shared memory for values of type T: the staged chunk (codes and
// values of `chunk` rows), the bucket (the same, plus one slot of padding
// per owner), the (owner, slice) table, the owners' bucket bounds and the
// scan's warp totals. 16 bytes a row in float (132 KB at 8192 rows), 24 in
// double (196 KB plus the bucket's padding and the tables, about 201 KB),
// both under the H100's 227 KB opt-in. Every array starts on a multiple of
// its element size: chunk is a multiple of 128 and kWarps is 32.
template <typename T>
__host__ __device__ constexpr size_t pass1_smem_bytes(int chunk) {
  return static_cast<size_t>(chunk) * (4 + sizeof(T)) +
         (static_cast<size_t>(chunk) + kWarps) * (4 + sizeof(T)) +
         (kWarps * kTableStride + (kWarps + 1) + kWarps) * 4;
}

// per value type and device: the pass-1 shared-memory limit of that
// instantiation has been raised to pass1_smem_bytes<T>(kMaxChunk) (a race
// between two first launches sets the same value twice)
template <typename T>
struct SmemSet {
  static bool done[kMaxDevices];
};
template <typename T>
bool SmemSet<T>::done[kMaxDevices];

// the local owner (0..31) of a staged code in CTA row y, or -1 when the code
// is outside [0, G) (the +-0.0 rows' -1 included) or another CTA owns it
__device__ __forceinline__ int local_owner(int cd, unsigned ug, unsigned owner_mask,
                                           unsigned y) {
  const unsigned uc = static_cast<unsigned>(cd);
  return uc < ug && ((uc & owner_mask) >> 5) == y ? static_cast<int>(uc & 31u) : -1;
}

// four rows of values, loaded at once: one float4, or two double2
template <typename T>
struct Four;
template <>
struct Four<float> {
  float v[4];
  __device__ __forceinline__ static Four load(const float* p, int i) {
    const float4 x = reinterpret_cast<const float4*>(p)[i];
    return Four{{x.x, x.y, x.z, x.w}};
  }
  __device__ __forceinline__ void store(float* p, int i) const {
    reinterpret_cast<float4*>(p)[i] = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Four<double> {
  double v[4];
  __device__ __forceinline__ static Four load(const double* p, int i) {
    const double2 a = reinterpret_cast<const double2*>(p)[2 * i];
    const double2 b = reinterpret_cast<const double2*>(p)[2 * i + 1];
    return Four{{a.x, a.y, b.x, b.y}};
  }
  __device__ __forceinline__ void store(double* p, int i) const {
    reinterpret_cast<double2*>(p)[2 * i] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[2 * i + 1] = make_double2(v[2], v[3]);
  }
};

template <typename T>
__global__ void __launch_bounds__(kPass1Threads)
scatter_pass1(const T* __restrict__ vals, const int* __restrict__ codes,
              T* __restrict__ partials, int chunk, int g, int s_log2) {
  extern __shared__ int4 smem4[];
  int* s_codes = reinterpret_cast<int*>(smem4);
  T* s_vals = reinterpret_cast<T*>(s_codes + chunk);
  int* b_codes = reinterpret_cast<int*>(s_vals + chunk);
  T* b_vals = reinterpret_cast<T*>(b_codes + chunk + kWarps);
  int* s_table = reinterpret_cast<int*>(b_vals + chunk + kWarps);  // [owner][slice]
  // owner o's bucket is [s_bound[o], s_bound[o + 1] - 1): owner o's rows
  // start o words further on, so with codes in order, where each slice's
  // rows of every owner start near o times a whole number of banks, the
  // lanes of one scatter step still write 32 different banks
  int* s_bound = s_table + kWarps * kTableStride;
  int* s_wsum = s_bound + kWarps + 1;  // the scan's warp totals
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long owners = 32LL << s_log2;  // R, a power of two
  const unsigned owner_mask = static_cast<unsigned>(owners - 1);
  const unsigned ug = static_cast<unsigned>(g);
  const unsigned y = blockIdx.y;
  const long long row0 = static_cast<long long>(blockIdx.x) * chunk;
  T* part = partials + static_cast<long long>(blockIdx.x) * g;

  // stage the chunk, four rows a thread per load, coalesced. A row whose
  // value is +-0.0 stages with code -1 and so joins no chain: every chain
  // starts at +0.0 and round-to-nearest gives -0.0 only as (-0.0) + (-0.0),
  // in float and in double alike, so no chain is ever -0.0, and adding
  // +-0.0 to it changes no bit. The masked rows and the padding of a size
  // bucket (all of one code) drop out.
  const int4* c4 = reinterpret_cast<const int4*>(codes + row0);
  const T* v0 = vals + row0;
  for (int i = tid; i < chunk / 4; i += kPass1Threads) {
    int4 c = c4[i];
    const Four<T> v = Four<T>::load(v0, i);
    c.x = v.v[0] == T(0) ? -1 : c.x;
    c.y = v.v[1] == T(0) ? -1 : c.y;
    c.z = v.v[2] == T(0) ? -1 : c.z;
    c.w = v.v[3] == T(0) ? -1 : c.w;
    reinterpret_cast<int4*>(s_codes)[i] = c;
    v.store(s_vals, i);
  }
  // this CTA's slots start at +0.0: in each period of R segments, the 32
  // consecutive ones of owners 32 y .. 32 y + 31 (one warp per period)
  for (long long q = warp; q * owners < g; q += kWarps) {
    const long long s = q * owners + y * 32LL + lane;
    if (s < g) part[s] = T(0);
  }
  s_table[warp * kTableStride + lane] = 0;
  __syncthreads();  // the chunk, the table's zeros and the slots' zeros

  // count: warp w's slice is rows [w L, (w + 1) L), L = chunk / 32 (a
  // multiple of 4); entry (o, w) is written by warp w alone
  const int slice = chunk / kWarps;
  const int r0 = warp * slice;
  for (int base = 0; base < slice; base += 32) {
    const int i = base + lane;
    const int o = i < slice ? local_owner(s_codes[r0 + i], ug, owner_mask, y) : -1;
    const unsigned peers = __match_any_sync(kAll, o);
    if (o >= 0 && lane == __ffs(peers) - 1) s_table[o * kTableStride + warp] += __popc(peers);
    __syncwarp();  // this step's table update before the next step's
  }
  __syncthreads();

  // scan: thread t holds entry (owner t / 32, slice t % 32); a warp scan
  // (shuffles), the warp totals scanned by warp 0, then each entry's
  // exclusive offset, plus the owner's padding. Warp o's lane 0 holds owner
  // o's bucket start.
  const int cnt = s_table[warp * kTableStride + lane];
  int incl = cnt;
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kAll, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) s_wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = s_wsum[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kAll, w, d);
      if (lane >= d) w += up;
    }
    s_wsum[lane] = w;  // inclusive
  }
  __syncthreads();
  const int excl = incl - cnt + (warp > 0 ? s_wsum[warp - 1] : 0) + warp;
  s_table[warp * kTableStride + lane] = excl;  // from here: (owner, slice)'s next place
  if (lane == 0) s_bound[warp] = excl;
  if (tid == kPass1Threads - 1) s_bound[kWarps] = excl + cnt + 1;
  __syncthreads();

  // scatter: the same slices and steps as the count, so each owner's rows
  // land in row order
  for (int base = 0; base < slice; base += 32) {
    const int i = base + lane;
    const int cd = i < slice ? s_codes[r0 + i] : -1;
    const int o = local_owner(cd, ug, owner_mask, y);
    const unsigned peers = __match_any_sync(kAll, o);
    const int leader = __ffs(peers) - 1;
    int at = o >= 0 && lane == leader ? s_table[o * kTableStride + warp] : 0;
    at = __shfl_sync(kAll, at, leader);
    if (o >= 0) {
      const int pos = at + __popc(peers & ((1u << lane) - 1u));
      b_codes[pos] = cd;
      b_vals[pos] = s_vals[r0 + i];
      if (lane == leader) s_table[o * kTableStride + warp] = at + __popc(peers);
    }
    __syncwarp();  // this step's table update before the next step's read
  }
  __syncthreads();

  // walk: warp o adds its bucket, 32 rows a step, in bucket (= row) order
  const int hi = s_bound[warp + 1] - 1;
  for (int base = s_bound[warp]; base < hi; base += 32) {
    const int i = base + lane;
    const int cd = i < hi ? b_codes[i] : -1;
    const unsigned peers = __match_any_sync(kAll, cd);
    if (cd >= 0 && lane == __ffs(peers) - 1) {
      T p = part[cd];
      for (unsigned m = peers; m != 0u; m &= m - 1u) p = p + b_vals[base + __ffs(m) - 1];
      part[cd] = p;
    }
    __syncwarp();  // this step's stores before the next step's loads
  }
}

template <typename T>
__global__ void __launch_bounds__(kPass2Threads)
scatter_pass2(const T* __restrict__ partials, T* __restrict__ out, int nch, int g) {
  const long long s = static_cast<long long>(blockIdx.x) * kPass2Threads + threadIdx.x;
  if (s >= g) return;
  T sum = T(0);
  T comp = T(0);
  for (int c = 0; c < nch; ++c) {
    const T p = partials[static_cast<long long>(c) * g + s];
    const T y = p - comp;
    const T t = sum + y;
    comp = (t - sum) - y;
    sum = t;
  }
  out[s] = sum;
}

}  // namespace

// host side: the launches (nvcc only; the host-run test of the passes
// stops above this line)
namespace {

// both passes of one value type T on `stream` (see the C entry points)
template <typename T>
int launch(const void* vals, const void* codes, void* partials, void* out, long long b,
           int chunk, int g, int s_log2, void* stream) {
  if (chunk > kMaxChunk || chunk % 128 != 0 || s_log2 < 0 || s_log2 > 5)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nch = static_cast<int>(b / chunk);
  const size_t smem = pass1_smem_bytes<T>(chunk);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!SmemSet<T>::done[dev]) {
    err = cudaFuncSetAttribute(scatter_pass1<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(pass1_smem_bytes<T>(kMaxChunk)));
    if (err != cudaSuccess) return static_cast<int>(err);
    SmemSet<T>::done[dev] = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid1(static_cast<unsigned>(nch), 1u << s_log2);
  scatter_pass1<T><<<grid1, kPass1Threads, smem, st>>>(static_cast<const T*>(vals),
                                                       static_cast<const int*>(codes),
                                                       static_cast<T*>(partials), chunk, g,
                                                       s_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (g + kPass2Threads - 1) / kPass2Threads;
  scatter_pass2<T><<<blocks, kPass2Threads, 0, st>>>(static_cast<const T*>(partials),
                                                     static_cast<T*>(out), nch, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// vals [b] float32 (masked rows 0.0), codes [b] int32, partials [nch, g]
// float32 scratch, out [g] float32, vals and codes 16-byte aligned. chunk is
// a multiple of 128 that divides b (nch = b / chunk), at most 8192 rows
// (pass 1 takes 16 bytes of shared memory a row, 132 KB at 8192). Each chunk
// spreads over 2^s_log2 CTAs (0 <= s_log2 <= 5). Launches both passes on
// `stream`, does not synchronise, and returns the first nonzero CUDA error
// (0 when both launches were accepted). The first launch on a device raises
// pass 1's shared-memory limit to its size at 8192 rows; later ones only
// launch.
int segment_scatter_sums_f32(const void* vals, const void* codes, void* partials, void* out,
                             long long b, int chunk, int g, int s_log2, void* stream) {
  return launch<float>(vals, codes, partials, out, b, chunk, g, s_log2, stream);
}

// The same contract in float64: vals, partials and out are float64 (pass 1
// takes 24 bytes of shared memory a row, about 201 KB at 8192), and the
// shared-memory limit is raised for this instantiation on its own first
// launch on a device.
int segment_scatter_sums_f64(const void* vals, const void* codes, void* partials, void* out,
                             long long b, int chunk, int g, int s_log2, void* stream) {
  return launch<double>(vals, codes, partials, out, b, chunk, g, s_log2, stream);
}

const char* segment_scatter_sums_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
