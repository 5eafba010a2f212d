// The two passes of the port's segment-sums kernels for Hopper (sm_90a),
// shared by K1 (masked_segment_sums.cu, its operands pre-masked in device
// memory) and K2 (the deep-fused kernel that
// daft_tpu_torch/kernels/fused_expr_sums.py generates from the expression
// nodes). Both compute out[g, k] = sum of vals[r, k] over the rows r with
// codes[r] == g and mask[r] != 0, Kahan-compensated across 1024-row blocks.
//
// The kernels differ only in how a tile of rows reaches shared memory: the
// `Fill` step. K1's step copies `mask` and `vals` rows; K2's evaluates the
// filter predicate and the K derived columns for each row of the tile from
// the raw staged columns. The accumulation below, the span layout and pass 2
// are one piece of code, so K2's sums equal K1's bit for bit whenever the
// derived values are equal.
//
// The Pallas kernels carry their accumulator from one grid step to the next,
// which relies on the TPU running its grid in order on one core. CTAs on
// Hopper run in parallel and in no order, so the carry becomes two passes:
//   pass 1: CTA x owns a contiguous span of 1024-row blocks. Each (g, k)
//           block sum starts at +0.0 and adds the block's rows of group g
//           whose mask is set, in row order. The block sums are Kahan-added
//           into the span's accumulator in block order, and the span's
//           compensated total goes to partials[x].
//   pass 2: one thread per output Kahan-adds partials[0..grid_x) in order.
// No float atomics anywhere: the partition into spans depends only on the
// shapes, so two runs on the same inputs give the same bits. All math is
// fp32 on the CUDA cores (no TF32, no bf16).
//
// Pass 1 has two loops with that one order of additions, so both give the
// same bits; segment_sums.pass1_loop picks one from (G, K) alone:
//   SS_LOOP_ROWS (ss_pass1_rows): one thread per sequential chain (block b,
//           column k). The CTA stages a tile of t rows of each of nb blocks
//           of its span, then each chain walks its block's rows in order and
//           adds each selected row into a shared-memory accumulator indexed
//           by the row's code: O(n K) work. Taken where the G accumulators
//           of every chain fit in the CTA's shared memory (G = 16 does).
//   SS_LOOP_OUTPUTS (ss_pass1_outputs): each thread owns up to
//           OUTS_PER_THREAD (g, k) outputs and every thread walks every row,
//           with a select: O(n G K) work. Taken for large G.

#pragma once

#include <cuda_runtime.h>
#include <string.h>

#define ROWS_PER_BLOCK 1024  // the Pallas kernels' block: Kahan granularity
#define TILE_ROWS 256        // rows staged in shared memory at a time (outputs loop)
#define OUTS_PER_THREAD 4
#define MAX_K 32             // the wrappers launch wider K in column chunks
#define SS_LOOP_OUTPUTS 0    // segment_sums.LOOP_OUTPUTS
#define SS_LOOP_ROWS 1       // segment_sums.LOOP_ROWS
#define SS_ROW_SMEM_MAX (48 * 1024)  // segment_sums._ROW_SMEM_BYTES

// Fill must provide
//   __device__ void operator()(long long r0, int nb, int t, float* s_mask,
//                              int mask_stride, float* s_vals, int vals_stride) const
// which stages rows r0 + b * ROWS_PER_BLOCK + [0, t) of each b in [0, nb),
// with all of the CTA's threads: row r of tile b's mask (0 or 1) into
// s_mask[b * mask_stride + r] and its k values into
// s_vals[b * vals_stride + r * k + j].

template <class T>
__device__ __forceinline__ T ss_from_bits(unsigned u) {
  T x;
  memcpy(&x, &u, sizeof x);
  return x;
}

// Copy nb tiles of t rows of w 4-byte elements each (tile b starts at
// src + b * ROWS_PER_BLOCK * w) to dst + b * dst_stride, with all of the
// CTA's threads. Each thread keeps four loads in flight, of 16 bytes where
// src is 16-byte aligned (t is a multiple of 32, so every tile is then too).
template <class T>
__device__ __forceinline__ void ss_copy_tiles(const T* __restrict__ src, int w, int nb, int t,
                                              T* __restrict__ dst, int dst_stride) {
  static_assert(sizeof(T) == 4, "4-byte elements");
  const int per = t * w;
  const int total = nb * per;
  if ((reinterpret_cast<unsigned long long>(src) & 15) == 0) {
    const int per4 = per / 4;
    const int total4 = total / 4;
    for (int e0 = threadIdx.x; e0 < total4; e0 += 4 * blockDim.x) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < total4) {
          const int b = e / per4;
          v[u] = reinterpret_cast<const uint4*>(
              src + static_cast<long long>(b) * ROWS_PER_BLOCK * w)[e - b * per4];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < total4) {
          const int b = e / per4;
          T* d = dst + b * dst_stride + 4 * (e - b * per4);
          d[0] = ss_from_bits<T>(v[u].x);
          d[1] = ss_from_bits<T>(v[u].y);
          d[2] = ss_from_bits<T>(v[u].z);
          d[3] = ss_from_bits<T>(v[u].w);
        }
      }
    }
    return;
  }
  for (int e0 = threadIdx.x; e0 < total; e0 += 4 * blockDim.x) {
    T v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < total) {
        const int b = e / per;
        v[u] = src[static_cast<long long>(b) * ROWS_PER_BLOCK * w + (e - b * per)];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < total) {
        const int b = e / per;
        dst[b * dst_stride + (e - b * per)] = v[u];
      }
    }
  }
}

// Four rows of a 4-byte column per thread, of nb tiles of t rows (tile b
// starts at src + b * ROWS_PER_BLOCK): thread i takes rows 4i .. 4i + 3 of
// the nb * t (t is a multiple of 32, so the four share a tile), with one
// 16-byte load where aligned. `load` and `store` are separate calls, so the
// fill step's loads are in flight meanwhile. ss_launch keeps
// nb * t <= 4 * threads, so one vector per thread covers the tiles.
template <class T>
struct SsRowVec {
  unsigned v[4];
  int e;  // the first of the thread's rows, or -1

  __device__ __forceinline__ void load(const T* __restrict__ src, int nb, int t) {
    e = 4 * threadIdx.x;
    if (e >= nb * t) {
      e = -1;
      return;
    }
    const int b = e / t;
    const T* p = src + static_cast<long long>(b) * ROWS_PER_BLOCK + (e - b * t);
    if ((reinterpret_cast<unsigned long long>(p) & 15) == 0) {
      const uint4 x = *reinterpret_cast<const uint4*>(p);
      v[0] = x.x;
      v[1] = x.y;
      v[2] = x.z;
      v[3] = x.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) memcpy(&v[i], p + i, sizeof(T));
    }
  }

  __device__ __forceinline__ void store(T* __restrict__ dst, int t, int dst_stride) const {
    if (e < 0) return;
    const int b = e / t;
    T* d = dst + b * dst_stride + (e - b * t);
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] = ss_from_bits<T>(v[i]);
  }
};

__device__ __forceinline__ void ss_kahan(float& acc, float& comp, float x) {
  const float y = x - comp;
  const float tsum = acc + y;
  comp = (tsum - acc) - y;
  acc = tsum;
}

template <class Fill>
__global__ void ss_pass1_outputs(const int* __restrict__ codes, const Fill fill,
                                 float* __restrict__ partials, long long n, int k, int g,
                                 long long blocks_per_cta) {
  extern __shared__ float smem[];
  int* s_codes = reinterpret_cast<int*>(smem);
  float* s_mask = smem + TILE_ROWS;
  float* s_vals = smem + 2 * TILE_ROWS;

  const int gk = g * k;
  const int tile0 = blockIdx.y * blockDim.x * OUTS_PER_THREAD;
  int out_g[OUTS_PER_THREAD];
  int out_k[OUTS_PER_THREAD];
  bool active[OUTS_PER_THREAD];
  float acc[OUTS_PER_THREAD];
  float comp[OUTS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < OUTS_PER_THREAD; ++i) {
    const int j = tile0 + threadIdx.x + i * blockDim.x;
    active[i] = j < gk;
    out_g[i] = active[i] ? j / k : -1;
    out_k[i] = active[i] ? j % k : 0;
    acc[i] = 0.f;
    comp[i] = 0.f;
  }

  const long long nblocks = n / ROWS_PER_BLOCK;
  const long long b0 = blockIdx.x * blocks_per_cta;
  const long long b1 = min(b0 + blocks_per_cta, nblocks);
  for (long long blk = b0; blk < b1; ++blk) {
    float s[OUTS_PER_THREAD];
#pragma unroll
    for (int i = 0; i < OUTS_PER_THREAD; ++i) s[i] = 0.f;
    for (int t = 0; t < ROWS_PER_BLOCK; t += TILE_ROWS) {
      const long long r0 = blk * ROWS_PER_BLOCK + t;
      __syncthreads();  // the previous tile is consumed
      SsRowVec<int> cv;
      cv.load(codes + r0, 1, TILE_ROWS);
      fill(r0, 1, TILE_ROWS, s_mask, 0, s_vals, 0);
      cv.store(s_codes, TILE_ROWS, 0);
      __syncthreads();
      for (int r = 0; r < TILE_ROWS; ++r) {
        const int c = s_codes[r];
        const bool on = s_mask[r] != 0.f;
#pragma unroll
        for (int i = 0; i < OUTS_PER_THREAD; ++i) {
          if (on && c == out_g[i]) s[i] += s_vals[r * k + out_k[i]];
        }
      }
    }
    // Kahan-add this block's sum, in block order
#pragma unroll
    for (int i = 0; i < OUTS_PER_THREAD; ++i) ss_kahan(acc[i], comp[i], s[i]);
  }
#pragma unroll
  for (int i = 0; i < OUTS_PER_THREAD; ++i) {
    if (active[i]) {
      const int j = tile0 + threadIdx.x + i * blockDim.x;
      partials[static_cast<long long>(blockIdx.x) * gk + j] = acc[i] - comp[i];
    }
  }
}

// Shared memory of the rows loop, in floats: codes and mask tiles
// [nb][t + 1], value tiles [nb][(t + 1) * k], block sums [g][astride] with
// astride = nb * k rounded up to 32, and the span's Kahan sum and
// compensation [g * k] each. segment_sums._row_smem_bytes mirrors it.
__host__ __device__ inline long long ss_rows_smem_floats(int g, int k, int nb, int t) {
  const long long tp = t + 1;
  const long long astride = (nb * k + 31) / 32 * 32;
  return nb * tp * (2 + k) + static_cast<long long>(g) * astride + 2LL * g * k;
}

// The row-parallel loop. A tile row stride of t + 1 (codes, mask) and a tile
// stride of (t + 1) * k (values) put the chains of a warp on distinct banks:
// chain c = b * k + j reads bank (c + r * k) mod 32 of the values and bank
// (b + r) mod 32 of the codes, and its accumulator of group g sits at
// g * astride + c, bank c mod 32.
template <class Fill>
__global__ void ss_pass1_rows(const int* __restrict__ codes, const Fill fill,
                              float* __restrict__ partials, long long n, int k, int g,
                              long long blocks_per_cta, int nb, int t) {
  extern __shared__ float smem[];
  const int tp = t + 1;
  const int astride = (nb * k + 31) / 32 * 32;
  const int gk = g * k;
  int* s_codes = reinterpret_cast<int*>(smem);
  float* s_mask = smem + nb * tp;
  float* s_vals = s_mask + nb * tp;
  float* s_acc = s_vals + nb * tp * k;
  float* s_sum = s_acc + g * astride;
  float* s_comp = s_sum + gk;
  for (int j = threadIdx.x; j < gk; j += blockDim.x) s_sum[j] = s_comp[j] = 0.f;

  const int chain = threadIdx.x;
  const int cb = chain / k;
  const int ck = chain - cb * k;
  const long long nblocks = n / ROWS_PER_BLOCK;
  const long long b0 = blockIdx.x * blocks_per_cta;
  const long long b1 = min(b0 + blocks_per_cta, nblocks);
  for (long long gb = b0; gb < b1; gb += nb) {
    const int live = static_cast<int>(min(static_cast<long long>(nb), b1 - gb));
    // every block sum starts at +0.0 (the previous group's Kahan pass is done)
    for (int i = threadIdx.x; i < g * astride; i += blockDim.x) s_acc[i] = 0.f;
    for (int r0 = 0; r0 < ROWS_PER_BLOCK; r0 += t) {
      const long long row0 = gb * ROWS_PER_BLOCK + r0;
      __syncthreads();  // the previous tile is consumed
      SsRowVec<int> cv;  // the codes load is in flight while the fill step runs
      cv.load(codes + row0, live, t);
      fill(row0, live, t, s_mask, tp, s_vals, tp * k);
      cv.store(s_codes, t, tp);
      __syncthreads();
      if (cb < live) {
        const int* c = s_codes + cb * tp;
        const float* m = s_mask + cb * tp;
        const float* v = s_vals + cb * tp * k + ck;
        float* acc = s_acc + chain;
        for (int r = 0; r < t; r += 4) {
          // the tile reads are independent of the sums: load them first
          int cc[4];
          bool on[4];
          float vv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            cc[u] = c[r + u];
            on[u] = m[r + u] != 0.f && static_cast<unsigned>(cc[u]) < static_cast<unsigned>(g);
            vv[u] = v[(r + u) * k];
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (on[u]) acc[cc[u] * astride] += vv[u];
          }
        }
      }
    }
    __syncthreads();
    // Kahan-add the group's block sums into the span's, in block order
    for (int j = threadIdx.x; j < gk; j += blockDim.x) {
      const int gg = j / k;
      const float* bs = s_acc + gg * astride + (j - gg * k);
      float a = s_sum[j];
      float cp = s_comp[j];
      for (int b = 0; b < live; ++b) ss_kahan(a, cp, bs[b * k]);
      s_sum[j] = a;
      s_comp[j] = cp;
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < gk; j += blockDim.x)  // the thread that Kahan-added j
    partials[static_cast<long long>(blockIdx.x) * gk + j] = s_sum[j] - s_comp[j];
}

__global__ void ss_pass2(const float* __restrict__ partials, float* __restrict__ out,
                         int grid_x, int gk) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= gk) return;
  float acc = 0.f;
  float comp = 0.f;
  for (int x = 0; x < grid_x; ++x) ss_kahan(acc, comp, partials[static_cast<long long>(x) * gk + j]);
  out[j] = acc;
}

// Launch both passes on `stream` for k (<= MAX_K) columns; does not
// synchronise. codes [n] int32, out [g, k] float32, partials [grid_x, g, k]
// float32 scratch; n is a multiple of 1024, grid_x * blocks_per_cta >=
// n / 1024, and `loop`, threads, nb and t come from segment_sums.pass1_args:
// threads is a multiple of 32 up to 256; the outputs loop takes at least 64
// (nb, t unused); the rows loop takes nb * k <= threads, nb * t <= 4 * threads
// and t a multiple of 32 that divides 1024. Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments
// outside these.
template <class Fill>
static int ss_launch(const void* codes, const Fill& fill, void* out, void* partials,
                     long long n, int k, int g, int threads, int grid_x,
                     long long blocks_per_cta, int loop, int nb, int t, void* stream) {
  if (k < 1 || k > MAX_K || threads < 32 || threads > 256 || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int gk = g * k;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(codes);
  float* p = static_cast<float*>(partials);
  if (loop == SS_LOOP_ROWS) {
    const size_t smem = ss_rows_smem_floats(g, k, nb, t) * sizeof(float);
    if (nb < 1 || nb * k > threads || t < 32 || t % 32 || ROWS_PER_BLOCK % t ||
        nb * t > 4 * threads || smem > SS_ROW_SMEM_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    ss_pass1_rows<Fill><<<grid_x, threads, smem, s>>>(c, fill, p, n, k, g, blocks_per_cta, nb, t);
  } else if (loop == SS_LOOP_OUTPUTS && TILE_ROWS <= 4 * threads) {
    const int tile = threads * OUTS_PER_THREAD;
    const dim3 grid1(grid_x, (gk + tile - 1) / tile);
    const size_t smem = (2 * TILE_ROWS + static_cast<size_t>(TILE_ROWS) * k) * sizeof(float);
    ss_pass1_outputs<Fill><<<grid1, threads, smem, s>>>(c, fill, p, n, k, g, blocks_per_cta);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ss_pass2<<<(gk + 255) / 256, 256, 0, s>>>(p, static_cast<float*>(out), grid_x, gk);
  return static_cast<int>(cudaGetLastError());
}
