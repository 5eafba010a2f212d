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
//   pass 1: CTA x owns a contiguous span of 1024-row blocks and walks them in
//           row order. Each thread owns up to OUTS_PER_THREAD (g, k) outputs
//           and sums their rows in row order (a select, so a NaN in a row of
//           another group or behind the mask never leaks in). Each finished
//           block sum is Kahan-added into the thread's per-span accumulator,
//           and the span's compensated total goes to partials[x].
//   pass 2: one thread per output Kahan-adds partials[0..grid_x) in order.
// No float atomics anywhere: the partition into spans depends only on the
// shapes, so two runs on the same inputs give the same bits. All math is
// fp32 on the CUDA cores (no TF32, no bf16).

#pragma once

#include <cuda_runtime.h>

#define ROWS_PER_BLOCK 1024  // the Pallas kernels' block: Kahan granularity
#define TILE_ROWS 256        // rows staged in shared memory at a time
#define OUTS_PER_THREAD 4
#define MAX_K 32             // the wrappers launch wider K in column chunks

// Fill must provide
//   __device__ void operator()(long long r0, float* s_mask, float* s_vals) const
// writing s_mask[0, TILE_ROWS) (0 or 1) and s_vals[0, TILE_ROWS * k) (row
// major) for rows r0 .. r0 + TILE_ROWS, with all of the CTA's threads.
template <class Fill>
__global__ void ss_pass1(const int* __restrict__ codes, const Fill fill,
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
      for (int r = threadIdx.x; r < TILE_ROWS; r += blockDim.x) s_codes[r] = codes[r0 + r];
      fill(r0, s_mask, s_vals);
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
    for (int i = 0; i < OUTS_PER_THREAD; ++i) {
      const float y = s[i] - comp[i];
      const float tsum = acc[i] + y;
      comp[i] = (tsum - acc[i]) - y;
      acc[i] = tsum;
    }
  }
#pragma unroll
  for (int i = 0; i < OUTS_PER_THREAD; ++i) {
    if (active[i]) {
      const int j = tile0 + threadIdx.x + i * blockDim.x;
      partials[static_cast<long long>(blockIdx.x) * gk + j] = acc[i] - comp[i];
    }
  }
}

__global__ void ss_pass2(const float* __restrict__ partials, float* __restrict__ out,
                         int grid_x, int gk) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= gk) return;
  float acc = 0.f;
  float comp = 0.f;
  for (int x = 0; x < grid_x; ++x) {
    const float y = partials[static_cast<long long>(x) * gk + j] - comp;
    const float tsum = acc + y;
    comp = (tsum - acc) - y;
    acc = tsum;
  }
  out[j] = acc;
}

// Launch both passes on `stream` for k (<= MAX_K) columns; does not
// synchronise. codes [n] int32, out [g, k] float32, partials [grid_x, g, k]
// float32 scratch; n is a multiple of 1024, threads a multiple of 32 up to
// 256, grid_x * blocks_per_cta >= n / 1024 (segment_sums.launch_shape).
// Returns cudaGetLastError().
template <class Fill>
static int ss_launch(const void* codes, const Fill& fill, void* out, void* partials,
                     long long n, int k, int g, int threads, int grid_x,
                     long long blocks_per_cta, void* stream) {
  if (k < 1 || k > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  const int gk = g * k;
  const int tile = threads * OUTS_PER_THREAD;
  const dim3 grid1(grid_x, (gk + tile - 1) / tile);
  const size_t smem = (2 * TILE_ROWS + static_cast<size_t>(TILE_ROWS) * k) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ss_pass1<Fill><<<grid1, threads, smem, s>>>(static_cast<const int*>(codes), fill,
                                              static_cast<float*>(partials), n, k, g,
                                              blocks_per_cta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ss_pass2<<<(gk + 255) / 256, 256, 0, s>>>(static_cast<const float*>(partials),
                                            static_cast<float*>(out), grid_x, gk);
  return static_cast<int>(cudaGetLastError());
}
