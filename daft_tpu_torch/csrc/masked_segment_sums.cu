// Masked segment sums for Hopper (sm_90a): out[g, k] = sum of vals[r, k] over
// the rows r with codes[r] == g and mask[r] != 0, Kahan-compensated across
// 1024-row blocks. Plain C interface, loaded with ctypes by
// daft_tpu_torch/kernels/segment_sums.py, which also holds the plain PyTorch
// version this kernel is checked against.
//
// Replaces the Pallas TPU kernel daft_tpu/kernels/pallas_ops.py
// _masked_segment_sums_padded (body _kernel): per 1024-row block a masked
// one-hot (rows x G) times the (rows x K) values on the MXU, Kahan-added into
// a (G x K) accumulator that the grid carries from step to step. That carry
// relies on the TPU running its grid in order on one core. CTAs on Hopper run
// in parallel and in no order, so the carry becomes two passes:
//   pass 1: CTA x owns a contiguous span of 1024-row blocks and walks them in
//           row order. Each thread owns up to OUTS_PER_THREAD (g, k) outputs
//           and sums their rows in row order (a select, so a NaN in a row of
//           another group or behind the mask never leaks in). Each finished
//           block sum is Kahan-added into the thread's per-span accumulator,
//           and the span's compensated total goes to partials[x].
//   pass 2: one thread per output Kahan-adds partials[0..grid_x) in order.
// No float atomics anywhere: the partition into spans depends only on the
// shapes, so two runs on the same inputs give the same bits. All math is
// fp32 on the CUDA cores (no TF32, no bf16): the compensated bound is what
// keeps TPC-H money sums within 1e-6 relative.
//
// Bound on an H100: the kernel must read every row once, n * (4 + 4 + 4K)
// bytes (codes, mask, K values); the (G x K) output is negligible. At SF1 the
// main path has n = 8,388,608 rows: Q1 (K = 7) reads ~302 MB, ~90 us at
// 3.35 TB/s; Q6 (K = 1) ~101 MB, ~30 us. The design keeps each input byte to
// one read from device memory (rows are staged once per CTA tile in shared
// memory, coalesced, and all of the CTA's outputs are served from there) and
// launches enough CTAs (about 8 per SM) to keep loads in flight. For G * K
// above one tile of outputs a CTA row span is re-read once per output tile;
// the main path (G = 16) has one tile. Making it fast (TMA, wgmma for large G)
// is later work.

#include <cuda_runtime.h>

#define ROWS_PER_BLOCK 1024  // the Pallas kernel's block: Kahan granularity
#define TILE_ROWS 256        // rows staged in shared memory at a time
#define OUTS_PER_THREAD 4
#define MAX_K 32             // the wrapper launches wider K in column chunks

__global__ void mss_pass1(const int* __restrict__ codes,
                          const float* __restrict__ mask,
                          const float* __restrict__ vals,
                          float* __restrict__ partials,
                          long long n, int k, int g, long long blocks_per_cta) {
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
      for (int r = threadIdx.x; r < TILE_ROWS; r += blockDim.x) {
        s_codes[r] = codes[r0 + r];
        s_mask[r] = mask[r0 + r];
      }
      const float* src = vals + r0 * k;
      for (int e = threadIdx.x; e < TILE_ROWS * k; e += blockDim.x) s_vals[e] = src[e];
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

__global__ void mss_pass2(const float* __restrict__ partials, float* __restrict__ out,
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

extern "C" {

// codes [n] int32, mask [n] float32 (0/1), vals [n, k] float32 row-major,
// out [g, k] float32, partials [grid_x, g, k] float32 scratch. n is a
// multiple of 1024, 1 <= k <= MAX_K, threads a multiple of 32 up to 256,
// grid_x * blocks_per_cta >= n / 1024. Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
int masked_segment_sums_f32(const void* codes, const void* mask, const void* vals,
                            void* out, void* partials, long long n, int k, int g,
                            int threads, int grid_x, long long blocks_per_cta,
                            void* stream) {
  if (k < 1 || k > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  const int gk = g * k;
  const int tile = threads * OUTS_PER_THREAD;
  const dim3 grid1(grid_x, (gk + tile - 1) / tile);
  const size_t smem = (2 * TILE_ROWS + static_cast<size_t>(TILE_ROWS) * k) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mss_pass1<<<grid1, threads, smem, s>>>(
      static_cast<const int*>(codes), static_cast<const float*>(mask),
      static_cast<const float*>(vals), static_cast<float*>(partials), n, k, g,
      blocks_per_cta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mss_pass2<<<(gk + 255) / 256, 256, 0, s>>>(static_cast<const float*>(partials),
                                             static_cast<float*>(out), grid_x, gk);
  return static_cast<int>(cudaGetLastError());
}

const char* masked_segment_sums_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
