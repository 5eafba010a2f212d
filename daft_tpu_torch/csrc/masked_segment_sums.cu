// K1, masked segment sums for Hopper (sm_90a): out[g, k] = sum of vals[r, k]
// over the rows r with codes[r] == g and mask[r] != 0, Kahan-compensated
// across 1024-row blocks. Plain C interface, loaded with ctypes by
// daft_tpu_torch/kernels/segment_sums.py, which also holds the plain PyTorch
// version this kernel is checked against.
//
// Replaces the Pallas TPU kernel daft_tpu/kernels/pallas_ops.py
// _masked_segment_sums_padded (body _kernel): per 1024-row block a masked
// one-hot (rows x G) times the (rows x K) values on the MXU, Kahan-added into
// a (G x K) accumulator that the grid carries from step to step. The two
// passes that replace that carry live in segment_sums_common.cuh, shared with
// the deep-fused kernel K2; K1's tile-fill step copies the pre-masked
// operands into shared memory.
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

#include "segment_sums_common.cuh"

struct MssFill {
  const float* mask;
  const float* vals;
  int k;

  __device__ __forceinline__ void operator()(long long r0, float* s_mask, float* s_vals) const {
    for (int r = threadIdx.x; r < TILE_ROWS; r += blockDim.x) s_mask[r] = mask[r0 + r];
    const float* src = vals + r0 * k;
    for (int e = threadIdx.x; e < TILE_ROWS * k; e += blockDim.x) s_vals[e] = src[e];
  }
};

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
  const MssFill fill{static_cast<const float*>(mask), static_cast<const float*>(vals), k};
  return ss_launch(codes, fill, out, partials, n, k, g, threads, grid_x, blocks_per_cta,
                   stream);
}

const char* masked_segment_sums_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
