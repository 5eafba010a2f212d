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
// 3.35 TB/s; Q6 (K = 1) ~101 MB, ~30 us. Each input byte is read once from
// device memory: the fill step stages a tile of rows of several blocks in
// shared memory, coalesced, four loads in flight per thread. At the main
// path's G = 16 pass 1 runs one thread per (block, column) chain, which adds
// each selected row into a code-indexed accumulator in shared memory, so the
// work is O(n K), not O(n G K) (segment_sums_common.cuh). TMA-fed tiles are
// later work.

#include "segment_sums_common.cuh"

struct MssFill {
  const float* mask;
  const float* vals;
  int k;

  __device__ __forceinline__ void operator()(long long r0, int nb, int t, float* s_mask,
                                             int mask_stride, float* s_vals,
                                             int vals_stride) const {
    SsRowVec<float> mv;  // in flight while the values are copied
    mv.load(mask + r0, nb, t);
    ss_copy_tiles(vals + r0 * k, k, nb, t, s_vals, vals_stride);
    mv.store(s_mask, t, mask_stride);
  }
};

extern "C" {

// codes [n] int32, mask [n] float32 (0/1), vals [n, k] float32 row-major,
// out [g, k] float32, partials [grid_x, g, k] float32 scratch. n is a
// multiple of 1024, 1 <= k <= MAX_K; threads, grid_x, blocks_per_cta,
// loop, nb and t as segment_sums.pass1_args gives them (see ss_launch).
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
int masked_segment_sums_f32(const void* codes, const void* mask, const void* vals,
                            void* out, void* partials, long long n, int k, int g,
                            int threads, int grid_x, long long blocks_per_cta, int loop,
                            int nb, int t, void* stream) {
  const MssFill fill{static_cast<const float*>(mask), static_cast<const float*>(vals), k};
  return ss_launch(codes, fill, out, partials, n, k, g, threads, grid_x, blocks_per_cta,
                   loop, nb, t, stream);
}

const char* masked_segment_sums_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
