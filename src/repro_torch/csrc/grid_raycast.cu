// Cell-bucketed grid hit count (the grid index's verify stage) for Hopper, sm_90a.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/grid_raycast.py:
// the kernel of grid_raycast_cells_batch (pallas_call at :317, batched, no
// base) and the kernel of _grid_raycast_cells_call (pallas_call at :242,
// one query, base[cell] added in the kernel).  One kernel with a query
// axis and an optional base pointer serves both; the single query is Q = 1.
//
//   out[q, i] = (base ? base[q, cell] : 0)
//             + #{ l < L : e_j(x_i, y_i) >= 0 for j = 0, 1, 2 },
//   cell = cell_map[i / block],
//   e_j(x, y) = ((x * a) + (y * b)) + c  with (a, b, c) = planes[q, cell, j, :, l].
//
// Users arrive sorted by grid cell, each cell's run padded to a multiple
// of `block` (padding rows hold 2e9 coordinates and are dropped by the
// caller), so every user block lies in one cell and reads one [3, 3, L]
// plane slab: that cell's partial-overlap triangles.
//
// Design.  One block of kThreads threads per (user block, query), on the
// grid (n_blocks, Q): n_blocks goes on x, which has room past 65,535.
// The Pallas kernels scalar-prefetch cell_map (and base); here each block
// reads its own cell_map[blockIdx.x] and base[q, cell], then stages its
// query's slab through shared memory in tiles of kTile triangles.  The
// planes are laid out (edge, coefficient, L) with L innermost, unlike the
// dense path's [Mp, 3, 3], so the staging loop transposes: neighbouring
// threads read neighbouring l of one (edge, coefficient) row, and write
// triangle l as three float4 (a, b, c, -) for three 16-byte broadcast
// loads per triangle.  One thread owns one user and loops over every
// triangle of the tile.  `block` (8 to 256 from auto_cell_block, any value
// from a caller) is not tied to kThreads: the threads loop over the block
// in chunks of kThreads, and mask the rest.  L may be 1 (an empty scene's
// single degenerate lane) or several hundred (a non-pruned scene), so the
// tile loop covers any L and shared memory never depends on it.
//
// Bound.  Bytes: 8 per sorted user and 4 per user block read, the
// [Q, n_cells, 3, 3, L] planes read once (36 L per (query, cell)), 4 per
// (query, cell) of base where given, 4 per (query, sorted user) written;
// each block re-reads its cell's slab.  Operations: 6 multiplies and 6
// adds per (query, real user, real listed triangle) in fp32.  The kernel
// walks every padded lane and every padded user row, which the bound does
// not count; with short lists and small blocks most threads of a block
// idle, which a later, faster design would fix.
//
// Rounding contract.  Every product and sum is written with __fmul_rn /
// __fadd_rn in the order ((x * a) + (y * b)) + c, so nvcc cannot contract
// them into FMAs: the plain PyTorch versions (repro_torch/kernels/ref.py),
// the grid backend's counts (repro_torch/core/grid.py) and the dense
// kernel (raycast.cu) evaluate the same expression with one rounding per
// operation, so at a knife-edge ">= 0" tie all of them decide alike.
//
// ptxas (sm_90a, -O3): 62 registers and 12,288 bytes of shared memory (the
// tile); 62 x 256 registers allow 4 blocks per SM, half the SM's 64 warps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;  // triangles per shared-memory tile (12 KB)

__global__ void __launch_bounds__(kThreads)
grid_raycast_cells_kernel(const float* __restrict__ xs,         // [n_blocks * block]
                          const float* __restrict__ ys,
                          const int32_t* __restrict__ cell_map,  // [n_blocks]
                          const int32_t* __restrict__ base,      // [Q, n_cells] or null
                          const float* __restrict__ planes,      // [Q, n_cells, 3, 3, L]
                          int32_t* __restrict__ out,             // [Q, n_blocks * block]
                          int64_t n_sorted, int block, int n_cells, int L) {
  __shared__ float4 tile[kTile * 3];
  float* tile_f = reinterpret_cast<float*>(tile);
  const int64_t b = blockIdx.x;
  const int64_t q = blockIdx.y;
  const int64_t slot = q * n_cells + cell_map[b];
  const int add = base != nullptr ? base[slot] : 0;
  const float* slab = planes + slot * 9 * static_cast<int64_t>(L);
  for (int u0 = 0; u0 < block; u0 += kThreads) {
    const int u = u0 + static_cast<int>(threadIdx.x);
    const bool live = u < block;
    const int64_t row = b * block + u;
    const float x = live ? xs[row] : 0.0f;
    const float y = live ? ys[row] : 0.0f;
    int count = 0;
    for (int t0 = 0; t0 < L; t0 += kTile) {
      const int nt = min(kTile, L - t0);
      __syncthreads();  // the previous tile is no longer read
      for (int i = threadIdx.x; i < nt * 9; i += kThreads) {
        const int r = i / nt, l = i - r * nt;  // r = 3 * edge + coefficient
        tile_f[l * 12 + (r / 3) * 4 + (r % 3)] = slab[static_cast<int64_t>(r) * L + t0 + l];
      }
      __syncthreads();
      for (int l = 0; l < nt; ++l) {
        const float4 e0 = tile[l * 3 + 0];
        const float4 e1 = tile[l * 3 + 1];
        const float4 e2 = tile[l * 3 + 2];
        const float v0 = __fadd_rn(__fadd_rn(__fmul_rn(x, e0.x), __fmul_rn(y, e0.y)), e0.z);
        const float v1 = __fadd_rn(__fadd_rn(__fmul_rn(x, e1.x), __fmul_rn(y, e1.y)), e1.z);
        const float v2 = __fadd_rn(__fadd_rn(__fmul_rn(x, e2.x), __fmul_rn(y, e2.y)), e2.z);
        count += (v0 >= 0.0f) & (v1 >= 0.0f) & (v2 >= 0.0f);
      }
    }
    if (live) out[q * n_sorted + row] = add + count;
  }
}

}  // namespace

// out[q, i] for q < n_queries, i < n_blocks * block; planes is
// [n_queries, n_cells, 3, 3, L], base is [n_queries, n_cells] or null.
// Every cell_map entry must be < n_cells.  The caller never passes an
// empty grid (n_blocks or n_queries of 0).  Launches on `stream`,
// allocates nothing, does not synchronize, and returns cudaGetLastError()
// (0 = cudaSuccess).
extern "C" int grid_raycast_cells(const void* xs, const void* ys, const void* cell_map,
                                  const void* base, const void* planes, void* out,
                                  long long n_blocks, int block, int n_queries,
                                  int n_cells, int L, void* stream) {
  const dim3 grid(static_cast<unsigned>(n_blocks), static_cast<unsigned>(n_queries));
  grid_raycast_cells_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xs), static_cast<const float*>(ys),
      static_cast<const int32_t*>(cell_map), static_cast<const int32_t*>(base),
      static_cast<const float*>(planes), static_cast<int32_t*>(out),
      static_cast<int64_t>(n_blocks) * block, block, n_cells, L);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* grid_raycast_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
