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
// of `block`, so every user block lies in one cell and reads one [3, 3, L]
// plane slab: that cell's partial-overlap triangles.  The engine orders
// the users inside each run by a Morton code and gives padding rows the
// coordinates of their run's last user (kernels/grid_raycast.py
// order_cell_runs), so a block's users lie close together; any order and
// any padding is correct.
//
// Design.  One block of `threads` threads per (user block, kQueries
// queries), on the grid (n_blocks, ceil(Q / kQueries)): n_blocks goes on
// x, which has room past 65,535.  `threads` is the user block rounded up
// to a warp, at most kMaxThreads; each thread owns one user.  Two inputs
// cut the work to what the function needs:
//   lens[q, cell]  one past the cell's last listed triangle (the planes
//                  are padded to the batch's widest list L with the
//                  degenerate plane, which holds no user): the block walks
//                  only those lanes, and a cell with an empty list does no
//                  per-user work;
//   boxes[b]       the bounding box of user block b.  The block classifies
//                  each listed triangle on it with the exact classifier of
//                  tile_class.cuh: SKIP triangles are dropped, FULL ones
//                  are counted once for the whole block (a shared-memory
//                  atomic per query), and TEST ones are compacted into
//                  shared memory.  Each thread then tests its user against
//                  the TEST list only.
// The block's (query, lane) pairs are laid end to end, query by query, and
// each pass gives one pair to each thread: the reads of all kQueries
// lengths, then of the pass's coefficients, go out together, so a block
// waits for two dependent loads for kQueries queries, and reads the
// users, box and cell once for all of them.  With one query a block the
// kernel spent most of its time in those waits (PERF.md); 16 queries and
// 5 blocks per SM (48 registers) timed best of the shapes tried on the
// H100.  The compaction keeps the pairs' order, so each query's TEST
// triangles form one run of the list.
// The planes are laid out (edge, coefficient, L) with L innermost, so the
// threads of a pass read neighbouring lanes of one (edge, coefficient)
// row together.  A block of more than kMaxThreads users (any `block` from
// a caller; the engine's auto_cell_block stays within 8 to 256) is walked
// in chunks of `threads` users, each classifying the lists afresh.
//
// Bound.  Bytes: 8 per sorted row, 4 (cell_map) + 16 (box) per user
// block, 4 per (query, cell) of lens and of base where given, 36 per real
// listed triangle per (query, cell), 4 per (query, sorted row) written.
// With exact classes the function needs no test per (user, listed
// triangle), so no operations term bounds it; the per-user float32 tests
// are paid only for the TEST pairs.
//
// Rounding contract.  Every float32 product and sum is written with
// __fmul_rn / __fadd_rn in the order ((x * a) + (y * b)) + c, so nvcc
// cannot contract them into FMAs: the plain PyTorch versions
// (repro_torch/kernels/ref.py), the grid backend's counts
// (repro_torch/core/grid.py) and the dense kernel (raycast.cu) evaluate
// the same expression with one rounding per operation, so at a knife-edge
// ">= 0" tie all of them decide alike.  The classes are exact
// (tile_class.cuh), so the counts are bit-identical to the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_class.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kQueries = 16;  // queries per block
constexpr int kMinBlocks = 5;  // blocks per SM: caps the kernel at 48 registers a thread

using tile_class::classify;
using tile_class::kFull;
using tile_class::kSkip;
using tile_class::kTest;

__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
grid_raycast_cells_kernel(const float* __restrict__ xs,         // [n_blocks * block]
                          const float* __restrict__ ys,
                          const int32_t* __restrict__ cell_map,  // [n_blocks]
                          const int32_t* __restrict__ base,      // [Q, n_cells] or null
                          const float* __restrict__ planes,      // [Q, n_cells, 3, 3, L]
                          const int32_t* __restrict__ lens,      // [Q, n_cells]
                          const float4* __restrict__ boxes,      // [n_blocks] (x_lo, y_lo, x_hi, y_hi)
                          int32_t* __restrict__ out,             // [Q, n_blocks * block]
                          int64_t n_sorted, int block, int n_queries, int n_cells, int L) {
  extern __shared__ float4 list[];  // [blockDim.x * 3]: a pass's TEST triangles
  __shared__ int warp_n[kMaxWarps];
  __shared__ int before[kMaxThreads + 1];  // TEST pairs of the pass before each thread's
  __shared__ int q_off[kQueries + 1];      // the block's (query, lane) pairs, query by query
  __shared__ int q_base[kQueries], q_full[kQueries];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int threads = blockDim.x, n_warps = threads >> 5;
  const int64_t b = blockIdx.x;
  const int q0 = blockIdx.y * kQueries;
  const int nq = min(kQueries, n_queries - q0);
  const float* xb = xs + b * block;
  const float* yb = ys + b * block;
  // the loads that depend on nothing go out before the first barrier
  const float4 box = boxes[b];
  float x = tid < block ? xb[tid] : 0.0f;  // the first chunk's user
  float y = tid < block ? yb[tid] : 0.0f;
  const int64_t cell = cell_map[b];
  if (tid < kQueries) {
    const int64_t slot = static_cast<int64_t>(q0 + tid) * n_cells + cell;
    q_off[tid + 1] = tid < nq ? min(max(lens[slot], 0), L) : 0;
    q_base[tid] = tid < nq && base != nullptr ? base[slot] : 0;
    q_full[tid] = 0;
  }
  __syncthreads();
  if (tid == 0) {
    q_off[0] = 0;
    for (int k = 0; k < kQueries; ++k) q_off[k + 1] += q_off[k];
  }
  __syncthreads();
  const int total = q_off[kQueries];
  const double x_lo = box.x, y_lo = box.y, x_hi = box.z, y_hi = box.w;
  const double X = fmax(fabs(x_lo), fabs(x_hi)), Y = fmax(fabs(y_lo), fabs(y_hi));

  for (int u0 = 0; u0 < block; u0 += threads) {
    const int u = u0 + tid;
    const bool live = u < block;
    if (u0 > 0) {
      x = live ? xb[u] : 0.0f;
      y = live ? yb[u] : 0.0f;
    }
    int count[kQueries];
#pragma unroll
    for (int k = 0; k < kQueries; ++k) count[k] = 0;
    // one pass classifies `threads` (query, lane) pairs, one per thread
    for (int p0 = 0; p0 < total; p0 += threads) {
      const int p = p0 + tid;
      float e[9];
      int cls = kSkip;
      if (p < total) {
        int j = 0;
        while (p >= q_off[j + 1]) ++j;
        const int t = p - q_off[j];
        const float* slab = planes + (static_cast<int64_t>(q0 + j) * n_cells + cell) * 9 * L;
#pragma unroll
        for (int r = 0; r < 9; ++r) e[r] = slab[static_cast<int64_t>(r) * L + t];
        cls = classify(e, x_lo, y_lo, x_hi, y_hi, X, Y);
        if (cls == kFull && u0 == 0) atomicAdd(&q_full[j], 1);
      }
      const unsigned test = __ballot_sync(0xffffffffu, cls == kTest);
      if (lane == 0) warp_n[warp] = __popc(test);
      __syncthreads();  // warp_n is complete, and the previous list is no longer read
      int at = __popc(test & ((1u << lane) - 1u)), len = 0;
      for (int w = 0; w < n_warps; ++w) {
        at += w < warp ? warp_n[w] : 0;
        len += warp_n[w];
      }
      before[tid] = at;
      if (tid == 0) before[threads] = len;
      if (cls == kTest) {  // the list keeps the pairs' order: query by query
        list[at * 3 + 0] = make_float4(e[0], e[1], e[2], 0.0f);
        list[at * 3 + 1] = make_float4(e[3], e[4], e[5], 0.0f);
        list[at * 3 + 2] = make_float4(e[6], e[7], e[8], 0.0f);
      }
      __syncthreads();  // the list is complete
#pragma unroll
      for (int k = 0; k < kQueries; ++k) {
        // query k's pairs in this pass are threads [lo, hi), its TEST
        // triangles list[before[lo] .. before[hi])
        const int lo = min(max(q_off[k] - p0, 0), threads);
        const int hi = min(max(q_off[k + 1] - p0, 0), threads);
        for (int s = before[lo]; s < before[hi]; ++s) {
          const float4 e0 = list[s * 3 + 0];
          const float4 e1 = list[s * 3 + 1];
          const float4 e2 = list[s * 3 + 2];
          const float v0 = __fadd_rn(__fadd_rn(__fmul_rn(x, e0.x), __fmul_rn(y, e0.y)), e0.z);
          const float v1 = __fadd_rn(__fadd_rn(__fmul_rn(x, e1.x), __fmul_rn(y, e1.y)), e1.z);
          const float v2 = __fadd_rn(__fadd_rn(__fmul_rn(x, e2.x), __fmul_rn(y, e2.y)), e2.z);
          count[k] += (v0 >= 0.0f) & (v1 >= 0.0f) & (v2 >= 0.0f);
        }
      }
    }
    __syncthreads();  // q_full is complete (every user is inside every FULL triangle)
    if (live) {
#pragma unroll
      for (int k = 0; k < kQueries; ++k) {
        if (k < nq) out[(q0 + k) * n_sorted + b * block + u] = q_base[k] + q_full[k] + count[k];
      }
    }
  }
}

}  // namespace

// out[q, i] for q < n_queries, i < n_blocks * block; planes is
// [n_queries, n_cells, 3, 3, L], lens and base (or null) [n_queries,
// n_cells], boxes [n_blocks] float4 holding every row of its user block
// (a box that misses a row gives that row a wrong count).  Every cell_map
// entry must be < n_cells; lens is clamped to [0, L].  The caller never
// passes an empty grid (n_blocks or n_queries of 0).  Launches on
// `stream`, allocates nothing, does not synchronize, and returns
// cudaGetLastError() (0 = cudaSuccess).
extern "C" int grid_raycast_cells(const void* xs, const void* ys, const void* cell_map,
                                  const void* base, const void* planes, const void* lens,
                                  const void* boxes, void* out, long long n_blocks, int block,
                                  int n_queries, int n_cells, int L, void* stream) {
  const int warps_up = (block + 31) / 32 * 32;
  const int threads = warps_up < kMaxThreads ? warps_up : kMaxThreads;
  const dim3 grid(static_cast<unsigned>(n_blocks),
                  static_cast<unsigned>((n_queries + kQueries - 1) / kQueries));
  grid_raycast_cells_kernel<<<grid, threads, threads * 3 * sizeof(float4),
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xs), static_cast<const float*>(ys),
      static_cast<const int32_t*>(cell_map), static_cast<const int32_t*>(base),
      static_cast<const float*>(planes), static_cast<const int32_t*>(lens),
      static_cast<const float4*>(boxes), static_cast<int32_t*>(out),
      static_cast<int64_t>(n_blocks) * block, block, n_queries, n_cells, L);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* grid_raycast_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
