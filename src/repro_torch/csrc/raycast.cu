// Dense occluder hit count (the paper's ray-casting stage) for Hopper, sm_90a.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/raycast.py:
// _raycast_batch_kernel (raycast_count_batch_kernel_call) and
// _raycast_kernel (raycast_count_kernel_call).  One kernel with a query
// axis serves both; the single-query form is Q = 1.
//
//   out[q, u] = #{ t < Mp : e_i(x_u, y_u) >= 0 for i = 0, 1, 2 },
//   e_i(x, y) = ((x * a_i) + (y * b_i)) + c_i  with (a_i, b_i, c_i) = coeffs[q, t, i, :].
//
// Design.  The users arrive in a spatial (Morton) order, cut into tiles of
// kTileUsers users that lie close together, with each tile's bounding box
// (repro_torch/kernels/user_order.py).  One block owns one (tile, query)
// pair, and each of its kThreads threads keeps kUsersPerThread users in
// registers.  The block walks the query's triangles in chunks of kThreads,
// one triangle per thread, and sorts each into SKIP, FULL or TEST on the
// tile's box with the exact classifier of tile_class.cuh (where its margin
// is derived): FULL triangles add 1 to the whole tile with no test, TEST
// triangles go into a list in shared memory.  Then every thread tests its
// users against the TEST list only, each triangle read once from shared
// memory for all of its users.  An infzone occluder is a half-plane
// clipped to the data rectangle, so its triangles are large: for a tile of
// close users nearly every triangle is SKIP or FULL, and the degenerate
// padding rows are always SKIP.  This culling is what the paper gets from
// the RT cores' BVH traversal.  Nothing accumulates across blocks: Hopper
// runs blocks in no order, and the loop over triangles inside the block
// takes the place of the Pallas kernel's sequential Mp grid axis.  The
// counts are stored in tile order, and the wrapper gathers them back to
// the users' order.  The users' order is random against space, so one
// side of the permutation is always scattered; on the H100 stores through
// the permutation inside the kernel cost more than the sorted store plus a
// gather (PERF.md), so the kernel stores in tile order only.
//
// Shape.  128 threads x 8 users: a chunk of triangles is one per thread,
// so the main path's Mp = 128 is classified in one pass with no idle
// thread, and each triangle read from shared memory serves 8 tests.
//
// Bound.  The bytes: 8 per user in, 36 per (query, triangle slot) in, 4 per
// (query, user) out; the per-user float32 work (12 operations a test,
// none fused) is paid only for the TEST pairs.
//
// Rounding contract.  Every float32 product and sum is written with
// __fmul_rn / __fadd_rn in the order ((x * a) + (y * b)) + c, so nvcc
// cannot contract them into FMAs, and the float64 corner evaluation with
// __dmul_rn / __dadd_rn.  The plain PyTorch version
// (repro_torch/kernels/ref.py) evaluates the same expression in the same
// order with one rounding per operation, so at a knife-edge ">= 0" tie
// both decide alike.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_class.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUsersPerThread = 8;
constexpr int kTileUsers = kThreads * kUsersPerThread;  // user_order.py TILE_USERS
constexpr int kWarps = kThreads / 32;

using tile_class::classify;
using tile_class::kFull;
using tile_class::kSkip;
using tile_class::kTest;

__global__ void __launch_bounds__(kThreads)
raycast_tiles_kernel(const float* __restrict__ xs_s,      // [N] users in tile order
                     const float* __restrict__ ys_s,
                     const float4* __restrict__ boxes,    // [n_tiles] (x_lo, y_lo, x_hi, y_hi)
                     const float* __restrict__ coeffs,    // [Q, Mp, 3, 3]
                     int32_t* __restrict__ out,           // [Q, N]
                     int64_t n, int mp) {
  __shared__ float4 list[kThreads * 3];  // the chunk's TEST triangles, 3 edges each
  __shared__ int warp_n[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t q = blockIdx.y;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kTileUsers;

  float x[kUsersPerThread], y[kUsersPerThread];
  int count[kUsersPerThread];
#pragma unroll
  for (int j = 0; j < kUsersPerThread; ++j) {
    const int64_t u = first + j * kThreads + tid;
    x[j] = u < n ? xs_s[u] : 0.0f;
    y[j] = u < n ? ys_s[u] : 0.0f;
    count[j] = 0;
  }
  const float4 box = boxes[blockIdx.x];
  const double x_lo = box.x, y_lo = box.y, x_hi = box.z, y_hi = box.w;
  const double X = fmax(fabs(x_lo), fabs(x_hi)), Y = fmax(fabs(y_lo), fabs(y_hi));
  const float* cq = coeffs + q * static_cast<int64_t>(mp) * 9;

  int full = 0;  // FULL triangles among those this thread classified
  for (int t0 = 0; t0 < mp; t0 += kThreads) {
    const int t = t0 + tid;
    float e[9];
    int cls = kSkip;
    if (t < mp) {
#pragma unroll
      for (int r = 0; r < 9; ++r) e[r] = cq[static_cast<int64_t>(t) * 9 + r];
      cls = classify(e, x_lo, y_lo, x_hi, y_hi, X, Y);
    }
    full += cls == kFull;
    const unsigned test = __ballot_sync(0xffffffffu, cls == kTest);
    if (lane == 0) warp_n[warp] = __popc(test);
    __syncthreads();  // warp_n is complete, and the previous list is no longer read
    int slot = __popc(test & ((1u << lane) - 1u)), len = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      slot += w < warp ? warp_n[w] : 0;
      len += warp_n[w];
    }
    if (cls == kTest) {
      list[slot * 3 + 0] = make_float4(e[0], e[1], e[2], 0.0f);
      list[slot * 3 + 1] = make_float4(e[3], e[4], e[5], 0.0f);
      list[slot * 3 + 2] = make_float4(e[6], e[7], e[8], 0.0f);
    }
    __syncthreads();  // the list is complete
    for (int s = 0; s < len; ++s) {
      const float4 e0 = list[s * 3 + 0];
      const float4 e1 = list[s * 3 + 1];
      const float4 e2 = list[s * 3 + 2];
#pragma unroll
      for (int j = 0; j < kUsersPerThread; ++j) {
        const float v0 = __fadd_rn(__fadd_rn(__fmul_rn(x[j], e0.x), __fmul_rn(y[j], e0.y)), e0.z);
        const float v1 = __fadd_rn(__fadd_rn(__fmul_rn(x[j], e1.x), __fmul_rn(y[j], e1.y)), e1.z);
        const float v2 = __fadd_rn(__fadd_rn(__fmul_rn(x[j], e2.x), __fmul_rn(y[j], e2.y)), e2.z);
        count[j] += (v0 >= 0.0f) & (v1 >= 0.0f) & (v2 >= 0.0f);
      }
    }
  }

  // every user of the tile is inside every FULL triangle
  full = __reduce_add_sync(0xffffffffu, full);
  __syncthreads();  // warp_n is no longer read
  if (lane == 0) warp_n[warp] = full;
  __syncthreads();
  int full_all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) full_all += warp_n[w];

  int32_t* oq = out + q * n;
#pragma unroll
  for (int j = 0; j < kUsersPerThread; ++j) {
    const int64_t u = first + j * kThreads + tid;
    if (u < n) oq[u] = count[j] + full_all;
  }
}

}  // namespace

// out[q, i] for q < n_queries and the users i < n_users in tile order;
// coeffs is [n_queries, mp, 3, 3] and boxes [ceil(n_users / tile_users)]
// float4.  tile_users must be the kernel's tile (kTileUsers), else
// cudaErrorInvalidValue.  The caller never passes an empty grid (n_users or n_queries of 0).  Launches on `stream`,
// allocates nothing, does not synchronize, and returns cudaGetLastError()
// (0 = cudaSuccess).
extern "C" int raycast_count_tiles(const void* xs_s, const void* ys_s, const void* boxes,
                                   const void* coeffs, void* out,
                                   long long n_users, int n_queries, int mp, int tile_users,
                                   void* stream) {
  if (tile_users != kTileUsers) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((n_users + kTileUsers - 1) / kTileUsers),
                  static_cast<unsigned>(n_queries));
  raycast_tiles_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xs_s), static_cast<const float*>(ys_s),
      static_cast<const float4*>(boxes), static_cast<const float*>(coeffs),
      static_cast<int32_t*>(out), static_cast<int64_t>(n_users), mp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* raycast_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
