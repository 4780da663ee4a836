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
// Design.  One thread owns one (query, user) pair; the grid is
// (ceil(N / kThreads), Q).  A block stages its query's [Mp, 3, 3]
// coefficients through shared memory in tiles of kTile triangles, padded
// to three float4 per triangle so a thread reads a triangle with three
// 16-byte broadcast loads, and each thread loops over every triangle and
// writes one int32 count.  The Pallas kernel carried the sum across an Mp
// grid axis in a revisited output block; Hopper runs blocks in no order,
// so the loop inside the thread takes that axis's place and nothing
// accumulates across blocks.  The kernel masks the ragged user edge
// itself, so users need no padding.
//
// Bound.  fp32 issue: 6 multiplies, 6 adds and 3 compares per
// (query, user, triangle) against 8 bytes read per user and 4 written per
// (query, user); the coefficients are a few KB per query and live in
// shared memory.
//
// Rounding contract.  Every product and sum is written with __fmul_rn /
// __fadd_rn in the order ((x * a) + (y * b)) + c, so nvcc cannot contract
// them into FMAs.  The plain PyTorch version (repro_torch/kernels/ref.py)
// evaluates the same expression in the same order with one rounding per
// operation, so at a knife-edge ">= 0" tie both decide alike.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;  // triangles per shared-memory tile (12 KB)

__global__ void __launch_bounds__(kThreads)
raycast_count_batch_kernel(const float* __restrict__ xs,
                           const float* __restrict__ ys,
                           const float* __restrict__ coeffs,  // [Q, Mp, 3, 3]
                           int32_t* __restrict__ out,          // [Q, N]
                           int64_t n, int mp) {
  __shared__ float4 tile[kTile * 3];
  const int64_t q = blockIdx.y;
  const int64_t u = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = u < n;
  const float x = live ? xs[u] : 0.0f;
  const float y = live ? ys[u] : 0.0f;
  const float* cq = coeffs + q * static_cast<int64_t>(mp) * 9;
  float* tile_f = reinterpret_cast<float*>(tile);
  int count = 0;
  for (int t0 = 0; t0 < mp; t0 += kTile) {
    const int nt = min(kTile, mp - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < nt * 9; i += kThreads) {
      const int t = i / 9, r = i - t * 9;  // r = 3 * edge + coefficient
      tile_f[t * 12 + (r / 3) * 4 + (r % 3)] =
          cq[static_cast<int64_t>(t0) * 9 + i];
    }
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      const float4 e0 = tile[t * 3 + 0];
      const float4 e1 = tile[t * 3 + 1];
      const float4 e2 = tile[t * 3 + 2];
      const float v0 = __fadd_rn(__fadd_rn(__fmul_rn(x, e0.x), __fmul_rn(y, e0.y)), e0.z);
      const float v1 = __fadd_rn(__fadd_rn(__fmul_rn(x, e1.x), __fmul_rn(y, e1.y)), e1.z);
      const float v2 = __fadd_rn(__fadd_rn(__fmul_rn(x, e2.x), __fmul_rn(y, e2.y)), e2.z);
      count += (v0 >= 0.0f) & (v1 >= 0.0f) & (v2 >= 0.0f);
    }
  }
  if (live) out[q * n + u] = count;
}

}  // namespace

// out[q, u] for q < n_queries, u < n_users; coeffs is [n_queries, mp, 3, 3].
// The caller never passes an empty grid (n_users or n_queries of 0).
// Launches on `stream`, allocates nothing, does not synchronize, and
// returns cudaGetLastError() (0 = cudaSuccess).
extern "C" int raycast_count_batch(const void* xs, const void* ys,
                                   const void* coeffs, void* out,
                                   long long n_users, int n_queries, int mp,
                                   void* stream) {
  const dim3 grid(static_cast<unsigned>((n_users + kThreads - 1) / kThreads),
                  static_cast<unsigned>(n_queries));
  raycast_count_batch_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xs), static_cast<const float*>(ys),
      static_cast<const float*>(coeffs), static_cast<int32_t*>(out),
      static_cast<int64_t>(n_users), mp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* raycast_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
