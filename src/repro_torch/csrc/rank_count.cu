// Distance-rank count (the exact RkNN oracle) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel _rank_kernel of
// src/repro/kernels/rank_count.py (rank_count_kernel_call):
//
//   out[u] = #{ f < M : ((x_u - fx_f)^2 + (y_u - fy_f)^2) < thr_u },
//
// with thr_u = d^2(u, q) computed by the caller.  count < k <=> u is in
// RkNN(q), which makes this the on-card oracle the ray-cast count is held
// against.
//
// Design.  One thread per user; facility coordinates are staged through
// shared memory in tiles of kTile float2, read by every thread as one
// 8-byte broadcast load.  Facilities at +inf (the excluded query row)
// are never closer.  The Pallas kernel's revisited output block over the
// facility grid axis becomes the loop inside the thread.
//
// Bound.  fp32 issue: 2 subtracts, 2 multiplies, 1 add and 1 compare per
// (user, facility) against 12 bytes read and 4 written per user.
//
// Rounding contract.  Written with __fsub_rn / __fmul_rn / __fadd_rn as
// (dx * dx) + (dy * dy), dx = x - fx, so nvcc cannot contract into FMAs;
// the plain PyTorch version evaluates the same order with one rounding
// per operation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads;  // facilities per shared-memory tile

__global__ void __launch_bounds__(kThreads)
rank_count_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                  const float* __restrict__ thr, const float* __restrict__ fx,
                  const float* __restrict__ fy, int32_t* __restrict__ out,
                  int64_t n, int m) {
  __shared__ float2 tile[kTile];
  const int64_t u = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = u < n;
  const float x = live ? xs[u] : 0.0f;
  const float y = live ? ys[u] : 0.0f;
  const float t = live ? thr[u] : 0.0f;
  int count = 0;
  for (int f0 = 0; f0 < m; f0 += kTile) {
    const int nf = min(kTile, m - f0);
    __syncthreads();
    if (threadIdx.x < nf) {
      tile[threadIdx.x] = make_float2(fx[f0 + threadIdx.x], fy[f0 + threadIdx.x]);
    }
    __syncthreads();
    for (int j = 0; j < nf; ++j) {
      const float2 f = tile[j];
      const float dx = __fsub_rn(x, f.x);
      const float dy = __fsub_rn(y, f.y);
      count += __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) < t;
    }
  }
  if (live) out[u] = count;
}

}  // namespace

// out[u] for u < n_users against n_facilities facilities.  The caller
// never passes n_users == 0.  Launches on `stream`, allocates nothing,
// does not synchronize, and returns cudaGetLastError().
extern "C" int rank_count(const void* xs, const void* ys, const void* thr,
                          const void* fx, const void* fy, void* out,
                          long long n_users, int n_facilities, void* stream) {
  const dim3 grid(static_cast<unsigned>((n_users + kThreads - 1) / kThreads));
  rank_count_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xs), static_cast<const float*>(ys),
      static_cast<const float*>(thr), static_cast<const float*>(fx),
      static_cast<const float*>(fy), static_cast<int32_t*>(out),
      static_cast<int64_t>(n_users), n_facilities);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rank_count_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
