// The RG-LRU's linear recurrence (RecurrentGemma's recurrent block), for
// Hopper, sm_90a: row 14 of the kernel table.
//
// It replaces src/repro/models/rglru.py:84 _rglru_scan after its gates (the
// jnp elementwise terms and a lax.associative_scan, not a Pallas site), and
// the same terms of rglru_block_decode (:122) at S = 1.  Layouts, all
// contiguous: r, i [B, S, w] f32 (the gates), h [B, S, w] bf16 or f32 (the
// causal conv's output), lam [w] f32 (Λ), init [B, w] f32 or null; out
// y [B, S, w] f32 and state [B, w] f32 (y at t = S - 1).  For each (b, t, c):
//
//   log a_t = (c_exp r_t) log σ(Λ_c),   c_exp = 8
//   a_t     = exp(log a_t)
//   β_t     = sqrt(max(1 - a_t a_t, 1e-12))
//   x_t     = (β_t i_t) h_t
//   y_t     = a_t y_{t-1} + x_t,        y_{-1} = init (or 0)
//
// which at t = 0 is x_0 + a_0 init, what JAX adds to xin[:, 0] before its
// scan, and at S = 1 the decode step's a state + β i h.  Every operation
// rounds once (__f*_rn: no fused multiply-add), so the kernel differs from
// the associative scan only in the order of the recurrence's roundings.
//
// What bounds it: bytes.  Each element reads r, i (4 bytes each) and h (2)
// and writes y (4): 14 bytes, 1.88 GB at B = 8, S = 4,096, w = 4,096
// (0.56 ms at 3.35 TB/s); its 12 or so operations an element are far below
// the card's rate.  One thread takes one (b, channel) and walks t, so the
// recurrence needs no communication; neighbouring threads take neighbouring
// channels, so each load of a warp is 128 contiguous bytes (64 for bf16 h).
// The recurrence is serial in t but its loads are not: each thread loads
// kUnroll time steps of r, i and h into registers before it computes them,
// so 3 x kUnroll loads a thread are in flight.  It stays latency-bound
// (about 2x its bound at B = 8): a chunked scan (chunk carries, then a
// fix-up) would give more threads but moves 24 or more bytes an element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// 64 channels a block and 16 steps of loads in flight: the card has only
// B x w chains (32,768 at B = 8), about 8 warps an SM, so each thread must
// keep many loads in flight (128-channel blocks or 8 steps were slower on
// an H100, and so was double-buffering the registers at 16 steps)
constexpr int kThreads = 64;  // channels of a block
constexpr int kUnroll = 16;   // time steps whose loads are issued together
constexpr float kExp = 8.0f;   // c in a_t = a^(c r_t) (repro.models.rglru._C)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// log σ(λ) = -softplus(-λ), as min(λ, 0) - log1p(exp(-|λ|)).
__device__ __forceinline__ float log_sigmoid(float lam) {
  return __fsub_rn(fminf(lam, 0.f), log1pf(expf(-fabsf(lam))));
}

template <typename H>
__global__ void __launch_bounds__(kThreads) rglru_scan_kernel(
    const float* __restrict__ r, const float* __restrict__ gi, const H* __restrict__ h,
    const float* __restrict__ lam, const float* __restrict__ init, float* __restrict__ y,
    float* __restrict__ state, int S, int w) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= w) return;
  const float la = log_sigmoid(lam[c]);
  float acc = init != nullptr ? init[(size_t)b * w + c] : 0.f;
  const size_t base = (size_t)b * S * w + c;
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    float rv[kUnroll], iv[kUnroll], hv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < S) {
        const size_t off = base + (size_t)(t0 + u) * w;
        rv[u] = __ldg(r + off);
        iv[u] = __ldg(gi + off);
        hv[u] = to_f32(h[off]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < S) {
        const float at = expf(__fmul_rn(__fmul_rn(kExp, rv[u]), la));
        const float beta = __fsqrt_rn(fmaxf(__fsub_rn(1.f, __fmul_rn(at, at)), 1e-12f));
        const float x = __fmul_rn(__fmul_rn(beta, iv[u]), hv[u]);
        acc = __fadd_rn(__fmul_rn(at, acc), x);
        y[base + (size_t)(t0 + u) * w] = acc;
      }
    }
  }
  state[(size_t)b * w + c] = acc;
}

}  // namespace

extern "C" {

// Launches the scan on `stream`.  h_f32: 1 if h is float32, 0 if bf16.
// init may be null (a zero state).  Returns a cudaError_t.
int rglru_scan(const void* r, const void* i, const void* h, int h_f32, const void* lam,
               const void* init, void* y, void* state, int B, int S, int w, void* stream) {
  if (B <= 0 || S <= 0 || w <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)((w + kThreads - 1) / kThreads), (unsigned)B);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* rp = static_cast<const float*>(r);
  const auto* ip = static_cast<const float*>(i);
  const auto* lp = static_cast<const float*>(lam);
  const auto* sp = static_cast<const float*>(init);
  auto* yp = static_cast<float*>(y);
  auto* op = static_cast<float*>(state);
  if (h_f32)
    rglru_scan_kernel<float><<<grid, kThreads, 0, st>>>(rp, ip, static_cast<const float*>(h), lp,
                                                        sp, yp, op, S, w);
  else
    rglru_scan_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        rp, ip, static_cast<const __nv_bfloat16*>(h), lp, sp, yp, op, S, w);
  return static_cast<int>(cudaGetLastError());
}

const char* rglru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
