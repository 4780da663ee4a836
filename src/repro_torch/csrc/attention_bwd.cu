// The backward of flash attention (flash_bwd) for Hopper, sm_90a: row 9
// of the kernel table.
//
// It replaces src/repro/models/attention.py:223 _flash_fused_bwd, the jnp
// custom-VJP backward of flash_attention_fused (not a Pallas site): from
// the forward's residuals q, k, v, out (bf16) and lse (f32) and the
// output's gradient dO it gives dq [B, S, K, G, D] and dk, dv
// [B, Skv, K, D], in bf16, every sum in f32:
//   delta_i = sum_d dO_id O_id           (O the bf16 out, as JAX reads it)
//   P_ij    = exp(s_ij - lse_i),  s_ij = scale q_i . k_j, 0 where masked
//   dV_j    = sum_i P_ij dO_i
//   dP_ij   = dO_i . v_j,   dS_ij = P_ij (dP_ij - delta_i)
//   dQ_i    = scale sum_j dS_ij k_j,   dK_j = scale sum_i dS_ij q_i
// Rows i are the (position, query head) pairs of one KV head, row
// r = s G + g at position s, head g, as in the forward kernels; a key j is
// masked where j >= Skv or, causal, j > s.  P is recomputed in base 2 as
// the forward's wgmma kernel makes it: exp2(s_ij scale log2 e - lse_i
// log2 e), by ex2.approx.
//
// What bounds it: operations.  The function needs five products of
// 2 B H D S^2 / 2 FLOPs each under the causal mask (S^2 without it) on
// the bf16 tensor cores at 989 TFLOP/s; its bytes (q, k, v, out, dO, dq,
// dk, dv and lse once) take a small fraction of that time at S = 2,048.
//
// Design: simple, right and deterministic (no atomics: every output element
// is written by one block, so two launches on the same inputs agree bit for
// bit).  Three kernels on one stream in one call:
//   1. flash_bwd_delta_kernel: delta [B, K, G, S] f32, 16 threads a row.
//   2. flash_bwd_dkdv_kernel: one block per (64-key tile, KV head, row b).
//      K and V tiles stay in shared memory; the block walks every 64-row
//      tile of (position, head) rows that can see a key of its tile (all
//      G heads of the group), staging Q, dO, lse and delta of each, and each
//      of its 4 warps owns 16 keys: S^T = K Q^T, P^T, dV += P^T dO,
//      dP^T = V dO^T, dS^T, dK += dS^T Q, the accumulators in registers.
//   3. flash_bwd_dq_kernel: one block per (64-row tile, KV head, row b),
//      Q and dO in shared memory, each warp owning 16 rows; it walks the
//      64-key tiles up to the diagonal: S = Q K^T, P, dP = dO V^T, dS,
//      dQ += dS K.
// So the backward does seven products where a one-pass one would do five
// (S and dP twice); the later redesign (wgmma, TMA, one pass with a dQ
// reduction) is to be judged against this kernel.  Every product is
// mma.sync m16n8k16 bf16 -> f32, fragments as flash_fwd_mma_kernel in
// attention.cu loads them: 32-bit loads of A and of B whose k runs along a
// row, ldmatrix.trans where B's k runs down the rows.  P and dS meet their
// second operand once in bf16, as P meets V in the forward.  Tiles in
// shared memory are rows of D + 8 bf16 (the fragment loads hit 32 banks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <cmath>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTile = 64;  // keys of a key tile and rows of a row tile
constexpr int kWarps = kTile / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kDeltaRows = 16;  // rows of a delta block: 16 threads a row

// cudaFuncSetAttribute for a kernel's dynamic shared memory, once per
// kernel and device.
template <auto Kernel>
cudaError_t smem_limit_once(size_t bytes) {
  static std::atomic<uint32_t> done{0};  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint32_t bit = 1u << (dev & 31);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU instruction, as the forward's wgmma kernel takes it
// (2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// A fragment (16 x 16, row-major) of tile rows row0 .. row0 + 15, columns
// c0 .. c0 + 15.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* t, int ld,
                                       int row0, int c0, int grp, int tig) {
  const __nv_bfloat16* p0 = t + (row0 + grp) * ld + c0 + tig * 2;
  const __nv_bfloat16* p1 = p0 + 8 * ld;
  a[0] = *reinterpret_cast<const uint32_t*>(p0);
  a[1] = *reinterpret_cast<const uint32_t*>(p1);
  a[2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
}

// B fragment (16 x 8) whose k runs along a tile row: B[k][n] = t[n0 + n][c0 + k].
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1, const __nv_bfloat16* t, int ld,
                                       int n0, int c0, int grp, int tig) {
  const __nv_bfloat16* p = t + (n0 + grp) * ld + c0 + tig * 2;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragments of two n-tiles whose k runs down the tile's rows:
// B[k][n] = t[k0 + k][d0 + n] for n < 8 (b[0], b[1]) and n >= 8 (b[2], b[3]).
// ldmatrix.trans: lanes 8i .. 8i + 7 point at the rows of 8x8 matrix i,
// (rows 0-7, cols d0), (8-15, d0), (0-7, d0 + 8), (8-15, d0 + 8).
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], const __nv_bfloat16* t, int ld, int k0,
                                        int d0, int lane) {
  const int row = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t addr = static_cast<uint32_t>(
      __cvta_generic_to_shared(t + row * ld + d0 + (lane >> 4) * 8));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(addr));
}

// The A fragment of k-step kc (16 of the accumulator's columns) from a
// 16 x 64 accumulator in registers, in bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c)[kTile / 8][4],
                                         int kc) {
  a[0] = pack_bf16x2(c[2 * kc][0], c[2 * kc][1]);
  a[1] = pack_bf16x2(c[2 * kc][2], c[2 * kc][3]);
  a[2] = pack_bf16x2(c[2 * kc + 1][0], c[2 * kc + 1][1]);
  a[3] = pack_bf16x2(c[2 * kc + 1][2], c[2 * kc + 1][3]);
}

// Offset of row r = s G + g of the (b, kh) group in a [B, S, K, G, D] tensor.
__device__ __forceinline__ size_t q_row(int b, int r, int S, int K, int kh, int G, int D) {
  const int s = r / G, g = r % G;
  return ((((size_t)b * S + s) * K + kh) * G + g) * D;
}

// Index of row r = s G + g of the (b, kh) group in a [B, K, G, S] tensor.
__device__ __forceinline__ size_t lse_row(int b, int r, int S, int K, int kh, int G) {
  const int s = r / G, g = r % G;
  return (((size_t)b * K + kh) * G + g) * S + s;
}

// rows rows0 .. rows0 + 63 of a [B, S, K, G, D] tensor into a tile (zeros
// past the group's S G rows)
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* tile, const __nv_bfloat16* src, int b,
                                           int rows0, int S, int K, int kh, int G) {
  constexpr int LD = D + 8, CH = D / 8;
  for (int c = threadIdx.x; c < kTile * CH; c += kThreads) {
    const int r = c / CH, part = c % CH, row = rows0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < S * G)
      val = *reinterpret_cast<const uint4*>(src + q_row(b, row, S, K, kh, G, D) + part * 8);
    *reinterpret_cast<uint4*>(tile + r * LD + part * 8) = val;
  }
}

// keys kt0 .. kt0 + 63 of a [B, Skv, K, D] tensor into a tile (zeros past Skv)
template <int D>
__device__ __forceinline__ void stage_keys(__nv_bfloat16* tile, const __nv_bfloat16* src, int b,
                                           int kt0, int Skv, int K, int kh) {
  constexpr int LD = D + 8, CH = D / 8;
  for (int c = threadIdx.x; c < kTile * CH; c += kThreads) {
    const int r = c / CH, part = c % CH, key = kt0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (key < Skv)
      val = *reinterpret_cast<const uint4*>(src + (((size_t)b * Skv + key) * K + kh) * D +
                                            part * 8);
    *reinterpret_cast<uint4*>(tile + r * LD + part * 8) = val;
  }
}

// ---- 1. delta = rowsum(dO * O) ----------------------------------------------

template <int NK>  // D = 16 * NK: 2 NK chunks of 8 a row, at most 16
__global__ void __launch_bounds__(32 * kDeltaRows / 2) flash_bwd_delta_kernel(
    const __nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ dout,
    float* __restrict__ delta, long long n_rows, int S, int K, int G) {
  constexpr int D = 16 * NK;
  const long long row = (long long)blockIdx.x * kDeltaRows + threadIdx.x / 16;
  const int part = threadIdx.x % 16;
  float acc = 0.f;
  if (row < n_rows && part < 2 * NK) {
    const uint4 o = *reinterpret_cast<const uint4*>(out + row * D + part * 8);
    const uint4 d = *reinterpret_cast<const uint4*>(dout + row * D + part * 8);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&o);
    const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 of = __bfloat1622float2(op[i]), df = __bfloat1622float2(dp[i]);
      acc += df.x * of.x + df.y * of.y;
    }
  }
  // the 16 threads of a row: one half of a warp
  acc += __shfl_xor_sync(0xffffffffu, acc, 8);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (row < n_rows && part == 0) {
    // row = ((b S + s) K + kh) G + g
    const int g = (int)(row % G);
    long long t = row / G;
    const int kh = (int)(t % K);
    t /= K;
    const int s = (int)(t % S);
    const long long b = t / S;
    delta[((b * K + kh) * G + g) * S + s] = acc;
  }
}

// ---- 2. dK and dV: one block per (key tile, KV head, row b) ------------------

template <int NK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk_out, __nv_bfloat16* __restrict__ dv_out, int S, int Skv, int K,
    int G, int causal, float scale) {
  constexpr int D = 16 * NK;
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kTile][LD]
  __nv_bfloat16* Vs = Ks + kTile * LD;
  __nv_bfloat16* Qs = Vs + kTile * LD;
  __nv_bfloat16* Os = Qs + kTile * LD;                   // dO
  float* Ls = reinterpret_cast<float*>(Os + kTile * LD);  // lse in base 2, +inf past the rows
  float* Ds = Ls + kTile;                                // delta
  int* Ps = reinterpret_cast<int*>(Ds + kTile);          // positions

  const int kt0 = blockIdx.x * kTile, kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int rows = S * G;
  const float scale_log2 = scale * kLog2e;

  stage_keys<D>(Ks, k, b, kt0, Skv, K, kh);
  stage_keys<D>(Vs, v, b, kt0, Skv, K, kh);

  // this thread's two keys: the rows of its accumulators
  const int key0 = kt0 + warp * 16 + grp, key1 = key0 + 8;
  float dk[2 * NK][4], dv[2 * NK][4];
#pragma unroll
  for (int nd = 0; nd < 2 * NK; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;

  // causal: only positions s >= kt0 see a key of the tile
  const int first = causal ? min(kt0, S) * G / kTile : 0;
  const int n_tiles = (rows + kTile - 1) / kTile;
  for (int t = first; t < n_tiles; ++t) {
    const int r0 = t * kTile;
    __syncthreads();  // the previous tile's readers are done
    stage_rows<D>(Qs, q, b, r0, S, K, kh, G);
    stage_rows<D>(Os, dout, b, r0, S, K, kh, G);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const int row = r0 + r;
      const bool real = row < rows;
      const size_t i = real ? lse_row(b, row, S, K, kh, G) : 0;
      Ls[r] = real ? lse[i] * kLog2e : INFINITY;  // exp2(x - inf) = 0: no P past the rows
      Ds[r] = real ? delta[i] : 0.f;
      Ps[r] = real ? row / G : 0x7fffffff;
    }
    __syncthreads();

    // S^T = K Q^T: this warp's 16 keys x the tile's 64 rows
    float st[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t a[4];
      load_a(a, Ks, LD, warp * 16, kk * 16, grp, tig);
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        uint32_t b0, b1;
        load_b(b0, b1, Qs, LD, nt * 8, kk * 16, grp, tig);
        mma_bf16(st[nt], a, b0, b1);
      }
    }
    // P^T = exp2(S^T scale log2 e - lse log2 e), 0 where masked
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = nt * 8 + tig * 2 + (e & 1);
        const int key = e < 2 ? key0 : key1;
        const bool masked = key >= Skv || (causal && key > Ps[r]);
        st[nt][e] = masked ? 0.f : ex2(fmaf(st[nt][e], scale_log2, -Ls[r]));
      }
    // dV += P^T dO
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      uint32_t pa[4];
      acc_to_a(pa, st, kc);
#pragma unroll
      for (int nd = 0; nd < 2 * NK; nd += 2) {
        uint32_t bb[4];
        load_bt(bb, Os, LD, kc * 16, nd * 8, lane);
        mma_bf16(dv[nd], pa, bb[0], bb[1]);
        mma_bf16(dv[nd + 1], pa, bb[2], bb[3]);
      }
    }
    // dP^T = V dO^T
    float dpt[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t a[4];
      load_a(a, Vs, LD, warp * 16, kk * 16, grp, tig);
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        uint32_t b0, b1;
        load_b(b0, b1, Os, LD, nt * 8, kk * 16, grp, tig);
        mma_bf16(dpt[nt], a, b0, b1);
      }
    }
    // dS^T = P^T (dP^T - delta)
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = nt * 8 + tig * 2 + (e & 1);
        dpt[nt][e] = st[nt][e] * (dpt[nt][e] - Ds[r]);
      }
    // dK += dS^T Q (scaled once at the end)
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      uint32_t da[4];
      acc_to_a(da, dpt, kc);
#pragma unroll
      for (int nd = 0; nd < 2 * NK; nd += 2) {
        uint32_t bb[4];
        load_bt(bb, Qs, LD, kc * 16, nd * 8, lane);
        mma_bf16(dk[nd], da, bb[0], bb[1]);
        mma_bf16(dk[nd + 1], da, bb[2], bb[3]);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? key1 : key0;
    if (key >= Skv) continue;
    const size_t off = (((size_t)b * Skv + key) * K + kh) * D + tig * 2;
#pragma unroll
    for (int nd = 0; nd < 2 * NK; ++nd) {
      *reinterpret_cast<__nv_bfloat162*>(dk_out + off + nd * 8) = __floats2bfloat162_rn(
          dk[nd][2 * half] * scale, dk[nd][2 * half + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv_out + off + nd * 8) =
          __floats2bfloat162_rn(dv[nd][2 * half], dv[nd][2 * half + 1]);
    }
  }
}

// ---- 3. dQ: one block per (row tile, KV head, row b) -------------------------

template <int NK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq_out, int S, int Skv, int K, int G, int causal, float scale) {
  constexpr int D = 16 * NK;
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kTile][LD]
  __nv_bfloat16* Os = Qs + kTile * LD;                               // dO
  __nv_bfloat16* Ks = Os + kTile * LD;
  __nv_bfloat16* Vs = Ks + kTile * LD;

  const int rows = S * G;
  // the row tiles with the most key tiles under the causal mask start first
  const int r0 = ((rows + kTile - 1) / kTile - 1 - (int)blockIdx.x) * kTile;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const float scale_log2 = scale * kLog2e;

  stage_rows<D>(Qs, q, b, r0, S, K, kh, G);
  stage_rows<D>(Os, dout, b, r0, S, K, kh, G);

  // this thread's two rows; rows past the group's have lse2 = +inf (P = 0)
  const int ra = r0 + warp * 16 + grp, rb = ra + 8;
  const bool real_a = ra < rows, real_b = rb < rows;
  const float lse_a = real_a ? lse[lse_row(b, ra, S, K, kh, G)] * kLog2e : INFINITY;
  const float lse_b = real_b ? lse[lse_row(b, rb, S, K, kh, G)] * kLog2e : INFINITY;
  const float delta_a = real_a ? delta[lse_row(b, ra, S, K, kh, G)] : 0.f;
  const float delta_b = real_b ? delta[lse_row(b, rb, S, K, kh, G)] : 0.f;
  const int pos_a = real_a ? ra / G : 0x7fffffff, pos_b = real_b ? rb / G : 0x7fffffff;

  float dq[2 * NK][4];
#pragma unroll
  for (int nd = 0; nd < 2 * NK; ++nd) dq[nd][0] = dq[nd][1] = dq[nd][2] = dq[nd][3] = 0.f;

  // causal: the tile's last position sees keys up to itself
  const int kv_end = causal ? min(Skv, (min(r0 + kTile, rows) - 1) / G + 1) : Skv;
  for (int kt0 = 0; kt0 < kv_end; kt0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    stage_keys<D>(Ks, k, b, kt0, Skv, K, kh);
    stage_keys<D>(Vs, v, b, kt0, Skv, K, kh);
    __syncthreads();

    // S = Q K^T: this warp's 16 rows x the tile's 64 keys
    float s[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t a[4];
      load_a(a, Qs, LD, warp * 16, kk * 16, grp, tig);
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        uint32_t b0, b1;
        load_b(b0, b1, Ks, LD, nt * 8, kk * 16, grp, tig);
        mma_bf16(s[nt], a, b0, b1);
      }
    }
    // P, 0 where masked
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt0 + nt * 8 + tig * 2 + (e & 1);
        const bool masked = key >= Skv || (causal && key > (e < 2 ? pos_a : pos_b));
        s[nt][e] = masked ? 0.f : ex2(fmaf(s[nt][e], scale_log2, e < 2 ? -lse_a : -lse_b));
      }
    // dP = dO V^T
    float dp[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t a[4];
      load_a(a, Os, LD, warp * 16, kk * 16, grp, tig);
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        uint32_t b0, b1;
        load_b(b0, b1, Vs, LD, nt * 8, kk * 16, grp, tig);
        mma_bf16(dp[nt], a, b0, b1);
      }
    }
    // dS = P (dP - delta)
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      dp[nt][0] = s[nt][0] * (dp[nt][0] - delta_a);
      dp[nt][1] = s[nt][1] * (dp[nt][1] - delta_a);
      dp[nt][2] = s[nt][2] * (dp[nt][2] - delta_b);
      dp[nt][3] = s[nt][3] * (dp[nt][3] - delta_b);
    }
    // dQ += dS K (scaled once at the end)
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      uint32_t da[4];
      acc_to_a(da, dp, kc);
#pragma unroll
      for (int nd = 0; nd < 2 * NK; nd += 2) {
        uint32_t bb[4];
        load_bt(bb, Ks, LD, kc * 16, nd * 8, lane);
        mma_bf16(dq[nd], da, bb[0], bb[1]);
        mma_bf16(dq[nd + 1], da, bb[2], bb[3]);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    if (r >= rows) continue;
    const size_t off = q_row(b, r, S, K, kh, G, D) + tig * 2;
#pragma unroll
    for (int nd = 0; nd < 2 * NK; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(dq_out + off + nd * 8) = __floats2bfloat162_rn(
          dq[nd][2 * half] * scale, dq[nd][2 * half + 1] * scale);
  }
}

template <int NK>
cudaError_t launch_bwd(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                       const __nv_bfloat16* out, const __nv_bfloat16* dout, const float* lse,
                       float* delta, __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
                       int B, int S, int Skv, int K, int G, int causal, float scale,
                       cudaStream_t stream) {
  constexpr int D = 16 * NK;
  constexpr size_t tiles = (size_t)4 * kTile * (D + 8) * sizeof(__nv_bfloat16);
  constexpr size_t smem_dkdv = tiles + 3 * kTile * sizeof(float);
  cudaError_t err = smem_limit_once<flash_bwd_dkdv_kernel<NK>>(smem_dkdv);
  if (err != cudaSuccess) return err;
  if ((err = smem_limit_once<flash_bwd_dq_kernel<NK>>(tiles)) != cudaSuccess) return err;

  const long long n_rows = (long long)B * S * K * G;
  const long long delta_blocks = (n_rows + kDeltaRows - 1) / kDeltaRows;
  const long long row_tiles = ((long long)S * G + kTile - 1) / kTile;
  if (delta_blocks > 0x7fffffffLL || row_tiles > 0x7fffffffLL || K > 65535 || B > 65535)
    return cudaErrorInvalidConfiguration;
  flash_bwd_delta_kernel<NK><<<(unsigned)delta_blocks, 32 * kDeltaRows / 2, 0, stream>>>(
      out, dout, delta, n_rows, S, K, G);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid_kv((unsigned)((Skv + kTile - 1) / kTile), (unsigned)K, (unsigned)B);
  flash_bwd_dkdv_kernel<NK><<<grid_kv, kThreads, smem_dkdv, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, S, Skv, K, G, causal, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid_q((unsigned)row_tiles, (unsigned)K, (unsigned)B);
  flash_bwd_dq_kernel<NK><<<grid_q, kThreads, tiles, stream>>>(q, k, v, dout, lse, delta, dq, S,
                                                               Skv, K, G, causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches flash_bwd on `stream`: the delta pass, then dK and dV, then dQ.
// D = 16 * nk with 1 <= nk <= 8, G <= 128; q, out, dout, dq [B, S, K, G, D]
// and k, v, dk, dv [B, Skv, K, D] bf16, lse [B, K, G, S] f32 (natural log
// units), delta [B, K, G, S] f32 workspace; all pointers 16-byte aligned
// (the wrapper checks).  Returns a cudaError_t.
int flash_bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
              const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int S, int Skv,
              int K, int G, int D, int causal, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || K <= 0 || G <= 0 || G > 128 || D % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* op = static_cast<const __nv_bfloat16*>(out);
  const auto* dop = static_cast<const __nv_bfloat16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  auto* dqp = static_cast<__nv_bfloat16*>(dq);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (D / 16) {
#define BWD_CASE(n)                                                                        \
  case n:                                                                                  \
    return static_cast<int>(launch_bwd<n>(qp, kp, vp, op, dop, lp, dl, dqp, dkp, dvp, B, S, \
                                          Skv, K, G, causal, scale, st));
    BWD_CASE(1) BWD_CASE(2) BWD_CASE(3) BWD_CASE(4) BWD_CASE(5) BWD_CASE(6) BWD_CASE(7)
    BWD_CASE(8)
#undef BWD_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
