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
// Rows i are the (position, query head) pairs of one KV head (a "pair" is
// one (b, KV head)); a key j is masked where j >= Skv or, causal, j > the
// row's position.  P is recomputed in base 2 as the forward's wgmma kernel
// makes it, exp2(s_ij scale log2 e - lse_i log2 e) by ex2.approx, and meets
// its second operand once in bf16 (P^T and dS^T as the A operand).
//
// What bounds it: operations.  The function needs five products of
// 2 B H D S^2 / 2 FLOPs each under the causal mask (S^2 without it) on the
// bf16 tensor cores at 989 TFLOP/s; its bytes (q, k, v, out, dO, dq, dk, dv
// and lse once) take a small fraction of that time at S = 2,048.  This
// design does seven (S and dP in both passes): its own bound is 7/5 of it.
//
// D = 64 and 128 (every config of the repo) run four kernels on one stream,
// shaped as flash_fwd_wgmma_kernel (attention.cu): persistent CTAs of a
// producer warpgroup that issues TMA loads into mbarrier rings and gives
// its registers away (setmaxnreg 24/240), and two consumer warpgroups that
// run every product by wgmma from 128-byte-swizzled shared memory.
//   1. flash_bwd_delta_kernel: lse in base 2 and delta = rowsum(dO O), by
//      row tile: slot (pair, t, c) of the 64-column row tile t, so that a
//      tile's lse and delta are one contiguous run of 64 floats each (one
//      bulk copy), +inf and 0 where a slot has no row.  A row tile is npos
//      positions by gsub heads (gsub = min(G, 64), npos = 64 / gsub): one
//      5-d TMA box of q or dO.
//   2. flash_bwd_dkdv_kernel: a work item is one tile of 128 keys of one
//      pair against a run of its row tiles; its K and V stay in shared
//      memory and each consumer owns 64 keys.  Per row tile, S^T = K Q^T and
//      dP^T = V dO^T (both operands K-major), then in registers P^T and
//      dS^T = P^T (dP^T - delta), then dV += P^T dO and dK += dS^T Q, P^T and
//      dS^T as the register A operand and dO and Q read MN-major: no
//      transpose anywhere.  The two consumers take turns to issue their
//      products (ping-pong), so one's run while the other computes.  Under
//      the causal mask key tile j meets fewer row tiles the larger j is, so
//      the wrapper's plan (kernels/attention.py flash_bwd_plan) lays the
//      (key tile, pair) runs end to end and cuts them into two segments a
//      CTA of equal cost (row tiles plus two for each item's K and V load
//      and epilogue): no item is longer than about half a CTA's share and
//      the CTAs finish together.  A run cut at a segment's end becomes
//      chunks; an item that is its run's only chunk writes dK and dV, the
//      others write f32 partials to their own slot of the workspace.
//   3. flash_bwd_reduce_kernel: for each (key tile, pair) of several chunks,
//      dK = scale sum_c part_c and dV = sum_c part_c, from chunk 0 up, 16
//      keys a block.
//   4. flash_bwd_dq_kernel: a work item is 128 rows (two consumers of 64),
//      Q and dO resident, K and V tiles of 128 keys through the ring:
//      S = Q K^T, dP = dO V^T, dS, dQ += dS K (K read MN-major); items with
//      the most key tiles first, in rounds that zigzag across the CTAs.
// Deterministic: every output element and every partial is written by one
// thread of one CTA, whose sums run in a fixed order (the row tiles of an
// item in order, the wgmma k-steps in order); the partials are summed in
// chunk order by one thread; no atomics.  Which CTA takes an item changes
// nothing of its value.  So two launches on the same inputs agree bit for
// bit, under CUDA graph capture too (the plan lives in device memory the
// wrapper keeps; no counter needs resetting).
//
// Other head dims (16 to 112 but 64) keep the first kernels, mma.sync
// m16n8k16 on tiles staged by plain loads: flash_bwd_mma_delta_kernel
// (delta [B, K, G, S]), flash_bwd_mma_dkdv_kernel (a block per 64-key tile,
// pair, walking every row tile that sees it) and flash_bwd_mma_dq_kernel (a
// block per 64-row tile).  Tiles in shared memory are rows of D + 8 bf16
// (the fragment loads hit 32 banks).

#include "hopper.cuh"  // mbarriers, TMA, wgmma, mma.sync, ex2

#include <cmath>

namespace {

constexpr int kTile = 64;  // keys of a key tile and rows of a row tile
constexpr int kWarps = kTile / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kDeltaRows = 16;  // rows of a delta block: 16 threads a row

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

// ---- mma.sync 1. delta = rowsum(dO * O) [B, K, G, S] ----------------------

template <int NK>  // D = 16 * NK: 2 NK chunks of 8 a row, at most 16
__global__ void __launch_bounds__(32 * kDeltaRows / 2) flash_bwd_mma_delta_kernel(
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

// ---- mma.sync 2. dK and dV: one block per (key tile, KV head, row b) ---------

template <int NK>
__global__ void __launch_bounds__(kThreads) flash_bwd_mma_dkdv_kernel(
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

// ---- mma.sync 3. dQ: one block per (row tile, KV head, row b) ----------------

template <int NK>
__global__ void __launch_bounds__(kThreads) flash_bwd_mma_dq_kernel(
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
cudaError_t launch_bwd_mma(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                       const __nv_bfloat16* out, const __nv_bfloat16* dout, const float* lse,
                       float* delta, __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv,
                       int B, int S, int Skv, int K, int G, int causal, float scale,
                       cudaStream_t stream) {
  constexpr int D = 16 * NK;
  constexpr size_t tiles = (size_t)4 * kTile * (D + 8) * sizeof(__nv_bfloat16);
  constexpr size_t smem_dkdv = tiles + 3 * kTile * sizeof(float);
  cudaError_t err = smem_limit_once<flash_bwd_mma_dkdv_kernel<NK>>(smem_dkdv);
  if (err != cudaSuccess) return err;
  if ((err = smem_limit_once<flash_bwd_mma_dq_kernel<NK>>(tiles)) != cudaSuccess) return err;

  const long long n_rows = (long long)B * S * K * G;
  const long long delta_blocks = (n_rows + kDeltaRows - 1) / kDeltaRows;
  const long long row_tiles = ((long long)S * G + kTile - 1) / kTile;
  if (delta_blocks > 0x7fffffffLL || row_tiles > 0x7fffffffLL || K > 65535 || B > 65535)
    return cudaErrorInvalidConfiguration;
  flash_bwd_mma_delta_kernel<NK><<<(unsigned)delta_blocks, 32 * kDeltaRows / 2, 0, stream>>>(
      out, dout, delta, n_rows, S, K, G);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid_kv((unsigned)((Skv + kTile - 1) / kTile), (unsigned)K, (unsigned)B);
  flash_bwd_mma_dkdv_kernel<NK><<<grid_kv, kThreads, smem_dkdv, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, S, Skv, K, G, causal, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid_q((unsigned)row_tiles, (unsigned)K, (unsigned)B);
  flash_bwd_mma_dq_kernel<NK><<<grid_q, kThreads, tiles, stream>>>(q, k, v, dout, lse, delta, dq, S,
                                                               Skv, K, G, causal, scale);
  return cudaGetLastError();
}
// ---- wgmma (D = 64, 128): a planned persistent dK/dV pass and a dQ pass ------

constexpr int kBwKeys = 128;     // keys of a dK/dV work item: two consumers of 64
constexpr int kBwRows = 64;      // rows of a row tile of the dK/dV pass
constexpr int kBwStages = 4;     // the dK/dV pass's ring of row tiles
constexpr int kDqRows = 128;     // rows of a dQ work item: two consumers of 64
constexpr int kDqKeys = 128;     // keys of a K and V tile of the dQ pass
constexpr int kDqStages = 2;     // the dQ pass's ring of K and V tiles
constexpr int kItemInts = 5;     // a planned item: key tile, pair, first and end row tile, slot
constexpr int kNoPos = 0x3fffffff;  // the position of a row past the real ones: never masked
// two consumer warpgroups, then the producer warpgroup, which gives its
// registers to the consumers (setmaxnreg), as in flash_fwd_wgmma_kernel
constexpr int kBwThreads = 384;
constexpr int kBwProducerRegs = 24;  // 128 x 24 + 256 x 240 <= 65,536
constexpr int kBwConsumerRegs = 240;
constexpr int kBwDeltaSlots = 16;    // tile slots of a delta block: 16 threads a slot
constexpr int kReduceKeys = 16;      // keys of a block of the partials' sum

// The dK/dV pass's shared memory, in bytes.  Every tile is stored as 64-wide
// column halves of 128-byte rows, each half 1024-byte aligned, as TMA's
// 128-byte swizzle writes them.  K and V stay for a work item; a stage of the
// ring holds one row tile's Q and dO, then its lse (base 2) and delta.
template <int D>
struct BkSmem {
  static constexpr int kHalves = D / 64;
  static constexpr int kKvHalf = kBwKeys * 128;
  static constexpr int kRowHalf = kBwRows * 128;
  static constexpr int kK = 0;
  static constexpr int kV = kHalves * kKvHalf;
  static constexpr int kRing = 2 * kHalves * kKvHalf;
  static constexpr int kStQ = 0;
  static constexpr int kStO = kHalves * kRowHalf;
  static constexpr int kStLse = 2 * kHalves * kRowHalf;
  static constexpr int kStDelta = kStLse + kBwRows * 4;
  static constexpr int kStage = (kStDelta + kBwRows * 4 + 1023) / 1024 * 1024;
  static constexpr int kColPos = kRing + kBwStages * kStage;  // int[64]: a column's position
  static constexpr int kBar = kColPos + kBwRows * 4;  // kv_full, kv_empty, full[], empty[]
  static constexpr int kBytes = kBar + 16 + 16 * kBwStages + 1024;  // and room to align
};

// The dQ pass's: Q and dO stay for a work item, K and V tiles go through the ring.
template <int D>
struct DqSmem {
  static constexpr int kHalves = D / 64;
  static constexpr int kRowHalf = kDqRows * 128;
  static constexpr int kKeyHalf = kDqKeys * 128;
  static constexpr int kTile = kHalves * kKeyHalf;
  static constexpr int kQ = 0;
  static constexpr int kO = kHalves * kRowHalf;
  static constexpr int kK = 2 * kHalves * kRowHalf;
  static constexpr int kV = kK + kDqStages * kTile;
  static constexpr int kBar = kV + kDqStages * kTile;  // q_full, q_empty, full[], empty[]
  static constexpr int kBytes = kBar + 16 + 16 * kDqStages + 1024;
};

// D[64 x D] += A[64 x 16] . B[16 x D]; A in registers, B MN-major (its
// 64-wide halves `lbo` bytes apart)
template <int D>
__device__ __forceinline__ void wgmma_rs_d(float (&d)[D / 2], const uint32_t (&a)[4],
                                           uint32_t b_addr, uint32_t lbo) {
  if constexpr (D == 128) {
    wgmma_rs_n128(d, a, sw128_desc(b_addr, lbo));
  } else {
    wgmma_rs_n64(d, a, sw128_desc(b_addr, lbo));
  }
}

// A 64 x 16 KS accumulator in bf16 as the A operand of KS 16-deep steps:
// its columns 16 kk .. 16 kk + 15 are the A fragment of step kk
template <int KS>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[KS][4], const float (&c)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pack_bf16x2(c[8 * kk], c[8 * kk + 1]);
    a[kk][1] = pack_bf16x2(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack_bf16x2(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack_bf16x2(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// The row tiles of the dK/dV pass: a tile is `npos` positions by `gsub`
// heads of one (b, KV head) pair, gsub = min(G, 64) and npos = 64 / gsub
// (G > 64: one position's heads in ceil(G / 64) tiles), so that one 5-d TMA
// box of q or dO loads it; tile t holds positions (t / n_gblk) npos + c / gsub
// and heads (t % n_gblk) gsub + c % gsub at its column c < gsub npos.
struct RowTiles {
  int gsub, npos, n_gblk, n_rt;
};

__host__ __device__ inline RowTiles row_tiles(int S, int G) {
  RowTiles r;
  r.gsub = G < kBwRows ? G : kBwRows;
  r.npos = kBwRows / r.gsub;
  r.n_gblk = (G + r.gsub - 1) / r.gsub;
  r.n_rt = (S + r.npos - 1) / r.npos * r.n_gblk;
  return r;
}

// ---- wgmma 1. lse in base 2 and delta = rowsum(dO * O), by row tile ----------

// lse2 and delta [B K, n_rt, 64] f32: slot (pair, t, c) of row tile t's
// column c; a slot with no row holds lse2 = +inf (P = exp2(-inf) = 0 there)
// and delta = 0.
template <int D>
__global__ void __launch_bounds__(32 * kBwDeltaSlots / 2) flash_bwd_delta_kernel(
    const __nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ lse2, float* __restrict__ delta,
    long long n_slots, int S, int K, int G, RowTiles rt) {
  const long long slot = (long long)blockIdx.x * kBwDeltaSlots + threadIdx.x / 16;
  const int part = threadIdx.x % 16;
  const int c = (int)(slot % kBwRows);
  const long long tile = slot / kBwRows;
  const int t = (int)(tile % rt.n_rt);
  const long long pair = tile / rt.n_rt;
  const int pb = t / rt.n_gblk, hb = t - pb * rt.n_gblk;
  const int pos = pb * rt.npos + c / rt.gsub, g = hb * rt.gsub + c % rt.gsub;
  const bool real = slot < n_slots && c < rt.gsub * rt.npos && g < G && pos < S;
  const long long b = pair / K;
  const int kh = (int)(pair % K);
  float acc = 0.f;
  if (real && part < D / 8) {
    const size_t row = ((((size_t)b * S + pos) * K + kh) * G + g) * D + part * 8;
    const uint4 o = *reinterpret_cast<const uint4*>(out + row);
    const uint4 d = *reinterpret_cast<const uint4*>(dout + row);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&o);
    const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 of = __bfloat1622float2(op[i]), df = __bfloat1622float2(dp[i]);
      acc += df.x * of.x + df.y * of.y;
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 8);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (slot < n_slots && part == 0) {
    lse2[slot] = real ? lse[(((size_t)b * K + kh) * G + g) * S + pos] * kLog2e : INFINITY;
    delta[slot] = real ? acc : 0.f;
  }
}

// ---- wgmma 2. dK and dV: planned items, persistent -------------------------

// CTA c walks the plan's items plan[c] .. plan[c + 1] - 1 (the plan's first
// n_cta + 1 ints; then the items, kItemInts each: key tile j, pair b K + kh,
// row tiles [t0, t1), and its partials' slot, or -1 where the item is the
// only chunk of its (key tile, pair) and writes dK and dV itself).  Warpgroup 2 is the
// producer: one thread loads each item's K and V (128 keys) behind a full /
// empty barrier pair, then its row tiles' Q, dO, lse2 and delta into the
// ring.  Warpgroups 0 and 1 each own 64 keys: per row tile S^T = K Q^T and
// dP^T = V dO^T from shared memory, P^T and dS^T in registers, then
// dV += P^T dO and dK += dS^T Q with dO and Q read MN-major.
template <int D>
__global__ void __launch_bounds__(kBwThreads, 1) flash_bwd_dkdv_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
    const float* __restrict__ lse2, const float* __restrict__ delta, const int* __restrict__ plan,
    int n_cta, float* __restrict__ part, __nv_bfloat16* __restrict__ dk_out,
    __nv_bfloat16* __restrict__ dv_out, int Skv, int K, RowTiles rt, int causal, float scale) {
  using L = BkSmem<D>;
  extern __shared__ __align__(1024) unsigned char bk_smem[];
  const uint32_t raw = smem_u32(bk_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = bk_smem + (base - raw);
  const uint32_t sK = base + L::kK, sV = base + L::kV, sRing = base + L::kRing;
  const uint32_t bar_kv_full = base + L::kBar, bar_kv_empty = bar_kv_full + 8;
  const uint32_t bar_full = bar_kv_full + 16, bar_empty = bar_full + 8 * kBwStages;
  int* const colpos = reinterpret_cast<int*>(gbase + L::kColPos);
  const int* const items = plan + n_cta + 1;
  const int it0 = plan[blockIdx.x], it1 = plan[blockIdx.x + 1];
  const int tile_rows = rt.gsub * rt.npos;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv_full, 1);
    mbar_init(bar_kv_empty, 2 * 128);  // every consumer thread arrives
    for (int s = 0; s < kBwStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer warpgroup: one thread issues every load ---------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kBwProducerRegs));
    if (threadIdx.x == 256) {
      const uint32_t tile_bytes = 2 * L::kHalves * 128 * tile_rows + 2 * kBwRows * 4;
      int tile = 0;  // row tiles loaded so far: the ring's stage and phase
      for (int i = it0; i < it1; ++i) {
        const int* w = items + kItemInts * i;
        const int j = w[0], pair = w[1], t0 = w[2], t1 = w[3];
        const int b = pair / K, kh = pair - b * K;
        mbar_wait(bar_kv_empty, ((i - it0) & 1) ^ 1);  // the last item's products are done
        mbar_expect_tx(bar_kv_full, 2 * L::kHalves * L::kKvHalf);
#pragma unroll
        for (int h = 0; h < L::kHalves; ++h) {
          tma_load_4d(sK + h * L::kKvHalf, &tm_k, bar_kv_full, 64 * h, kh, j * kBwKeys, b);
          tma_load_4d(sV + h * L::kKvHalf, &tm_v, bar_kv_full, 64 * h, kh, j * kBwKeys, b);
        }
        for (int t = t0; t < t1; ++t, ++tile) {
          const int st = tile % kBwStages;
          const uint32_t stage = sRing + st * L::kStage, full = bar_full + 8 * st;
          mbar_wait(bar_empty + 8 * st, ((tile / kBwStages) & 1) ^ 1);
          mbar_expect_tx(full, tile_bytes);
          const int pb = t / rt.n_gblk, hb = t - pb * rt.n_gblk;
#pragma unroll
          for (int h = 0; h < L::kHalves; ++h) {
            tma_load_5d(stage + L::kStQ + h * L::kRowHalf, &tm_q, full, 64 * h, hb * rt.gsub, kh,
                        pb * rt.npos, b);
            tma_load_5d(stage + L::kStO + h * L::kRowHalf, &tm_do, full, 64 * h, hb * rt.gsub, kh,
                        pb * rt.npos, b);
          }
          const size_t slot0 = ((size_t)pair * rt.n_rt + t) * kBwRows;
          bulk_load(stage + L::kStLse, lse2 + slot0, kBwRows * 4, full);
          bulk_load(stage + L::kStDelta, delta + slot0, kBwRows * 4, full);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns keys 64 wg .. 64 wg + 63 of an item ------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kBwConsumerRegs));
    // rows past a tile's box (gsub npos of the 64) are never loaded: zero
    // them in every stage, once; and each column's position in its tile
    const int pad = (kBwRows - tile_rows) * 8;  // 16-byte chunks of a half
    for (int i = threadIdx.x; i < kBwStages * 2 * L::kHalves * pad; i += 256) {
      const int half = i / pad, rem = i - half * pad;  // half: stage, then Q / dO half
      const int st = half / (2 * L::kHalves), which = half - st * 2 * L::kHalves;
      *reinterpret_cast<uint4*>(gbase + L::kRing + st * L::kStage + which * L::kRowHalf +
                                (tile_rows + rem / 8) * 128 + (rem % 8) * 16) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    for (int c = threadIdx.x; c < kBwRows; c += 256)
      colpos[c] = c < tile_rows ? c / rt.gsub : kNoPos;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 256;\n" ::: "memory");

    const int tw = threadIdx.x - 128 * wg, wi = tw >> 5, lane = tw & 31;
    const int kr = 64 * wg + 16 * wi + (lane >> 2);  // the thread's keys kr, kr + 8 of an item
    // Ping-pong: the warpgroups take turns to issue their products (named
    // barriers 3 and 4), as flash_fwd_wgmma_kernel's do, so that one's run
    // while the other computes P^T and dS^T.  Warpgroup 1 opens with an
    // arrive, warpgroup 0 closes with a sync: every arrive meets one sync.
    auto my_turn = [&] { asm volatile("bar.sync %0, 256;\n" ::"r"(3 + wg) : "memory"); };
    auto your_turn = [&] { asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - wg) : "memory"); };
    if (wg == 1) asm volatile("bar.arrive 3, 256;\n" ::: "memory");
    const int col = 2 * (lane & 3);
    const float scale_log2 = scale * kLog2e;
    float dk[D / 2], dv[D / 2];
    int tile = 0;  // row tiles consumed so far
    for (int i = it0; i < it1; ++i) {
      const int* w = items + kItemInts * i;
      const int j = w[0], pair = w[1], t0 = w[2], t1 = w[3], slot = w[4];
      const int k0 = j * kBwKeys;
#pragma unroll
      for (int x = 0; x < D / 2; ++x) dk[x] = dv[x] = 0.f;
      mbar_wait(bar_kv_full, (i - it0) & 1);
      for (int t = t0; t < t1; ++t, ++tile) {
        const int st = tile % kBwStages;
        const uint32_t stage = sRing + st * L::kStage;
        const float* ls = reinterpret_cast<const float*>(gbase + L::kRing + st * L::kStage +
                                                         L::kStLse);
        const float* dl = ls + kBwRows;  // kStDelta follows kStLse
        mbar_wait(bar_full + 8 * st, (tile / kBwStages) & 1);

        // S^T = K Q^T and dP^T = V dO^T: this warpgroup's 64 keys x the 64 rows
        float s[32], dp[32];
        my_turn();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t h = (kk / 4), step = (kk % 4) * 32;
          wgmma_ss_n64(s, sw128_desc(sK + h * L::kKvHalf + wg * 64 * 128 + step, 0),
                       sw128_desc(stage + L::kStQ + h * L::kRowHalf + step, 0), kk);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t h = (kk / 4), step = (kk % 4) * 32;
          wgmma_ss_n64(dp, sw128_desc(sV + h * L::kKvHalf + wg * 64 * 128 + step, 0),
                       sw128_desc(stage + L::kStO + h * L::kRowHalf + step, 0), kk);
        }
        wgmma_commit();
        your_turn();
        wgmma_wait<1>();
        fence_regs(s);
        // P^T = exp2(S^T scale log2 e - lse2), 0 above the diagonal (only a
        // tile whose first position is below the item's last key has any)
        const int p0 = (t / rt.n_gblk) * rt.npos;
        const bool diag = causal && p0 < k0 + kBwKeys - 1;
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * x + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = ex2(fmaf(s[4 * x + e], scale_log2, (e & 1) ? -l2.y : -l2.x));
            if (diag && k0 + kr + 8 * (e >> 1) > p0 + colpos[8 * x + col + (e & 1)]) p = 0.f;
            s[4 * x + e] = p;
          }
        }
        wgmma_wait<0>();
        fence_regs(dp);
        // dS^T = P^T (dP^T - delta)
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * x + col);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * x + e] = s[4 * x + e] * (dp[4 * x + e] - ((e & 1) ? d2.y : d2.x));
        }
        uint32_t pa[4][4], da[4][4];
        acc_to_a<4>(pa, s);
        acc_to_a<4>(da, dp);
        // dV += P^T dO and dK += dS^T Q (scaled once at the end), 16 rows a step
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(pa);
        fence_regs(da);
        my_turn();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_d<D>(dv, pa[kk], stage + L::kStO + kk * 16 * 128, L::kRowHalf);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_d<D>(dk, da[kk], stage + L::kStQ + kk * 16 * 128, L::kRowHalf);
        wgmma_commit();
        your_turn();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        mbar_arrive(bar_empty + 8 * st);  // the stage may take the next row tile
      }
      mbar_arrive(bar_kv_empty);  // K and V may take the next item's

      const int b = pair / K, kh = pair - b * K;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int key = k0 + kr + 8 * half;
        if (key >= Skv) continue;
        if (slot < 0) {
          const size_t off = (((size_t)b * Skv + key) * K + kh) * D + col;
#pragma unroll
          for (int x = 0; x < D / 8; ++x) {
            *reinterpret_cast<__nv_bfloat162*>(dk_out + off + 8 * x) = __floats2bfloat162_rn(
                dk[4 * x + 2 * half] * scale, dk[4 * x + 2 * half + 1] * scale);
            *reinterpret_cast<__nv_bfloat162*>(dv_out + off + 8 * x) =
                __floats2bfloat162_rn(dv[4 * x + 2 * half], dv[4 * x + 2 * half + 1]);
          }
        } else {
          float* pk = part + ((size_t)slot * 2 * kBwKeys + kr + 8 * half) * D + col;
          float* pv = pk + (size_t)kBwKeys * D;
#pragma unroll
          for (int x = 0; x < D / 8; ++x) {
            *reinterpret_cast<float2*>(pk + 8 * x) =
                make_float2(dk[4 * x + 2 * half], dk[4 * x + 2 * half + 1]);
            *reinterpret_cast<float2*>(pv + 8 * x) =
                make_float2(dv[4 * x + 2 * half], dv[4 * x + 2 * half + 1]);
          }
        }
      }
    }
    if (wg == 0) my_turn();  // warpgroup 1's last arrive
  }
}

// ---- wgmma 3. the partials of split key tiles, summed in chunk order ----------

// Block (j, pair, slice) sums kReduceKeys keys of key tile j of a pair that
// the plan cut into n_ch > 1 chunks: dK = scale (part_0 + part_1 + ...) and
// dV = part_0 + part_1 + ..., chunk 0 first, the order fixed by the chunk
// index.  kt: (n_ch, first slot) per (key tile, pair), the pair fastest;
// chunk c's partials are slot first + c.
template <int D>
__global__ void __launch_bounds__(256) flash_bwd_reduce_kernel(
    const float* __restrict__ part, const int* __restrict__ kt, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int Skv, int K, int n_pairs, float scale) {
  constexpr int kSlices = kBwKeys / kReduceKeys;
  const int jp = blockIdx.x / kSlices, r0 = (blockIdx.x % kSlices) * kReduceKeys;
  const int n_ch = kt[2 * jp], first = kt[2 * jp + 1];
  if (n_ch < 2) return;
  const int j = jp / n_pairs, pair = jp - j * n_pairs;
  const int b = pair / K, kh = pair - b * K;
  for (int i = threadIdx.x; i < kReduceKeys * D / 4; i += 256) {
    const int r = r0 + i / (D / 4), d = (i % (D / 4)) * 4;
    const int key = j * kBwKeys + r;
    if (key >= Skv) continue;
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int c = 0; c < n_ch; ++c) {
      const float* p = part + ((size_t)(first + c) * 2 * kBwKeys + r) * D + d;
      const float4 a = *reinterpret_cast<const float4*>(p);
      const float4 e = *reinterpret_cast<const float4*>(p + kBwKeys * D);
      sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
      sv.x += e.x; sv.y += e.y; sv.z += e.z; sv.w += e.w;
    }
    const size_t off = (((size_t)b * Skv + key) * K + kh) * D + d;
    __nv_bfloat162* ok = reinterpret_cast<__nv_bfloat162*>(dk + off);
    __nv_bfloat162* ov = reinterpret_cast<__nv_bfloat162*>(dv + off);
    ok[0] = __floats2bfloat162_rn(sk.x * scale, sk.y * scale);
    ok[1] = __floats2bfloat162_rn(sk.z * scale, sk.w * scale);
    ov[0] = __floats2bfloat162_rn(sv.x, sv.y);
    ov[1] = __floats2bfloat162_rn(sv.z, sv.w);
  }
}

// ---- wgmma 4. dQ: items of 128 rows, persistent ----------------------------

// A work item is 128 rows (npos_q = 128 / G positions by all G heads of one
// pair), the items with the most key tiles under the causal mask first, in
// rounds that zigzag across the CTAs, as flash_fwd_wgmma_kernel walks them.
// The producer loads the item's Q and dO (behind a full / empty pair), then
// its K and V tiles of 128 keys into the ring; warpgroups 0 and 1 each own 64
// rows: S = Q K^T, dP = dO V^T, P and dS in registers, dQ += dS K with K read
// MN-major.
template <int D>
__global__ void __launch_bounds__(kBwThreads, 1) flash_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
    const float* __restrict__ lse2, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq_out, int S, int Skv, int K, int G, int npos, int n_qblocks,
    int n_pairs, RowTiles rt, int causal, float scale) {
  using L = DqSmem<D>;
  extern __shared__ __align__(1024) unsigned char dq_smem[];
  const uint32_t raw = smem_u32(dq_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = dq_smem + (base - raw);
  const uint32_t sQ = base + L::kQ, sO = base + L::kO, sK = base + L::kK, sV = base + L::kV;
  const uint32_t bar_q_full = base + L::kBar, bar_q_empty = bar_q_full + 8;
  const uint32_t bar_full = bar_q_full + 16, bar_empty = bar_full + 8 * kDqStages;
  const int n_items = n_qblocks * n_pairs;
  const int grid = gridDim.x, c = blockIdx.x;
  auto item_of = [&](int r) { return r * grid + ((r & 1) ? grid - 1 - c : c); };
  struct Item {
    int pair, q0, nq, n_tiles;
  };
  auto item = [&](int i) {
    Item it;
    it.pair = i % n_pairs;
    it.q0 = (n_qblocks - 1 - i / n_pairs) * npos;
    it.nq = min(npos, S - it.q0);
    const int kv_end = causal ? min(Skv, it.q0 + it.nq) : Skv;
    it.n_tiles = (kv_end + kDqKeys - 1) / kDqKeys;
    return it;
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_q_full, 1);
    mbar_init(bar_q_empty, 2 * 128);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kBwProducerRegs));
    if (threadIdx.x == 256) {
      int tile = 0;
      for (int j = 0; item_of(j) < n_items; ++j) {
        const Item w = item(item_of(j));
        const int b = w.pair / K, kh = w.pair - b * K;
        mbar_wait(bar_q_empty, (j & 1) ^ 1);  // the last item's S and dP products are done
        mbar_expect_tx(bar_q_full, (uint32_t)(2 * L::kHalves * 128 * G * npos));
#pragma unroll
        for (int h = 0; h < L::kHalves; ++h) {
          tma_load_5d(sQ + h * L::kRowHalf, &tm_q, bar_q_full, 64 * h, 0, kh, w.q0, b);
          tma_load_5d(sO + h * L::kRowHalf, &tm_do, bar_q_full, 64 * h, 0, kh, w.q0, b);
        }
        for (int t = 0; t < w.n_tiles; ++t, ++tile) {
          const int st = tile % kDqStages;
          mbar_wait(bar_empty + 8 * st, ((tile / kDqStages) & 1) ^ 1);
          mbar_expect_tx(bar_full + 8 * st, 2 * L::kTile);
#pragma unroll
          for (int h = 0; h < L::kHalves; ++h) {
            const uint32_t off = st * L::kTile + h * L::kKeyHalf;
            tma_load_4d(sK + off, &tm_k, bar_full + 8 * st, 64 * h, kh, t * kDqKeys, b);
            tma_load_4d(sV + off, &tm_v, bar_full + 8 * st, 64 * h, kh, t * kDqKeys, b);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kBwConsumerRegs));
    const int tw = threadIdx.x - 128 * wg, wi = tw >> 5, lane = tw & 31;
    // rows past the box (npos G of the 128) are never loaded: zero this
    // warpgroup's in Q and dO, once
    const int boxed = npos * G;
    for (int i = tw; i < 2 * L::kHalves * 64 * 8; i += 128) {
      const int h = i / 512, r = 64 * wg + (i / 8) % 64, ch = i % 8;
      if (r >= boxed)
        *reinterpret_cast<uint4*>(gbase + L::kQ + h * L::kRowHalf + r * 128 + ch * 16) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

    const int r0 = 64 * wg + 16 * wi + (lane >> 2), r1 = r0 + 8;
    const int col = 2 * (lane & 3);
    const float scale_log2 = scale * kLog2e;
    float dq[D / 2];
    int tile = 0;
    for (int j = 0; item_of(j) < n_items; ++j) {
      const Item w = item(item_of(j));
      const int rows = w.nq * G;
      // each row's position, lse2 and delta (the delta pass's slot of (pos, g))
      int pos[2];
      float lrow[2], drow[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = half ? r1 : r0;
        pos[half] = kNoPos;
        lrow[half] = INFINITY;
        drow[half] = 0.f;
        if (r < rows) {
          const int p = w.q0 + r / G, g = r % G;
          const int t = (p / rt.npos) * rt.n_gblk + g / rt.gsub;
          const size_t slot = ((size_t)w.pair * rt.n_rt + t) * kBwRows +
                              (p % rt.npos) * rt.gsub + g % rt.gsub;
          pos[half] = p;
          lrow[half] = lse2[slot];
          drow[half] = delta[slot];
        }
      }
#pragma unroll
      for (int x = 0; x < D / 2; ++x) dq[x] = 0.f;
      mbar_wait(bar_q_full, j & 1);
      for (int t = 0; t < w.n_tiles; ++t, ++tile) {
        const int st = tile % kDqStages;
        const uint32_t kt = sK + st * L::kTile, vt = sV + st * L::kTile;
        mbar_wait(bar_full + 8 * st, (tile / kDqStages) & 1);
        float s[kDqKeys / 2], dp[kDqKeys / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t h = (kk / 4), step = (kk % 4) * 32;
          wgmma_ss_n128(s, sw128_desc(sQ + h * L::kRowHalf + wg * 64 * 128 + step, 0),
                        sw128_desc(kt + h * L::kKeyHalf + step, 0), kk);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t h = (kk / 4), step = (kk % 4) * 32;
          wgmma_ss_n128(dp, sw128_desc(sO + h * L::kRowHalf + wg * 64 * 128 + step, 0),
                        sw128_desc(vt + h * L::kKeyHalf + step, 0), kk);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        // P = exp2(S scale log2 e - lse2), 0 where masked (only the tiles that
        // cross the diagonal or Skv have any)
        const int kt0 = t * kDqKeys;
        const bool edge = kt0 + kDqKeys > Skv || (causal && kt0 + kDqKeys - 1 > w.q0);
#pragma unroll
        for (int x = 0; x < kDqKeys / 8; ++x)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = ex2(fmaf(s[4 * x + e], scale_log2, -lrow[e >> 1]));
            if (edge) {
              const int key = kt0 + 8 * x + col + (e & 1);
              if (key >= Skv || (causal && key > pos[e >> 1])) p = 0.f;
            }
            s[4 * x + e] = p;
          }
        wgmma_wait<0>();
        fence_regs(dp);
        if (t == w.n_tiles - 1) mbar_arrive(bar_q_empty);  // Q and dO may take the next item
        // dS = P (dP - delta)
#pragma unroll
        for (int x = 0; x < kDqKeys / 8; ++x)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[4 * x + e] = s[4 * x + e] * (dp[4 * x + e] - drow[e >> 1]);
        uint32_t da[kDqKeys / 16][4];
        acc_to_a<kDqKeys / 16>(da, dp);
        // dQ += dS K (scaled once at the end), 16 keys a step
        fence_regs(dq);
        fence_regs(da);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDqKeys / 16; ++kk)
          wgmma_rs_d<D>(dq, da[kk], kt + kk * 16 * 128, L::kKeyHalf);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        mbar_arrive(bar_empty + 8 * st);
      }

      const int b = w.pair / K, kh = w.pair - b * K;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = half ? r1 : r0;
        if (r >= rows) continue;
        const int p = w.q0 + r / G, g = r % G;
        __nv_bfloat16* dst = dq_out + ((((size_t)b * S + p) * K + kh) * G + g) * D + col;
#pragma unroll
        for (int x = 0; x < D / 8; ++x)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * x) = __floats2bfloat162_rn(
              dq[4 * x + 2 * half] * scale, dq[4 * x + 2 * half + 1] * scale);
      }
    }
  }
}

template <int D>
cudaError_t launch_bwd_wgmma(const __nv_bfloat16* q, const __nv_bfloat16* k,
                             const __nv_bfloat16* v, const __nv_bfloat16* out,
                             const __nv_bfloat16* dout, const float* lse, float* work,
                             const int* plan, int n_cta, int n_items, __nv_bfloat16* dq,
                             __nv_bfloat16* dk, __nv_bfloat16* dv, int B, int S, int Skv, int K,
                             int G, int causal, float scale, cudaStream_t stream) {
  const RowTiles rt = row_tiles(S, G);
  const int n_pairs = B * K, n_kt = (Skv + kBwKeys - 1) / kBwKeys;
  const long long n_slots = (long long)n_pairs * rt.n_rt * kBwRows;
  const int npos = kDqRows / G, n_qblocks = (S + npos - 1) / npos;
  const long long reduce_blocks = (long long)n_kt * n_pairs * (kBwKeys / kReduceKeys);
  if (n_slots / kBwDeltaSlots + 1 > 0x7fffffffLL || reduce_blocks > 0x7fffffffLL ||
      (long long)n_qblocks * n_pairs > 0x7fffffffLL || n_cta <= 0)
    return cudaErrorInvalidConfiguration;
  float* const lse2 = work;
  float* const delta = work + n_slots;
  float* const part = delta + n_slots;

  const cuuint64_t e = sizeof(__nv_bfloat16);
  const cuuint64_t q_dims[5] = {(cuuint64_t)D, (cuuint64_t)G, (cuuint64_t)K, (cuuint64_t)S,
                                (cuuint64_t)B};
  const cuuint64_t q_strides[4] = {D * e, (cuuint64_t)G * D * e, (cuuint64_t)K * G * D * e,
                                   (cuuint64_t)S * K * G * D * e};
  const cuuint32_t tile_box[5] = {64u, (cuuint32_t)rt.gsub, 1u, (cuuint32_t)rt.npos, 1u};
  const cuuint32_t item_box[5] = {64u, (cuuint32_t)G, 1u, (cuuint32_t)npos, 1u};
  const cuuint64_t kv_dims[4] = {(cuuint64_t)D, (cuuint64_t)K, (cuuint64_t)Skv, (cuuint64_t)B};
  const cuuint64_t kv_strides[3] = {D * e, (cuuint64_t)K * D * e, (cuuint64_t)Skv * K * D * e};
  const cuuint32_t kv_box[4] = {64u, 1u, (cuuint32_t)kBwKeys, 1u};
  const cuuint32_t dq_kv_box[4] = {64u, 1u, (cuuint32_t)kDqKeys, 1u};
  CUtensorMap bq, bdo, bk, bv, cq, cdo, ck, cv;
  cudaError_t err;
  if ((err = make_map<5>(&bq, q, q_dims, q_strides, tile_box)) != cudaSuccess ||
      (err = make_map<5>(&bdo, dout, q_dims, q_strides, tile_box)) != cudaSuccess ||
      (err = make_map<4>(&bk, k, kv_dims, kv_strides, kv_box)) != cudaSuccess ||
      (err = make_map<4>(&bv, v, kv_dims, kv_strides, kv_box)) != cudaSuccess ||
      (err = make_map<5>(&cq, q, q_dims, q_strides, item_box)) != cudaSuccess ||
      (err = make_map<5>(&cdo, dout, q_dims, q_strides, item_box)) != cudaSuccess ||
      (err = make_map<4>(&ck, k, kv_dims, kv_strides, dq_kv_box)) != cudaSuccess ||
      (err = make_map<4>(&cv, v, kv_dims, kv_strides, dq_kv_box)) != cudaSuccess)
    return err;
  if ((err = smem_limit_once<flash_bwd_dkdv_kernel<D>>(BkSmem<D>::kBytes)) != cudaSuccess ||
      (err = smem_limit_once<flash_bwd_dq_kernel<D>>(DqSmem<D>::kBytes)) != cudaSuccess)
    return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;

  flash_bwd_delta_kernel<D><<<(unsigned)((n_slots + kBwDeltaSlots - 1) / kBwDeltaSlots),
                              32 * kBwDeltaSlots / 2, 0, stream>>>(out, dout, lse, lse2, delta,
                                                                   n_slots, S, K, G, rt);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<D><<<(unsigned)n_cta, kBwThreads, BkSmem<D>::kBytes, stream>>>(
      bq, bdo, bk, bv, lse2, delta, plan, n_cta, part, dk, dv, Skv, K, rt, causal, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_reduce_kernel<D><<<(unsigned)reduce_blocks, 256, 0, stream>>>(
      part, plan + n_cta + 1 + kItemInts * n_items, dk, dv, Skv, K, n_pairs, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long dq_items = (long long)n_qblocks * n_pairs;
  const unsigned dq_blocks = (unsigned)(dq_items < sms ? dq_items : sms);
  flash_bwd_dq_kernel<D><<<dq_blocks, kBwThreads, DqSmem<D>::kBytes, stream>>>(
      cq, cdo, ck, cv, lse2, delta, dq, S, Skv, K, G, npos, n_qblocks, n_pairs, rt, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The kernels' geometry for head dim D, which the wrapper plans with and
// checks: keys of a dK/dV work item, rows of a row tile, ints of a planned
// item, and whether D goes to the wgmma kernels (1) or the mma.sync ones (0).
int flash_bwd_geometry(int D, int* key_tile, int* row_tile, int* item_ints, int* wgmma) {
  *key_tile = kBwKeys;
  *row_tile = kBwRows;
  *item_ints = kItemInts;
  *wgmma = (D == 64 || D == 128) ? 1 : 0;
  return 0;
}

// Launches flash_bwd on `stream`.  D = 16 * nk with 1 <= nk <= 8, G <= 128;
// q, out, dout, dq [B, S, K, G, D] and k, v, dk, dv [B, Skv, K, D] bf16, lse
// [B, K, G, S] f32 (natural log units); all pointers 16-byte aligned (the
// wrapper checks).  D = 64 and 128: `work` holds lse2 and delta by row tile
// (2 B K n_rt 64 f32) then the partials (2 x 128 x D f32 a slot), and `plan`
// (device int32, n_cta + 1 offsets, n_items items, 2 ints a key tile) is the
// wrapper's flash_bwd_plan; the delta pass, dK and dV, the partials' sum, dQ.
// Other D: `work` is delta [B, K, G, S] f32 and `plan` unused; the delta
// pass, dK and dV, dQ by mma.sync.  Returns a cudaError_t.
int flash_bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
              const void* lse, void* work, const void* plan, int n_cta, int n_items, void* dq,
              void* dk, void* dv, int B, int S, int Skv, int K, int G, int D, int causal,
              float scale, void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || K <= 0 || G <= 0 || G > 128 || D % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* op = static_cast<const __nv_bfloat16*>(out);
  const auto* dop = static_cast<const __nv_bfloat16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  auto* wp = static_cast<float*>(work);
  auto* dqp = static_cast<__nv_bfloat16*>(dq);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  const auto* pl = static_cast<const int*>(plan);
  const auto st = static_cast<cudaStream_t>(stream);
  if (D == 64 || D == 128) {
    if (pl == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        D == 64 ? launch_bwd_wgmma<64>(qp, kp, vp, op, dop, lp, wp, pl, n_cta, n_items, dqp, dkp,
                                       dvp, B, S, Skv, K, G, causal, scale, st)
                : launch_bwd_wgmma<128>(qp, kp, vp, op, dop, lp, wp, pl, n_cta, n_items, dqp, dkp,
                                        dvp, B, S, Skv, K, G, causal, scale, st));
  }
  switch (D / 16) {
#define BWD_CASE(n)                                                                             \
  case n:                                                                                       \
    return static_cast<int>(launch_bwd_mma<n>(qp, kp, vp, op, dop, lp, wp, dqp, dkp, dvp, B, S, \
                                              Skv, K, G, causal, scale, st));
    BWD_CASE(1) BWD_CASE(2) BWD_CASE(3) BWD_CASE(5) BWD_CASE(6) BWD_CASE(7)
#undef BWD_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
