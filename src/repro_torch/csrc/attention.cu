// Causal GQA attention for prefill (flash_fwd) and one-token attention
// against the KV cache for decode (decode_attn), for Hopper, sm_90a.
//
// Neither replaces a Pallas kernel: the JAX package computes both with
// plain jnp, as its LM attention kernels.
//
//   flash_fwd replaces src/repro/models/attention.py:59 flash_attention,
//   a lax.scan streaming softmax over (query block, key block) pairs;
//   decode_attn replaces src/repro/models/attention.py:344
//   decode_attention, a masked softmax over the whole cache.
//
// Layouts are the JAX package's grouped-query ones, all contiguous bf16:
//   q [B, S, K, G, D] (K key/value heads, G query heads per KV head,
//   query head h = k * G + g), k and v [B, Skv, K, D], out like q;
//   decode: q [B, 1, K, G, D], caches [B, Smax, K, D], pos [B] int32.
// Both compute what the JAX functions compute, in float32 from the bf16
// inputs, scores scaled by D ** -0.5, masked scores at -1e30 (the JAX
// _NEG), and round the output to bf16 once:
//   flash:  out[b, i, k, g] = sum_j softmax_j(s_ij) v[b, j, k],
//           s_ij = scale * q[b, i, k, g] . k[b, j, k], masked where
//           causal and j > i (positions from 0 on both sides, as JAX's);
//   decode: the same for the one query, over cache slots s <= pos[b]
//           (every slot, all masked, where pos[b] < 0, as JAX's softmax
//           then gives their plain mean).
//
// flash_fwd.  What bounds it: operations (4 B H D S^2 / 2 with the
// causal half, against 989 TFLOP/s of bf16 tensor cores; its bytes are
// those of q, k, v and out once).  One block of 8 warps serves 128 query
// rows (a row is one (position, query head) pair; all G heads of a KV
// head for 128 / G positions), so every K and V tile staged in shared
// memory is read once for the whole group.  Each warp owns 16 rows and
// keeps, FlashAttention-2 style, its scores, its running max and sum and
// its output rows in registers in the m16n8k16 accumulator layout:
// S = Q K^T by mma.sync on bf16 (products of bf16 are exact in the f32
// accumulator), the online softmax in f32 with the 4 threads of a row
// reduced by shuffles, then O += P V by mma.sync.  P is split into
// P_hi = bf16(P) and P_lo = bf16(P - P_hi), two products, so P reaches V
// with about 16 bits and not bf16's 8: the plain version multiplies
// float32 P, and the kernel should stay within its error (the card check
// holds both against float64).  Key tiles wholly above the diagonal of a
// block are skipped (the JAX scan masks them); the masked tail of S and
// Skv needs no divisor rule.  A simple kernel: mma.sync without TMA,
// wgmma or a pipeline of tiles is later work (PERF.md).
//
// decode_attn (flash-decoding).  What bounds it: bytes, each cache slot
// s <= pos[b] read once from K and once from V.  A decode step has only
// B * K (row, KV head) pairs, 32 at B = 8 for qwen2-7b, for 132 SMs, so
// the cache is cut into chunks of 128 slots: one block per (chunk, KV
// head, row) stages its chunk of K and V in shared memory, computes the
// G heads' scores (a thread per slot), their max, exp and sum, and its
// partial output sum_s p_s v_s (a thread per dimension), in float32.
// Chunks beyond pos[b] exit at once.  A second kernel merges each pair's
// chunks' (max, sum, partial output) and rounds to bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;  // the JAX package's _NEG

// ---- flash_fwd ------------------------------------------------------------

constexpr int kFaRows = 128;          // query rows of a block
constexpr int kFaWarps = kFaRows / 16;
constexpr int kFaThreads = 32 * kFaWarps;
constexpr int kFaKeys = 64;           // keys of a tile

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair (lo in the low half), and the remainders
// that bf16 dropped as a second pair.
__device__ __forceinline__ void split_bf16x2(float lo, float hi, uint32_t& big, uint32_t& small) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  const float2 back = __bfloat1622float2(b);
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo - back.x, hi - back.y);
  big = *reinterpret_cast<const uint32_t*>(&b);
  small = *reinterpret_cast<const uint32_t*>(&r);
}

template <int NK>  // D = 16 * NK
__global__ void __launch_bounds__(kFaThreads) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int S, int Skv,
    int K, int G, int bq, int causal, float scale) {
  constexpr int D = 16 * NK;
  constexpr int LD = D + 8;  // padded row: the fragment loads hit 32 banks
  constexpr int CH = D / 8;  // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kFaRows][LD]
  __nv_bfloat16* Ks = Qs + kFaRows * LD;                            // [kFaKeys][LD]
  __nv_bfloat16* Vs = Ks + kFaKeys * LD;                            // [kFaKeys][LD]

  const int q0 = blockIdx.x * bq, kh = blockIdx.y, b = blockIdx.z;
  const int nq = min(bq, S - q0);  // positions of this block
  const int rows = nq * G;         // real rows: row r = (q0 + r / G, head r % G)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;

  for (int c = tid; c < kFaRows * CH; c += kFaThreads) {
    const int r = c / CH, part = c % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      const int s = q0 + r / G, g = r % G;
      val = *reinterpret_cast<const uint4*>(
          q + ((((size_t)b * S + s) * K + kh) * G + g) * D + part * 8);
    }
    *reinterpret_cast<uint4*>(Qs + r * LD + part * 8) = val;
  }
  __syncthreads();

  const bool active = warp * 16 < rows;  // a warp of padding rows only idles
  const int r0 = warp * 16 + grp, r1 = r0 + 8;
  // rows past the real ones have no position: no causal mask, zero q
  const int pos0 = r0 < rows ? q0 + r0 / G : 0x7fffffff;
  const int pos1 = r1 < rows ? q0 + r1 / G : 0x7fffffff;
  uint32_t qa[NK][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const int c = kk * 16 + tig * 2;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(Qs + r0 * LD + c);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(Qs + r1 * LD + c);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(Qs + r0 * LD + c + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(Qs + r1 * LD + c + 8);
  }

  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  float o[2 * NK][4];
#pragma unroll
  for (int nd = 0; nd < 2 * NK; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;

  // keys this block needs: causal rows see keys j <= i < q0 + nq
  const int kv_end = causal ? min(Skv, q0 + nq) : Skv;
  for (int kt0 = 0; kt0 < kv_end; kt0 += kFaKeys) {
    __syncthreads();  // the previous tile's readers are done
    for (int c = tid; c < kFaKeys * CH; c += kFaThreads) {
      const int r = c / CH, part = c % CH, key = kt0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;  // zeros: 0 * pad stays 0
      if (key < kv_end) {
        const size_t off = (((size_t)b * Skv + key) * K + kh) * D + part * 8;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(Ks + r * LD + part * 8) = kv;
      *reinterpret_cast<uint4*>(Vs + r * LD + part * 8) = vv;
    }
    __syncthreads();
    if (!active) continue;

    // S = Q K^T for this warp's 16 rows and the tile's keys
    float s[kFaKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kFaKeys / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* krow = Ks + (nt * 8 + grp) * LD + tig * 2;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_bf16(s[nt], qa[kk], b0, b1);
      }
    }
    // scale, mask, and the tile's row max
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < kFaKeys / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt0 + nt * 8 + tig * 2 + (e & 1);
        const int pos = e < 2 ? pos0 : pos1;
        const bool masked = key >= Skv || (causal && key > pos);
        s[nt][e] = masked ? kNeg : s[nt][e] * scale;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float c0 = expf(m0 - mx0), c1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= c0;  // this thread's share of the row sums; the 4 add up at the end
    l1 *= c1;
#pragma unroll
    for (int nd = 0; nd < 2 * NK; ++nd) {
      o[nd][0] *= c0;
      o[nd][1] *= c0;
      o[nd][2] *= c1;
      o[nd][3] *= c1;
    }
#pragma unroll
    for (int nt = 0; nt < kFaKeys / 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - m0);
      s[nt][1] = expf(s[nt][1] - m0);
      s[nt][2] = expf(s[nt][2] - m1);
      s[nt][3] = expf(s[nt][3] - m1);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }

    // O += P V, 16 keys a step: P's accumulator layout is the A layout
#pragma unroll
    for (int kc = 0; kc < kFaKeys / 16; ++kc) {
      uint32_t ph[4], pl[4];
      split_bf16x2(s[2 * kc][0], s[2 * kc][1], ph[0], pl[0]);
      split_bf16x2(s[2 * kc][2], s[2 * kc][3], ph[1], pl[1]);
      split_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1], ph[2], pl[2]);
      split_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3], ph[3], pl[3]);
      // ldmatrix.trans: lanes 8i..8i+7 point at the rows of 8x8 matrix i;
      // matrices (keys 0-7, dims d), (keys 8-15, d), (0-7, d+8), (8-15, d+8)
      const int key = kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int dsub = (lane >> 4) * 8;
#pragma unroll
      for (int nd = 0; nd < 2 * NK; nd += 2) {
        const uint32_t addr = static_cast<uint32_t>(
            __cvta_generic_to_shared(Vs + key * LD + nd * 8 + dsub));
        uint32_t b0, b1, b2, b3;
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
            : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
            : "r"(addr));
        mma_bf16(o[nd], ph, b0, b1);
        mma_bf16(o[nd], pl, b0, b1);
        mma_bf16(o[nd + 1], ph, b2, b3);
        mma_bf16(o[nd + 1], pl, b2, b3);
      }
    }
  }
  if (!active) return;

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  // acc / max(l, 1e-30) as JAX divides; a reciprocal then a product is
  // within one f32 rounding of the quotient, far below bf16's
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= rows) continue;
    const float inv = half ? inv1 : inv0;
    const int s_pos = q0 + r / G, g = r % G;
    __nv_bfloat16* dst = out + ((((size_t)b * S + s_pos) * K + kh) * G + g) * D + tig * 2;
#pragma unroll
    for (int nd = 0; nd < 2 * NK; ++nd) {
      const __nv_bfloat162 val =
          __floats2bfloat162_rn(o[nd][2 * half] * inv, o[nd][2 * half + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(dst + nd * 8) = val;
    }
  }
}

template <int NK>
cudaError_t launch_flash(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                         __nv_bfloat16* out, int B, int S, int Skv, int K, int G, int causal,
                         float scale, cudaStream_t stream) {
  constexpr int D = 16 * NK;
  const size_t smem = (size_t)(kFaRows + 2 * kFaKeys) * (D + 8) * sizeof(__nv_bfloat16);
  // above 48 KB only after this (a host call of about a microsecond)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int bq = kFaRows / G;
  const dim3 grid((unsigned)((S + bq - 1) / bq), (unsigned)K, (unsigned)B);
  flash_fwd_kernel<NK><<<grid, kFaThreads, smem, stream>>>(q, k, v, out, S, Skv, K, G, bq,
                                                           causal, scale);
  return cudaGetLastError();
}

// ---- decode_attn ----------------------------------------------------------

constexpr int kDcChunk = 128;  // cache slots of a block
constexpr int kDcThreads = 128;
constexpr int kDcMaxG = 16;

// Slots of row b that the step reads: s <= pos, or all Smax (masked) when
// pos < 0.
__device__ __forceinline__ int decode_valid(int p, int Smax) {
  return p < 0 ? Smax : min(p + 1, Smax);
}

__global__ void __launch_bounds__(kDcThreads) decode_chunk_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
    const __nv_bfloat16* __restrict__ vc, const int32_t* __restrict__ pos,
    float* __restrict__ part_o, float2* __restrict__ part_ml, int Smax, int K, int G, int D,
    int n_chunks, float scale) {
  const int c = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int p = pos[b];
  const int n_valid = decode_valid(p, Smax);
  const int start = c * kDcChunk;
  if (start >= n_valid) return;  // the merge reads only chunks below n_valid
  const int n = min(kDcChunk, n_valid - start);
  const int n4 = (n + 3) & ~3;  // slots the output loop runs over, by 4
  const int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);                    // [G][D]
  float* ps = qs + G * D;                                             // [G][kDcChunk]
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(ps + G * kDcChunk);  // [chunk][LD]
  __nv_bfloat16* Vs = Ks + kDcChunk * LD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const __nv_bfloat16* qrow = q + ((size_t)b * K + kh) * G * D;
  for (int i = tid; i < G * D; i += kDcThreads) qs[i] = __bfloat162float(qrow[i]);
  const int chunks = D / 8;
  for (int i = tid; i < n4 * chunks; i += kDcThreads) {
    const int r = i / chunks, part = i % chunks;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;  // zeros past n: 0 * pad stays 0
    if (r < n) {
      const size_t off = (((size_t)b * Smax + start + r) * K + kh) * D + part * 8;
      kv = *reinterpret_cast<const uint4*>(kc + off);
      vv = *reinterpret_cast<const uint4*>(vc + off);
    }
    *reinterpret_cast<uint4*>(Ks + r * LD + part * 8) = kv;
    *reinterpret_cast<uint4*>(Vs + r * LD + part * 8) = vv;
  }
  __syncthreads();

  // scores: a thread per slot, all G heads
  if (tid < n) {
    float acc[kDcMaxG];
#pragma unroll
    for (int g = 0; g < kDcMaxG; ++g) acc[g] = 0.f;
    const __nv_bfloat16* krow = Ks + tid * LD;
    for (int d = 0; d < D; d += 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(krow + d);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      float kf[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        kf[2 * j] = f.x;
        kf[2 * j + 1] = f.y;
      }
#pragma unroll
      for (int g = 0; g < kDcMaxG; ++g) {
        if (g < G) {
          const float4 qa = *reinterpret_cast<const float4*>(qs + g * D + d);
          const float4 qb = *reinterpret_cast<const float4*>(qs + g * D + d + 4);
          acc[g] += qa.x * kf[0] + qa.y * kf[1] + qa.z * kf[2] + qa.w * kf[3] +
                    qb.x * kf[4] + qb.y * kf[5] + qb.z * kf[6] + qb.w * kf[7];
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kDcMaxG; ++g)
      if (g < G) ps[g * kDcChunk + tid] = p < 0 ? kNeg : acc[g] * scale;
  }
  __syncthreads();

  // per head: the chunk's max, exp and sum (a warp per head)
  float2* ml = part_ml + (((size_t)b * K + kh) * n_chunks + c) * G;
  for (int g = warp; g < G; g += kDcThreads / 32) {
    float* row = ps + g * kDcChunk;
    float mx = -3.402823466e38f;
    for (int s = lane; s < n; s += 32) mx = fmaxf(mx, row[s]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int s = lane; s < n4; s += 32) {
      const float e = s < n ? expf(row[s] - mx) : 0.f;
      row[s] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) ml[g] = make_float2(mx, sum);
  }
  __syncthreads();

  // partial output sum_s p_s v_s: a thread per dimension, all G heads
  float* po = part_o + (((size_t)b * K + kh) * n_chunks + c) * G * D;
  for (int d = tid; d < D; d += kDcThreads) {
    float acc[kDcMaxG];
#pragma unroll
    for (int g = 0; g < kDcMaxG; ++g) acc[g] = 0.f;
    for (int s = 0; s < n4; s += 4) {
      const float v0 = __bfloat162float(Vs[s * LD + d]);
      const float v1 = __bfloat162float(Vs[(s + 1) * LD + d]);
      const float v2 = __bfloat162float(Vs[(s + 2) * LD + d]);
      const float v3 = __bfloat162float(Vs[(s + 3) * LD + d]);
#pragma unroll
      for (int g = 0; g < kDcMaxG; ++g) {
        if (g < G) {
          const float4 pw = *reinterpret_cast<const float4*>(ps + g * kDcChunk + s);
          acc[g] += pw.x * v0 + pw.y * v1 + pw.z * v2 + pw.w * v3;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kDcMaxG; ++g)
      if (g < G) po[g * D + d] = acc[g];
  }
}

__global__ void __launch_bounds__(kDcThreads) decode_merge_kernel(
    const float* __restrict__ part_o, const float2* __restrict__ part_ml,
    const int32_t* __restrict__ pos, __nv_bfloat16* __restrict__ out, int Smax, int K, int G,
    int D, int n_chunks) {
  const int kh = blockIdx.x, b = blockIdx.y;
  const int used = (decode_valid(pos[b], Smax) + kDcChunk - 1) / kDcChunk;
  const size_t pair = (size_t)b * K + kh;
  const float2* ml = part_ml + pair * n_chunks * G;
  const float* po = part_o + pair * n_chunks * G * D;
  __nv_bfloat16* dst = out + pair * G * D;
  for (int g = 0; g < G; ++g) {
    float mx = -3.402823466e38f;
    for (int c = 0; c < used; ++c) mx = fmaxf(mx, ml[c * G + g].x);
    float sum = 0.f;
    for (int c = 0; c < used; ++c) sum += ml[c * G + g].y * expf(ml[c * G + g].x - mx);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    for (int d = threadIdx.x; d < D; d += kDcThreads) {
      float acc = 0.f;
      for (int c = 0; c < used; ++c)
        acc += po[((size_t)c * G + g) * D + d] * expf(ml[c * G + g].x - mx);
      dst[g * D + d] = __float2bfloat16_rn(acc * inv);
    }
  }
}

}  // namespace

extern "C" {

// Launches flash_fwd on `stream`.  D = 16 * nk with 1 <= nk <= 8, G <= 128;
// all pointers 16-byte aligned (the wrapper checks).  Returns a cudaError_t.
int flash_fwd(const void* q, const void* k, const void* v, void* out, int B, int S, int Skv,
              int K, int G, int D, int causal, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || K <= 0 || G <= 0 || G > kFaRows || D % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D / 16) {
    case 1: err = launch_flash<1>(qp, kp, vp, op, B, S, Skv, K, G, causal, scale, st); break;
    case 2: err = launch_flash<2>(qp, kp, vp, op, B, S, Skv, K, G, causal, scale, st); break;
    case 3: err = launch_flash<3>(qp, kp, vp, op, B, S, Skv, K, G, causal, scale, st); break;
    case 4: err = launch_flash<4>(qp, kp, vp, op, B, S, Skv, K, G, causal, scale, st); break;
    case 5: err = launch_flash<5>(qp, kp, vp, op, B, S, Skv, K, G, causal, scale, st); break;
    case 6: err = launch_flash<6>(qp, kp, vp, op, B, S, Skv, K, G, causal, scale, st); break;
    case 7: err = launch_flash<7>(qp, kp, vp, op, B, S, Skv, K, G, causal, scale, st); break;
    case 8: err = launch_flash<8>(qp, kp, vp, op, B, S, Skv, K, G, causal, scale, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Chunks of the cache per row: the workspace's second axis.
int decode_attn_chunks(int Smax) { return (Smax + kDcChunk - 1) / kDcChunk; }

// Launches decode_attn (chunks, then the merge) on `stream`.  Workspaces:
// part_o [B, K, decode_attn_chunks(Smax), G, D] f32 and part_ml
// [B, K, chunks, G, 2] f32, both uninitialised.  D % 8 == 0, D <= 256,
// G <= 16; pointers 16-byte aligned.  Returns a cudaError_t.
int decode_attn(const void* q, const void* kc, const void* vc, const void* pos, void* part_o,
                void* part_ml, void* out, int B, int Smax, int K, int G, int D, float scale,
                void* stream) {
  if (B <= 0 || Smax <= 0 || K <= 0 || G <= 0 || G > kDcMaxG || D <= 0 || D % 8 != 0 ||
      D > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = decode_attn_chunks(Smax);
  const size_t smem = (size_t)G * D * sizeof(float) + (size_t)G * kDcChunk * sizeof(float) +
                      (size_t)2 * kDcChunk * (D + 8) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      decode_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  decode_chunk_kernel<<<dim3((unsigned)n_chunks, (unsigned)K, (unsigned)B), kDcThreads, smem,
                        st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), static_cast<const int32_t*>(pos),
      static_cast<float*>(part_o), static_cast<float2*>(part_ml), Smax, K, G, D, n_chunks,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<<<dim3((unsigned)K, (unsigned)B), kDcThreads, 0, st>>>(
      static_cast<const float*>(part_o), static_cast<const float2*>(part_ml),
      static_cast<const int32_t*>(pos), static_cast<__nv_bfloat16*>(out), Smax, K, G, D,
      n_chunks);
  return static_cast<int>(cudaGetLastError());
}

const char* attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
