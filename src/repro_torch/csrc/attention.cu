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
// The softmax runs in base 2: exp(x - m) as exp2(x log2 e - m log2 e).
// Where flash_fwd is given an lse pointer (training: the forward of
// flash_attention_fused, src/repro/models/attention.py:147-220), both
// kernels also write each row's log-sum-exp of the scaled scores, in
// natural log units, m + log(max(l, 1e-30)) as _flash_fwd_loop gives it,
// into lse [B, K, G, S] f32 (row (b, i, k, g) at ((b K + k) G + g) S + i):
// the wgmma kernel's running max is in base-2 units, so it writes
// (m + log2(max(l, 1e-30))) ln 2.  The backward (attention_bwd.cu) turns it
// back into base 2 and recomputes P as exp2(s scale log2 e - lse log2 e).
//
// flash_fwd with a window (row 13: the hybrid family's local attention,
// replacing src/repro/models/attention.py:301 local_attention, jnp blocks of
// w queries against key blocks i - 1 and i): key j is seen by query i iff
// i - window < j <= i, which on the real keys is JAX's mask 0 <= i - j < w
// with w = min(window, S).  It runs flash_fwd_mma_kernel at every head dim
// (the wgmma kernel takes no window), from the first key tile that holds a
// key of the block's first query's window, so the work is O(S window), not
// O(S^2); a row whose window misses a whole tile gives it zero weight (its
// masked scores count zero, not exp(0)).  Head dim 256 (recurrentgemma)
// runs it at NK = 16, Q's fragments read from shared memory as each product
// needs them rather than held in registers beside the 128 of O.  What
// bounds it: operations, 4 B H D sum_i min(i + 1, window) FLOPs.
//
// flash_fwd.  What bounds it: operations (4 B H D S^2 / 2 with the
// causal half, against 989 TFLOP/s of bf16 tensor cores; its bytes, q, k,
// v and out once, take a third of that time).  Only wgmma reaches that
// rate, and the tensor cores must not wait on loads or on the softmax, so
// for D = 64 and 128 (every config of the repo) it is FlashAttention-3-
// shaped, flash_fwd_wgmma_kernel.  A work item is 128 query rows (a row is
// one (position, query head) pair: all G heads of a KV head for 128 / G
// positions, so each K and V tile is read once for the group), and a
// persistent grid of one CTA an SM walks the items, those with the most
// key tiles under the causal mask first, in rounds that zigzag across the
// CTAs.  A CTA is three warpgroups.  Warpgroup 2 is the producer: it gives
// its registers to the consumers (setmaxnreg), and one thread issues TMA
// loads, each item's Q (a [positions, G, D] box of q; rows past the box
// zeroed once) behind a Q full/empty barrier pair, then its K and V tiles
// of 128 keys into a ring of three stages guarded by mbarriers (full: the
// bytes landed; empty: both consumers are done).  Warpgroups 0 and 1 each
// own 64 rows: S = Q K^T by wgmma from shared memory (both operands
// K-major, 128-byte swizzled as TMA writes them), the online softmax in
// f32 on the accumulator in base 2 (one FFMA and one MUFU.EX2 an element,
// the 4 threads of a row reduced by shuffles), then O += P V by wgmma with
// P converted to bf16 in registers as the A operand and V read MN-major
// (transposed) from the same stage.  Tile t's S GEMM is issued before tile
// t - 1's P V GEMM, so the softmax of t waits only for S while P V runs,
// and the two warpgroups take turns to issue their GEMMs (named barriers)
// so that one's GEMMs run while the other's softmax does.  P meets V once,
// in bf16, as FlashAttention does; the card check holds it to 2x the plain
// version's error plus one bf16 ulp against float64.  Key tiles wholly
// above the diagonal are never loaded, and only tiles that cross the
// diagonal or the end of k are masked.  The consumers' S, O and P take
// about 200 registers; ptxas fits them only under setmaxnreg's 240 (at
// 168, or with a clock read and trap in the barrier wait, it serialises
// every wgmma: PERF.md).  Other head dims (16 to 112 but 64, and 256) and
// every call with a window go to flash_fwd_mma_kernel, the first kernel:
// mma.sync m16n8k16 on tiles staged by plain loads, P split into two bf16
// products.
//
// decode_attn (flash-decoding).  What bounds it: bytes, each cache slot
// s <= pos[b] read once from K and once from V (33.6 MB at B = 8,
// qwen2-7b, pos 2,048: 10 us at 3.35 TB/s).  A step has only B * K (row,
// KV head) pairs, 32 at B = 8, for 132 SMs, so each pair's slots are cut
// into splits (the wrapper picks their number from B * K, Smax, the SMs
// and the blocks an SM holds, so that every block is resident at once:
// one wave).  A block of 8 warps (4 past D = 128) takes one split; each
// warp streams its groups of 16 slots through a two-stage cp.async ring of
// its own, computing on one stage while the next lands, so every thread
// has 16 to 32 loads of 16 bytes in flight.  Both products run on tensor cores
// (mma.sync m16n8k16 with the G <= 16 heads as the 16 rows): scores from
// ldmatrix of K, then P V from ldmatrix.trans of V, P split into bf16 high
// and low parts (two products: the kernel is bound by bytes, so P keeps
// about 16 bits for free).  Head dims that are not a multiple of 16 run
// padded with zeros.  The warps' (max, sum, output) meet in shared memory;
// a pair with one split writes its output there, otherwise each block
// stores its partial and takes a ticket, and the last block of the pair
// merges all partials, rounds to bf16 and resets the ticket for the next
// launch: one launch a step, no second kernel.  Launches that share a ticket
// buffer must not overlap, so the wrapper keeps one buffer per stream.

#include "hopper.cuh"  // mbarriers, TMA, wgmma, mma.sync, ex2

namespace {

constexpr float kNeg = -1e30f;  // the JAX package's _NEG
constexpr float kLn2 = 0.6931471805599453f;

// Two floats as a bf16 pair (lo in the low half), and the remainders
// that bf16 dropped as a second pair.
__device__ __forceinline__ void split_bf16x2(float lo, float hi, uint32_t& big, uint32_t& small) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  const float2 back = __bfloat1622float2(b);
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo - back.x, hi - back.y);
  big = *reinterpret_cast<const uint32_t*>(&b);
  small = *reinterpret_cast<const uint32_t*>(&r);
}

// ---- flash_fwd: mma.sync (head dims other than 64 and 128) ------------------

constexpr int kFaRows = 128;          // query rows of a block
constexpr int kFaWarps = kFaRows / 16;
constexpr int kFaThreads = 32 * kFaWarps;
constexpr int kFaKeys = 64;           // keys of a tile

template <int NK>  // D = 16 * NK
__global__ void __launch_bounds__(kFaThreads) flash_fwd_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int S, int Skv, int K, int G, int bq, int causal, int window,
    float scale) {
  constexpr int D = 16 * NK;
  // past D = 128, Q's fragments are read from shared memory at each product:
  // held in registers beside O's 2 NK x 4 they would spill
  constexpr bool kQInRegs = NK <= 8;
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
  // this warp's A fragment of Q for the product's 16 columns from kk * 16
  auto q_frag = [&](int kk, uint32_t (&a)[4]) {
    const int c = kk * 16 + tig * 2;
    a[0] = *reinterpret_cast<const uint32_t*>(Qs + r0 * LD + c);
    a[1] = *reinterpret_cast<const uint32_t*>(Qs + r1 * LD + c);
    a[2] = *reinterpret_cast<const uint32_t*>(Qs + r0 * LD + c + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(Qs + r1 * LD + c + 8);
  };
  uint32_t qa[kQInRegs ? NK : 1][4];
  if constexpr (kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) q_frag(kk, qa[kk]);
  }

  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  float o[2 * NK][4];
#pragma unroll
  for (int nd = 0; nd < 2 * NK; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;

  // keys this block needs: causal rows see keys j <= i < q0 + nq; with a
  // window, keys j > q0 - window, from the tile that holds the first
  const int kv_end = causal ? min(Skv, q0 + nq) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / kFaKeys * kFaKeys : 0;
  for (int kt0 = kv_begin; kt0 < kv_end; kt0 += kFaKeys) {
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
    if constexpr (kQInRegs) {
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
    } else {  // the same products, each s[nt] summed over kk in the same order
#pragma unroll
      for (int nt = 0; nt < kFaKeys / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t a[4];
        q_frag(kk, a);
#pragma unroll
        for (int nt = 0; nt < kFaKeys / 8; ++nt) {
          const __nv_bfloat16* krow = Ks + (nt * 8 + grp) * LD + tig * 2 + kk * 16;
          mma_bf16(s[nt], a, *reinterpret_cast<const uint32_t*>(krow),
                   *reinterpret_cast<const uint32_t*>(krow + 8));
        }
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
        const bool masked =
            key >= Skv || (causal && key > pos) || (window > 0 && key <= pos - window);
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
    // a masked score weighs zero: exp(kNeg - m) is 0 wherever the row has
    // seen a key, but 1 while m is still kNeg (a window that misses the tile)
#pragma unroll
    for (int nt = 0; nt < kFaKeys / 8; ++nt) {
      s[nt][0] = s[nt][0] == kNeg ? 0.f : expf(s[nt][0] - m0);
      s[nt][1] = s[nt][1] == kNeg ? 0.f : expf(s[nt][1] - m0);
      s[nt][2] = s[nt][2] == kNeg ? 0.f : expf(s[nt][2] - m1);
      s[nt][3] = s[nt][3] == kNeg ? 0.f : expf(s[nt][3] - m1);
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
    if (lse != nullptr && tig == 0)  // m in natural units of the scaled scores
      lse[(((size_t)b * K + kh) * G + g) * S + s_pos] =
          (half ? m1 : m0) + logf(fmaxf(half ? l1 : l0, 1e-30f));
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
cudaError_t launch_flash_mma(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                         __nv_bfloat16* out, float* lse, int B, int S, int Skv, int K, int G,
                         int causal, int window, float scale, cudaStream_t stream) {
  constexpr int D = 16 * NK;
  const size_t smem = (size_t)(kFaRows + 2 * kFaKeys) * (D + 8) * sizeof(__nv_bfloat16);
  const cudaError_t err = smem_limit_once<flash_fwd_mma_kernel<NK>>(smem);
  if (err != cudaSuccess) return err;
  const int bq = kFaRows / G;
  const dim3 grid((unsigned)((S + bq - 1) / bq), (unsigned)K, (unsigned)B);
  flash_fwd_mma_kernel<NK><<<grid, kFaThreads, smem, stream>>>(q, k, v, out, lse, S, Skv, K, G,
                                                               bq, causal, window, scale);
  return cudaGetLastError();
}

// ---- flash_fwd: wgmma, TMA ring (D = 64, 128) ------------------------------

constexpr int kFwRows = 128;  // query rows of a CTA: two consumer warpgroups of 64
constexpr int kFwKeys = 128;  // keys of a K or V tile
constexpr int kFwStages = 3;  // the ring of K and V tiles
// two consumer warpgroups, then the producer warpgroup, whose registers go
// to the consumers (setmaxnreg): their S, O and P need more than the 168
// registers a thread of 384 starts with, and ptxas serialises the wgmmas
// when they do not fit
constexpr int kFwThreads = 384;
constexpr int kFwProducerRegs = 24;   // 128 x 24 + 256 x 240 <= 65,536
constexpr int kFwConsumerRegs = 240;

static_assert(kFwRows == kFwKeys, "a half of Q and of a K or V tile share one size");

// Byte offsets in the CTA's shared memory.  Every tile is stored as 64-wide
// column halves of 128-byte rows (TMA's 128-byte swizzle spans one row), each
// half 1024-byte aligned.
template <int D>
struct FwSmem {
  static constexpr int kHalves = D / 64;
  static constexpr int kHalfRows = kFwRows;  // rows of a half of Q or of a tile
  static constexpr int kQ = 0;
  static constexpr int kQBytes = kHalves * kFwRows * 128;
  static constexpr int kTileBytes = kHalves * kFwKeys * 128;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kFwStages * kTileBytes;
  static constexpr int kBar = kV + kFwStages * kTileBytes;  // q_full, q_empty, full[], empty[]
  static constexpr int kBytes = kBar + 64 + 1024;           // and room to align the base
};

template <int D>
__global__ void __launch_bounds__(kFwThreads, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int S, int Skv, int K, int G, int npos, int n_qblocks, int n_pairs,
    int causal, float scale_log2) {
  using L = FwSmem<D>;
  constexpr int kHalfBytes = L::kHalfRows * 128;
  extern __shared__ __align__(1024) unsigned char fw_smem[];
  const uint32_t raw = smem_u32(fw_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = fw_smem + (base - raw);
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t bar_q_full = base + L::kBar, bar_q_empty = bar_q_full + 8;
  const uint32_t bar_full = bar_q_full + 16, bar_empty = bar_full + 8 * kFwStages;
  const int n_items = n_qblocks * n_pairs;

  // Work item i: the query blocks with the most key tiles under the causal
  // mask come first.  Round r gives CTA c item r * grid + c, or
  // r * grid + grid - 1 - c in odd rounds, so that the CTAs' sums of
  // decreasing lengths even out.
  const int grid = gridDim.x, c = blockIdx.x;
  auto item_of = [&](int r) { return r * grid + ((r & 1) ? grid - 1 - c : c); };
  struct Item {
    int b, kh, q0, nq, n_tiles;
  };
  auto item = [&](int i) {
    Item it;
    const int pair = i % n_pairs, qb = n_qblocks - 1 - i / n_pairs;
    it.b = pair / K;
    it.kh = pair % K;
    it.q0 = qb * npos;
    it.nq = min(npos, S - it.q0);
    const int kv_end = causal ? min(Skv, it.q0 + it.nq) : Skv;
    it.n_tiles = (kv_end + kFwKeys - 1) / kFwKeys;
    return it;
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_q_full, 1);
    mbar_init(bar_q_empty, 2 * 128);  // every consumer thread arrives
    for (int s = 0; s < kFwStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer warpgroup: one thread issues every load -----------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kFwProducerRegs));
    if (threadIdx.x == 256) {
      int tile = 0;  // tiles loaded so far: the ring's stage and phase
      for (int j = 0; item_of(j) < n_items; ++j) {
        const Item w = item(item_of(j));
        mbar_wait(bar_q_empty, (j & 1) ^ 1);  // the last item's S GEMMs are done
        mbar_expect_tx(bar_q_full, (uint32_t)(D * G * npos * 2));
#pragma unroll
        for (int h = 0; h < L::kHalves; ++h)
          tma_load_5d(sQ + h * kHalfBytes, &tm_q, bar_q_full, 64 * h, 0, w.kh, w.q0, w.b);
        for (int t = 0; t < w.n_tiles; ++t, ++tile) {
          const int st = tile % kFwStages;
          mbar_wait(bar_empty + 8 * st, ((tile / kFwStages) & 1) ^ 1);
          mbar_expect_tx(bar_full + 8 * st, 2 * L::kTileBytes);
#pragma unroll
          for (int h = 0; h < L::kHalves; ++h) {
            const uint32_t off = st * L::kTileBytes + h * kHalfBytes;
            tma_load_4d(sK + off, &tm_k, bar_full + 8 * st, 64 * h, w.kh, t * kFwKeys, w.b);
            tma_load_4d(sV + off, &tm_v, bar_full + 8 * st, 64 * h, w.kh, t * kFwKeys, w.b);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kFwConsumerRegs));
    const int tw = threadIdx.x - 128 * wg, wi = tw >> 5, lane = tw & 31;
    // rows past the TMA box (npos * G of the 128) are never loaded: zero them
    const int boxed = npos * G;
    for (int i = tw; i < L::kHalves * 64 * 8; i += 128) {
      const int h = i / 512, r = 64 * wg + (i / 8) % 64, ch = i % 8;
      if (r >= boxed)
        *reinterpret_cast<uint4*>(gbase + L::kQ + h * kHalfBytes + r * 128 + ch * 16) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

    const int r0 = 64 * wg + 16 * wi + (lane >> 2), r1 = r0 + 8;
    const int col = 2 * (lane & 3);
    float o[D / 2];
    uint32_t pa[kFwKeys / 16][4];  // P of the previous tile, wgmma's A operand
    float m0, m1, l0, l1;
    int pos0, pos1, q0;  // of the current item

    // S = Q K^T of the tile in stage st: 64 rows x 128 keys, D / 16 steps
    auto qk = [&](float (&s)[64], int st) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t half = (kk / 4) * kHalfBytes, step = (kk % 4) * 32;
        wgmma_ss_n128(s, sw128_desc(sQ + half + wg * 64 * 128 + step, 0),
                      sw128_desc(sK + st * L::kTileBytes + half + step, 0), kk);
      }
      wgmma_commit();
    };
    // O += P V of the tile in stage st: 16 keys a step, V MN-major (its
    // 64-wide halves LBO apart)
    auto pv = [&](int st) {
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kFwKeys / 16; ++kk) {
        const uint64_t dv = sw128_desc(sV + st * L::kTileBytes + kk * 16 * 128, kHalfBytes);
        if constexpr (D == 128) {
          wgmma_rs_n128(o, pa[kk], dv);
        } else {
          wgmma_rs_n64(o, pa[kk], dv);
        }
      }
      wgmma_commit();
    };
    // The online softmax of tile t in base 2 (m in units of the scaled
    // scores): masks the tiles that cross the diagonal or Skv, turns s into
    // P = exp2(scale S - m) in f32, and returns the rescale of O and l for
    // each of the thread's two rows.
    auto softmax = [&](float (&s)[64], int t, float& c0, float& c1) {
      const int kt0 = t * kFwKeys;
      if (kt0 + kFwKeys > Skv || (causal && kt0 + kFwKeys - 1 > q0)) {
#pragma unroll
        for (int j = 0; j < kFwKeys / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kt0 + 8 * j + col + (e & 1);
            if (key >= Skv || (causal && key > (e < 2 ? pos0 : pos1))) s[4 * j + e] = kNeg;
          }
      }
      float mx0 = s[0], mx1 = s[2];
#pragma unroll
      for (int j = 0; j < kFwKeys / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      mx0 = fmaxf(m0, mx0 * scale_log2);  // the scale is positive: max commutes
      mx1 = fmaxf(m1, mx1 * scale_log2);
      c0 = ex2(m0 - mx0);
      c1 = ex2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      // this thread's share of the row sums; the 4 of a row add up at the end
      l0 *= c0;
      l1 *= c1;
#pragma unroll
      for (int j = 0; j < kFwKeys / 8; ++j) {
        s[4 * j] = ex2(fmaf(s[4 * j], scale_log2, -m0));
        s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], scale_log2, -m0));
        s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], scale_log2, -m1));
        s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], scale_log2, -m1));
        l0 += s[4 * j] + s[4 * j + 1];
        l1 += s[4 * j + 2] + s[4 * j + 3];
      }
    };
    // P in bf16 as the A operand: the accumulator of keys 16kk..16kk+15 is
    // the A fragment of step kk
    auto to_a = [&](const float (&s)[64]) {
#pragma unroll
      for (int kk = 0; kk < kFwKeys / 16; ++kk) {
        pa[kk][0] = pack_bf16x2(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };
    auto rescale = [&](float c0, float c1) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= c0;
        o[4 * j + 1] *= c0;
        o[4 * j + 2] *= c1;
        o[4 * j + 3] *= c1;
      }
    };
    // Ping-pong: the two warpgroups take turns to issue their GEMMs (named
    // barriers 3 and 4), so that one's GEMMs run while the other does its
    // softmax.  A turn is one sync on this warpgroup's barrier, then one
    // arrive on the other's.  Warpgroup 1 opens with an arrive, and
    // warpgroup 0 closes with a sync, so every arrive meets one sync.
    auto my_turn = [&] { asm volatile("bar.sync %0, 256;\n" ::"r"(3 + wg) : "memory"); };
    auto your_turn = [&] { asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - wg) : "memory"); };
    if (wg == 1) asm volatile("bar.arrive 3, 256;\n" ::: "memory");

    int tile = 0;  // tiles consumed so far: the ring's stage and phase
    for (int j = 0; item_of(j) < n_items; ++j) {
      const Item w = item(item_of(j));
      q0 = w.q0;
      const int rows = w.nq * G;  // real rows: row r = (position q0 + r / G, head r % G)
      // rows past the real ones have no position: no causal mask, zero q
      pos0 = r0 < rows ? q0 + r0 / G : 0x7fffffff;
      pos1 = r1 < rows ? q0 + r1 / G : 0x7fffffff;
      m0 = m1 = kNeg;
      l0 = l1 = 0.f;
#pragma unroll
      for (int x = 0; x < D / 2; ++x) o[x] = 0.f;

      mbar_wait(bar_q_full, j & 1);
      float c0, c1;  // the rescale of O from the latest softmax
      {
        const int st = tile % kFwStages;
        mbar_wait(bar_full + 8 * st, (tile / kFwStages) & 1);
        float s[64];
        my_turn();
        qk(s, st);
        your_turn();
        wgmma_wait<0>();
        fence_regs(s);
        if (w.n_tiles == 1) mbar_arrive(bar_q_empty);  // Q may take the next item
        softmax(s, 0, c0, c1);
        to_a(s);
      }
      // Tile t's S = Q K^T runs on the tensor cores with the previous
      // tile's O += P V queued behind it; the softmax of tile t waits only
      // for S.
      for (int t = 1; t < w.n_tiles; ++t) {
        const int st = (tile + t) % kFwStages, prev = (tile + t - 1) % kFwStages;
        mbar_wait(bar_full + 8 * st, ((tile + t) / kFwStages) & 1);
        float s[64];
        my_turn();
        qk(s, st);
        rescale(c0, c1);  // O is not in flight: the previous P V has completed
        pv(prev);
        your_turn();
        wgmma_wait<1>();  // S of tile t
        fence_regs(s);
        if (t == w.n_tiles - 1) mbar_arrive(bar_q_empty);
        softmax(s, t, c0, c1);
        wgmma_wait<0>();  // P V of tile t - 1: its stage is free
        fence_regs(o);
        mbar_arrive(bar_empty + 8 * prev);
        to_a(s);
      }
      tile += w.n_tiles;
      my_turn();
      rescale(c0, c1);
      pv((tile - 1) % kFwStages);
      your_turn();
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(bar_empty + 8 * ((tile - 1) % kFwStages));

      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = half ? r1 : r0;
        if (r >= rows) continue;
        const float inv = half ? inv1 : inv0;
        const int s_pos = q0 + r / G, g = r % G;
        if (lse != nullptr && col == 0)  // m in base-2 units of the scaled scores
          lse[(((size_t)w.b * K + w.kh) * G + g) * S + s_pos] =
              ((half ? m1 : m0) + log2f(fmaxf(half ? l1 : l0, 1e-30f))) * kLn2;
        __nv_bfloat16* dst =
            out + ((((size_t)w.b * S + s_pos) * K + w.kh) * G + g) * D + col;
#pragma unroll
        for (int x = 0; x < D / 8; ++x)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * x) =
              __floats2bfloat162_rn(o[4 * x + 2 * half] * inv, o[4 * x + 2 * half + 1] * inv);
      }
    }
    if (wg == 0) my_turn();  // warpgroup 1's last arrive
  }
}

template <int D>
cudaError_t launch_flash_wgmma(const __nv_bfloat16* q, const __nv_bfloat16* k,
                               const __nv_bfloat16* v, __nv_bfloat16* out, float* lse, int B,
                               int S, int Skv, int K, int G, int causal, float scale,
                               cudaStream_t stream) {
  const int npos = kFwRows / G;
  const cuuint64_t e = sizeof(__nv_bfloat16);
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map<5>(
      &tq, q, {(cuuint64_t)D, (cuuint64_t)G, (cuuint64_t)K, (cuuint64_t)S, (cuuint64_t)B},
      {D * e, (cuuint64_t)G * D * e, (cuuint64_t)K * G * D * e, (cuuint64_t)S * K * G * D * e},
      {64u, (cuuint32_t)G, 1u, (cuuint32_t)npos, 1u});
  if (err != cudaSuccess) return err;
  const cuuint64_t kv_dims[4] = {(cuuint64_t)D, (cuuint64_t)K, (cuuint64_t)Skv, (cuuint64_t)B};
  const cuuint64_t kv_strides[3] = {D * e, (cuuint64_t)K * D * e, (cuuint64_t)Skv * K * D * e};
  const cuuint32_t kv_box[4] = {64u, 1u, (cuuint32_t)kFwKeys, 1u};
  if ((err = make_map<4>(&tk, k, kv_dims, kv_strides, kv_box)) != cudaSuccess) return err;
  if ((err = make_map<4>(&tv, v, kv_dims, kv_strides, kv_box)) != cudaSuccess) return err;
  if ((err = smem_limit_once<flash_fwd_wgmma_kernel<D>>(FwSmem<D>::kBytes)) != cudaSuccess)
    return err;
  const int n_qblocks = (S + npos - 1) / npos;
  const long long items = (long long)n_qblocks * B * K;
  if (items > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  // persistent: one CTA an SM, each walking the work items a grid's stride apart
  const unsigned blocks = (unsigned)(items < sms ? items : sms);
  flash_fwd_wgmma_kernel<D><<<blocks, kFwThreads, FwSmem<D>::kBytes, stream>>>(
      tq, tk, tv, out, lse, S, Skv, K, G, npos, n_qblocks, B * K, causal, scale * kLog2e);
  return cudaGetLastError();
}


// ---- decode_attn: one-wave streaming flash-decode ----------------------------

// Warps of a block: 8 of two stages take 139 KB at D = 128, one block an SM
// and 4 splits a pair at B = 8 (16.1-16.8 us on an H100, against 20.7-21.1
// us for 4 warps of two stages at three blocks an SM and 12 splits:
// PERF.md); past D = 128, 4 warps, or the rings outgrow the 227 KB.
__host__ __device__ constexpr int dc_warps(int NT) { return NT <= 8 ? 8 : 4; }
constexpr int kDcGroup = 16;  // slots of a stage: one k-step of P V, two n-tiles of q K^T
constexpr int kDcStages = 2;  // each warp's cp.async ring
constexpr int kDcMaxG = 16;       // the G heads are the 16 rows of the mma
constexpr int kDcMaxSplits = 128;
constexpr float kDcInit = -3e38f;  // a running max below any score, masked ones included

// Slots of row b that the step reads: s <= pos, or all Smax (masked) when
// pos < 0.
__device__ __forceinline__ int decode_valid(int p, int Smax) {
  return p < 0 ? Smax : min(p + 1, Smax);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Shared memory of a decode block: the warps' rings, reused after the loop
// for the warps' partials and then the merge's weights.
template <int NT>
constexpr size_t decode_smem_bytes() {
  constexpr int DP = 16 * NT, kDcWarps = dc_warps(NT);
  constexpr size_t ring = (size_t)kDcWarps * kDcStages * 2 * kDcGroup * (DP + 8) * 2;
  constexpr size_t part = (size_t)(2 * kDcWarps * kDcMaxG + kDcWarps * kDcMaxG * DP +
                                   2 * kDcMaxG + kDcWarps * kDcMaxG) * 4;
  constexpr size_t merge = (size_t)(kDcMaxSplits * kDcMaxG + kDcMaxG) * 4;
  return ring > part ? (ring > merge ? ring : merge) : (part > merge ? part : merge);
}

template <int NT>  // head dim padded to DP = 16 * NT (the pad is zeros)
__global__ void __launch_bounds__(32 * dc_warps(NT), 1) decode_attn_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
    const __nv_bfloat16* __restrict__ vc, const int32_t* __restrict__ pos,
    float* __restrict__ part_o, float2* __restrict__ part_ml, int* __restrict__ tickets,
    __nv_bfloat16* __restrict__ out, int Smax, int K, int G, int D, int n_splits, int split_len,
    float scale_log2) {
  constexpr int DP = 16 * NT, LD = DP + 8, CH = DP / 8;
  constexpr int kDcWarps = dc_warps(NT), kDcThreads = 32 * kDcWarps;
  constexpr int kStage = 2 * kDcGroup * LD;  // K then V, in elements
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int p = pos[b];
  const int n_valid = decode_valid(p, Smax);
  const int start = split * split_len;
  if (start >= n_valid) return;  // the merge counts only splits below n_valid
  const int end = min(start + split_len, n_valid);
  const int n_act = (n_valid + split_len - 1) / split_len;
  const int pair = b * K + kh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;

  __nv_bfloat16* ring =
      reinterpret_cast<__nv_bfloat16*>(smem_raw) + warp * kDcStages * kStage;
  const int n_groups = (end - start + kDcGroup - 1) / kDcGroup;
  const size_t slot_stride = (size_t)K * D;
  const __nv_bfloat16* kbase = kc + ((size_t)b * Smax * K + kh) * D;
  const __nv_bfloat16* vbase = vc + ((size_t)b * Smax * K + kh) * D;

  // Group gi of the split into ring stage st; past `end` and past D the
  // copy reads nothing and writes zeros (0 * a zero p stays 0).
  auto issue = [&](int gi, int st) {
    if (gi < n_groups) {
      const int s0 = start + gi * kDcGroup;
      __nv_bfloat16* dst = ring + st * kStage;
#pragma unroll
      for (int it = 0; it < CH; ++it) {  // 2 * kDcGroup * CH chunks, 32 a pass
        const int c = lane + 32 * it;
        const int kv = c / (kDcGroup * CH), r = (c / CH) % kDcGroup, part = c % CH;
        const bool ok = s0 + r < end && part * 8 < D;
        const __nv_bfloat16* src =
            (kv ? vbase : kbase) + (size_t)(ok ? s0 + r : start) * slot_stride + (ok ? part * 8 : 0);
        cp_async16(dst + (kv * kDcGroup + r) * LD + part * 8, src, ok ? 16 : 0);
      }
    }
    cp_async_commit();  // an empty group keeps the count of groups in step
  };
#pragma unroll
  for (int st = 0; st < kDcStages; ++st) issue(warp + st * kDcWarps, st);

  // q as the A operand: rows the G heads (zeros past G), k-steps of 16 dims
  const __nv_bfloat16* qrow = q + (size_t)pair * G * D;
  auto q_pair = [&](int g, int d) -> uint32_t {
    return g < G && d < D ? *reinterpret_cast<const uint32_t*>(qrow + g * D + d) : 0u;
  };
  uint32_t qa[NT][4];
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    const int d = 16 * kk + 2 * tig;
    qa[kk][0] = q_pair(grp, d);
    qa[kk][1] = q_pair(grp + 8, d);
    qa[kk][2] = q_pair(grp, d + 8);
    qa[kk][3] = q_pair(grp + 8, d + 8);
  }

  float m0 = kDcInit, m1 = kDcInit, l0 = 0.f, l1 = 0.f;  // heads grp and grp + 8
  float o[2 * NT][4];
#pragma unroll
  for (int nd = 0; nd < 2 * NT; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;

  for (int i = 0;; ++i) {
    const int gi = warp + i * kDcWarps;
    if (gi >= n_groups) break;
    cp_async_wait<kDcStages - 1>();
    __syncwarp();
    const __nv_bfloat16* Ks = ring + (i % kDcStages) * kStage;
    const __nv_bfloat16* Vs = Ks + kDcGroup * LD;

    // scores of the 16 slots: n-tile 0 slots 0-7, n-tile 1 slots 8-15
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    {
      const int mat = lane >> 3;
      const __nv_bfloat16* kp = Ks + ((mat >> 1) * 8 + (lane & 7)) * LD + (mat & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        uint32_t kb[4];
        ldmatrix_x4(kb, kp + 16 * kk);
        mma_bf16(sc[0], qa[kk], kb[0], kb[1]);
        mma_bf16(sc[1], qa[kk], kb[2], kb[3]);
      }
    }
    const int s0 = start + gi * kDcGroup;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int slot = s0 + 8 * n + 2 * tig + (e & 1);
        // past the split: -inf, no part of the softmax; pos < 0: every slot at _NEG
        sc[n][e] = slot >= end ? -__int_as_float(0x7f800000)
                               : (p < 0 ? kNeg : sc[n][e] * scale_log2);
      }
      mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int nd = 0; nd < 2 * NT; ++nd) {
      o[nd][0] *= c0;
      o[nd][1] *= c0;
      o[nd][2] *= c1;
      o[nd][3] *= c1;
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      sc[n][0] = exp2f(sc[n][0] - m0);
      sc[n][1] = exp2f(sc[n][1] - m0);
      sc[n][2] = exp2f(sc[n][2] - m1);
      sc[n][3] = exp2f(sc[n][3] - m1);
      l0 += sc[n][0] + sc[n][1];
      l1 += sc[n][2] + sc[n][3];
    }
    // P as the A operand (the two n-tiles of scores are one k-step), high
    // and low bf16 parts
    uint32_t ph[4], pl[4];
    split_bf16x2(sc[0][0], sc[0][1], ph[0], pl[0]);
    split_bf16x2(sc[0][2], sc[0][3], ph[1], pl[1]);
    split_bf16x2(sc[1][0], sc[1][1], ph[2], pl[2]);
    split_bf16x2(sc[1][2], sc[1][3], ph[3], pl[3]);
    {
      // ldmatrix.trans: matrices (slots 0-7, dims d), (8-15, d), (0-7, d+8), (8-15, d+8)
      const __nv_bfloat16* vp =
          Vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int nd = 0; nd < 2 * NT; nd += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vp + nd * 8);
        mma_bf16(o[nd], ph, vb[0], vb[1]);
        mma_bf16(o[nd], pl, vb[0], vb[1]);
        mma_bf16(o[nd + 1], ph, vb[2], vb[3]);
        mma_bf16(o[nd + 1], pl, vb[2], vb[3]);
      }
    }
    __syncwarp();  // the stage's readers are done before it is refilled
    issue(gi + kDcStages * kDcWarps, i % kDcStages);
  }
  cp_async_wait<0>();
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  __syncthreads();  // every warp is out of its ring

  // the warps' partials: wm, wl [warps][16], wo [warps][16][DP]
  float* wm = reinterpret_cast<float*>(smem_raw);
  float* wl = wm + kDcWarps * kDcMaxG;
  float* wo = wl + kDcWarps * kDcMaxG;
  float* bm = wo + kDcWarps * kDcMaxG * DP;  // the block's max and sum per head
  float* bl = bm + kDcMaxG;
  float* ww = bl + kDcMaxG;  // [warps][16]: each warp's weight exp2(m_w - M)
  if (tig == 0) {
    wm[warp * kDcMaxG + grp] = m0;
    wm[warp * kDcMaxG + grp + 8] = m1;
    wl[warp * kDcMaxG + grp] = l0;
    wl[warp * kDcMaxG + grp + 8] = l1;
  }
#pragma unroll
  for (int nd = 0; nd < 2 * NT; ++nd) {
    float* row0 = wo + (warp * kDcMaxG + grp) * DP + 8 * nd + 2 * tig;
    float* row1 = row0 + 8 * DP;
    row0[0] = o[nd][0];
    row0[1] = o[nd][1];
    row1[0] = o[nd][2];
    row1[1] = o[nd][3];
  }
  __syncthreads();
  if (tid < G) {
    float M = kDcInit;
    for (int w = 0; w < kDcWarps; ++w) M = fmaxf(M, wm[w * kDcMaxG + tid]);
    float Lsum = 0.f;
    for (int w = 0; w < kDcWarps; ++w) {
      const float wt = exp2f(wm[w * kDcMaxG + tid] - M);
      ww[w * kDcMaxG + tid] = wt;
      Lsum += wt * wl[w * kDcMaxG + tid];
    }
    bm[tid] = M;
    bl[tid] = Lsum;
  }
  __syncthreads();
  const size_t part_row = (size_t)pair * n_splits + split;
  __nv_bfloat16* dst = out + (size_t)pair * G * D;
  for (int idx = tid; idx < G * D; idx += kDcThreads) {
    const int g = idx / D, d = idx % D;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kDcWarps; ++w)
      acc += ww[w * kDcMaxG + g] * wo[(w * kDcMaxG + g) * DP + d];
    if (n_act == 1)
      dst[idx] = __float2bfloat16_rn(acc / fmaxf(bl[g], 1e-30f));
    else
      part_o[part_row * G * D + idx] = acc;
  }
  if (n_act == 1) return;
  if (tid < G) part_ml[part_row * G + tid] = make_float2(bm[tid], bl[tid]);

  // the last block of the pair to finish merges the splits
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (tid == 0) last = atomicAdd(tickets + pair, 1) == n_act - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* mw = reinterpret_cast<float*>(smem_raw);  // [n_act][16] weights, then the sums
  float* msum = mw + kDcMaxSplits * kDcMaxG;
  const float2* ml = part_ml + (size_t)pair * n_splits * G;
  if (tid < G) {
    float M = kDcInit;
    for (int c = 0; c < n_act; ++c) M = fmaxf(M, __ldcg(ml + c * G + tid).x);
    float Lsum = 0.f;
    for (int c = 0; c < n_act; ++c) {
      const float2 v = __ldcg(ml + c * G + tid);
      const float wt = exp2f(v.x - M);
      mw[c * kDcMaxG + tid] = wt;
      Lsum += wt * v.y;
    }
    msum[tid] = Lsum;
  }
  __syncthreads();
  const float* po = part_o + (size_t)pair * n_splits * G * D;
  for (int idx = tid; idx < G * D; idx += kDcThreads) {
    const int g = idx / D;
    float acc = 0.f;
    for (int c = 0; c < n_act; ++c) acc += mw[c * kDcMaxG + g] * __ldcg(po + (size_t)c * G * D + idx);
    dst[idx] = __float2bfloat16_rn(acc / fmaxf(msum[g], 1e-30f));
  }
  if (tid == 0) tickets[pair] = 0;  // ready for the next launch
}

template <int NT>
cudaError_t launch_decode(const void* q, const void* kc, const void* vc, const void* pos,
                          void* part_o, void* part_ml, void* tickets, void* out, int B, int Smax,
                          int K, int G, int D, int n_splits, int split_len, float scale,
                          cudaStream_t stream) {
  constexpr size_t smem = decode_smem_bytes<NT>();
  cudaError_t err = smem_limit_once<decode_attn_kernel<NT>>(smem);
  if (err != cudaSuccess) return err;
  decode_attn_kernel<NT><<<dim3((unsigned)n_splits, (unsigned)K, (unsigned)B),
                           32 * dc_warps(NT), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), static_cast<const int32_t*>(pos),
      static_cast<float*>(part_o), static_cast<float2*>(part_ml), static_cast<int*>(tickets),
      static_cast<__nv_bfloat16*>(out), Smax, K, G, D, n_splits, split_len, scale * kLog2e);
  return cudaGetLastError();
}

template <int NT>
int decode_blocks(int* blocks) {
  constexpr size_t smem = decode_smem_bytes<NT>();
  const cudaError_t err = smem_limit_once<decode_attn_kernel<NT>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, decode_attn_kernel<NT>, 32 * dc_warps(NT), smem));
}

}  // namespace

#define DC_CASES(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

extern "C" {

// Launches flash_fwd on `stream`.  D = 16 * nk with 1 <= nk <= 8 or
// nk = 16, G <= 128; all pointers 16-byte aligned (the wrapper checks).
// window > 0 (with causal) also masks keys j <= i - window: row 13.  D = 64
// and 128 without a window run the wgmma kernel, the rest the mma.sync one.
// `lse` is null, or [B, K, G, S] f32 that receives each row's log-sum-exp
// (natural log units).  Returns a cudaError_t.
int flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B, int S,
              int Skv, int K, int G, int D, int causal, int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Skv <= 0 || K <= 0 || G <= 0 || G > kFaRows || D % 16 != 0 ||
      window < 0 || (window > 0 && !causal))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* lp = static_cast<float*>(lse);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool wg = window == 0;  // the wgmma kernel takes no window
  cudaError_t err;
#define FA_MMA(n) launch_flash_mma<n>(qp, kp, vp, op, lp, B, S, Skv, K, G, causal, window, scale, st)
  switch (D / 16) {
    case 1: err = FA_MMA(1); break;
    case 2: err = FA_MMA(2); break;
    case 3: err = FA_MMA(3); break;
    case 4:
      err = wg ? launch_flash_wgmma<64>(qp, kp, vp, op, lp, B, S, Skv, K, G, causal, scale, st)
               : FA_MMA(4);
      break;
    case 5: err = FA_MMA(5); break;
    case 6: err = FA_MMA(6); break;
    case 7: err = FA_MMA(7); break;
    case 8:
      err = wg ? launch_flash_wgmma<128>(qp, kp, vp, op, lp, B, S, Skv, K, G, causal, scale, st)
               : FA_MMA(8);
      break;
    case 16: err = FA_MMA(16); break;
    default: err = cudaErrorInvalidValue;
  }
#undef FA_MMA
  return static_cast<int>(err);
}

// The decode kernel's geometry for head dim D: the blocks one SM holds at
// once, the slots of a stage (a split's length is a multiple) and the most
// splits of a pair; returns a cudaError_t.  The wrapper cuts the cache into
// splits from them and checks its own copy of the last two against them.
int decode_attn_geometry(int D, int* blocks, int* group, int* max_splits) {
  if (D <= 0 || D % 8 != 0 || D > 256) return static_cast<int>(cudaErrorInvalidValue);
  *group = kDcGroup;
  *max_splits = kDcMaxSplits;
  switch ((D + 15) / 16) {
#define DC_BLOCKS(n) \
  case n: return decode_blocks<n>(blocks);
    DC_CASES(DC_BLOCKS)
#undef DC_BLOCKS
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launches decode_attn on `stream`: one launch, the merge in its last block
// per (row, KV head).  Splits of `split_len` slots (a multiple of 16),
// n_splits of them per pair (n_splits <= 128, n_splits * split_len >= Smax).
// Workspaces: part_o [B, K, n_splits, G, D] f32 and part_ml
// [B, K, n_splits, G, 2] f32, uninitialised; tickets [B * K] int32, zero
// before the launch and zero after it (launches that share them must run one
// after another: the wrapper keeps one buffer per stream).  D % 8 == 0,
// D <= 256, G <= 16; pointers 16-byte aligned.  Returns a cudaError_t.
int decode_attn(const void* q, const void* kc, const void* vc, const void* pos, void* part_o,
                void* part_ml, void* tickets, void* out, int B, int Smax, int K, int G, int D,
                int n_splits, int split_len, float scale, void* stream) {
  if (B <= 0 || Smax <= 0 || K <= 0 || G <= 0 || G > kDcMaxG || D <= 0 || D % 8 != 0 ||
      D > 256 || n_splits <= 0 || n_splits > kDcMaxSplits || split_len <= 0 ||
      split_len % kDcGroup != 0 || (long long)n_splits * split_len < Smax)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16) {
#define DC_LAUNCH(n)                                                                           \
  case n:                                                                                      \
    return static_cast<int>(launch_decode<n>(q, kc, vc, pos, part_o, part_ml, tickets, out, B, \
                                             Smax, K, G, D, n_splits, split_len, scale, st));
    DC_CASES(DC_LAUNCH)
#undef DC_LAUNCH
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
