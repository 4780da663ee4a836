// Row 12 of the kernel table: the MoE FFN's routed experts
// (repro/models/ffn.py `moe_ffn`, its jnp `_expert_mlp`, not a Pallas
// site), over rows laid out compactly by (expert, group, position).
//
// The JAX function runs its expert MLP as einsums over a capacity-padded
// [n_groups, E, C, d] buffer, which reads every expert's weights whatever
// the routing.  Here the kept (token, choice) pairs of each (expert, group)
// are one run of rows in x [R, d], from offsets[e*n + g] to
// offsets[e*n + g + 1] (int32 on the device, at most `rows_bound` rows a
// run), so each expert's rows of every group are one stretch, and two
// launches compute
//
//   moe_up:   h = act(x @ w_gate[e]) * (x @ w_in[e])   [R, f]  (GLU), or act(x @ w_in[e])
//   moe_down: y = h @ w_out[e]                         [R, d]
//
// Bound: at decode (a few rows an expert) the touched experts' weights,
// 3 d f bf16 each: bytes; at prefill (hundreds of rows an expert) the
// products, 6 R d f FLOPs.  Both kernels are one persistent grouped GEMM
// on wgmma and TMA.  A block is a producer warpgroup, whose one thread
// keeps a ring of 64-deep stages full by TMA (the row tile of x or h,
// K-major, one 2-D box from the tile's first row; the weight tile of w_in
// and w_gate, or of w_out, MN-major in 64-column panels), and one or two
// consumer warpgroups of 64 rows, which multiply each stage from shared
// memory into f32 registers, one wgmma (B transposed) a 16-deep step.
// For a GLU, w_in's and w_gate's panels of the same columns sit side by
// side in a stage, so one accumulator holds both products and the
// activation and the product happen in the epilogue; neither is written
// out.  The epilogue trades the accumulator's pairs within each quad of
// lanes (two shuffle rounds), so every lane stores 16 bytes and every row
// takes whole 64-byte pieces.
//
// No size is read back to the host, and an empty expert costs no weight
// read: every block first scans the experts' row counts (from `offsets` on
// the device) into the first row tile of each, in shared memory, then
// walks the work items (row tile, column tile) j = blockIdx.x,
// blockIdx.x + gridDim.x, ... of that list, one block an SM.  A tile takes
// an expert's rows across its groups, so only an expert's last tile is
// ragged, and a consumer whose 64 rows all lie past it issues no product.
// Items of one expert are adjacent in the walk, so its weights are read
// from device memory about once while its row tiles take them from L2.
// The walk is fixed by the offsets and every output element is one f32
// sum over k in 16-deep steps in order: no atomics, and the same result
// from call to call.
//
// Two geometries, chosen on the host from `rows_bound` alone: "wide" (a
// bound over 64: prefill) takes 128-row tiles (two consumers) and 128
// columns of w_in and of w_gate, or 256 of w_out, in a four-stage ring of
// 48 KB stages.  "Narrow" (a bound up to 64: decode) takes one consumer
// of 64 rows and 64 columns of each weight (128 of w_out) an item, so that
// a few touched experts still make about an item for every SM, each with
// an 8-stage ring: 128 KB of weights in flight an SM, which is what the
// byte bound needs; its row box is an expert's most rows, rounded up to 8.
// Rows of a tile past its expert's stretch (the next expert's rows, TMA's
// zeros past R, or the narrow box's stale rows) may be loaded: each output
// row depends on its own input row only, and such rows are never stored.
// Column panels past N are TMA's zeros and are not stored either.  The
// tensor maps are encoded on the host and kept by (pointer, shape).
//
// Rounding is the plain version's (kernels/ref.py moe_expert_mlp_ref):
// each product rounded to bf16, the activation computed in f32 on that
// bf16 value and rounded, the GLU product rounded; the two differ only in
// the order of the f32 sums of a product.

#include <mutex>

#include "hopper.cuh"  // TMA, mbarriers, wgmma

namespace {

using bf16 = __nv_bfloat16;

constexpr int kDepth = 64;         // k of a stage: one 128-byte swizzled row of bf16
constexpr int kPanel = 64;         // columns of a weight box: one 128-byte row
constexpr int kPanelBytes = kDepth * kPanel * 2;
constexpr int kWideRows = 128;     // two consumers of 64 rows
constexpr int kNarrowRows = 64;    // one consumer
constexpr int kWideUpCols = 128;   // columns of w_in, and of w_gate, a wide item
constexpr int kWideDownCols = 256; // columns of w_out a wide item
constexpr int kNarrowUpCols = 64;  // columns of w_in, and of w_gate, a narrow item
constexpr int kNarrowDownCols = 128;
constexpr int kNarrowMaxBound = 64;
constexpr int kRingBytes = 192 * 1024;
constexpr int kMaxStages = 12;
constexpr int kMaxExperts = 8192;  // experts the scan's shared memory holds
constexpr int kSmemLimit = 232448; // an H100 block's dynamic shared memory
constexpr int kMapCache = 512;     // tensor maps kept: three weights and two row maps a layer
constexpr int kProducerRegs = 24;  // 128 x 24 + 256 x 240 <= 65,536
constexpr int kConsumerRegs = 240;

enum Act { kSwiglu = 0, kGeglu = 1, kGelu = 2, kRelu2 = 3 };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// torch's tanh form of GELU (jax.nn.gelu's default), in f32
__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float inner = kBeta * (x + kKappa * (x * x * x));
  return 0.5f * x * (1.f + tanhf(inner));
}

// The activation of one element from its bf16-rounded products h and g
// (kNone: the down product, unchanged).
constexpr int kNone = -1;

template <int A>
__device__ __forceinline__ float activate(float h, float g) {
  if constexpr (A == kSwiglu) {
    return bf16_round(h * bf16_round(g / (1.f + expf(-g))));
  } else if constexpr (A == kGeglu) {
    return bf16_round(h * bf16_round(gelu_tanh(g)));
  } else if constexpr (A == kGelu) {
    return bf16_round(gelu_tanh(h));
  } else if constexpr (A == kRelu2) {
    const float r = fmaxf(h, 0.f);
    return bf16_round(r * r);
  } else {
    return h;
  }
}

// A block's geometry: Cons consumer warpgroups of 64 rows, Cols columns of
// each of Mats weights an item, and the ring that fits kRingBytes.  The
// Mats weight tiles of a stage sit side by side, so one wgmma of Mats Cols
// columns takes them all.
template <int Cons, int Cols, int Mats>
struct Geo {
  static constexpr int kRows = 64 * Cons;
  static constexpr int kThreads = 128 * (Cons + 1);
  static constexpr int kBoxes = Mats * Cols / kPanel;  // weight boxes a stage
  static constexpr int kA = kRows * kDepth * 2;
  static constexpr int kStage = kA + kBoxes * kPanelBytes;
  static constexpr int kStages =
      kRingBytes / kStage < kMaxStages ? kRingBytes / kStage : kMaxStages;
  static constexpr int kBar = kStages * kStage;       // full[], empty[]
  static constexpr int kWsum = kBar + 16 * kStages;   // the scan's warp sums
  static constexpr int kPrefix = kWsum + 4 * 16;      // int[E + 1]
  static constexpr size_t smem(int E) { return 1024 + kPrefix + 4 * (size_t)(E + 1); }
};

// What the kernels are told: the runs, the output, and the shapes.
struct Args {
  const int* offsets;
  bf16* out;      // h [R, f] or y [R, d]
  int E, n_groups;
  int K, N;       // depth and columns of the product: (d, f) up, (f, d) down
  int n_ct;       // column tiles
  int a_bytes;    // bytes of a stage's row box
  int act;
};

// A work item: its first row in x or h, its rows, its expert and its first column.
struct Item {
  int start, rows, e, n0;
};

// Expert e's first row in x or h (into `start`) and its rows: its runs of
// every group, one after another.
__device__ __forceinline__ int expert_rows(const Args& a, int e, int& start) {
  start = __ldg(a.offsets + e * a.n_groups);
  return max(0, __ldg(a.offsets + (e + 1) * a.n_groups) - start);
}

// The last i in [lo, hi) with prefix[i] <= x (prefix non-decreasing, prefix[lo] <= x).
__device__ __forceinline__ int last_at_or_before(const int* prefix, int lo, int hi, int x) {
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (prefix[mid] <= x) lo = mid; else hi = mid;
  }
  return lo;
}

// out[i + 1] = value(0) + ... + value(i) and out[0] = 0, by the whole block
// (Threads values a pass); returns the total.  Ends with a __syncthreads.
template <int Threads, typename F>
__device__ __forceinline__ int block_scan(int n, int* out, int* wsum, F value) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) out[0] = 0;
  int carry = 0;
  for (int i0 = 0; i0 < n; i0 += Threads) {
    const int i = i0 + t;
    int v = i < n ? value(i) : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    if (t == 0) {
      int s = 0;
      for (int w = 0; w < Threads / 32; ++w) {
        const int x = wsum[w];
        wsum[w] = s;
        s += x;
      }
      wsum[Threads / 32] = s;
    }
    __syncthreads();
    if (i < n) out[i + 1] = carry + wsum[warp] + v;
    carry += wsum[Threads / 32];
    __syncthreads();
  }
  return carry;
}

// Item j of the walk: row tile j / n_ct of the list, column tile j % n_ct.
// tiles[e] is expert e's first row tile.
template <int Rows, int Cols>
__device__ __forceinline__ Item item_at(const Args& a, const int* tiles, int j) {
  const int tile = j / a.n_ct, ct = j - tile * a.n_ct;
  Item w;
  w.e = last_at_or_before(tiles, 0, a.E, tile);
  w.n0 = ct * Cols;
  const int r0 = (tile - tiles[w.e]) * Rows;
  w.rows = min(Rows, expert_rows(a, w.e, w.start) - r0);
  w.start += r0;
  return w;
}

template <int N>
__device__ __forceinline__ void wgmma_tb(float (&acc)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 256) {
    wgmma_ss_tb_n256(acc, da, db, 1);
  } else if constexpr (N == 128) {
    wgmma_ss_tb_n128(acc, da, db, 1);
  } else {
    static_assert(N == 64, "wgmma widths 64, 128, 256");
    wgmma_ss_tb_n64(acc, da, db, 1);
  }
}

// The four lanes of a quad hold, for one row, the columns 2 c, 2 c + 1 (c =
// lane & 3) of four 8-column groups, a bf16 pair a word.  Two butterfly
// rounds (xor 1, then xor 2) give lane c all 8 columns of group c, 16
// bytes in column order: a store of a whole 64-byte row piece a quad.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&w)[4], int lane) {
  const bool p1 = lane & 1, p2 = lane & 2;
  const uint32_t r0 = __shfl_xor_sync(0xffffffffu, p1 ? w[0] : w[1], 1);
  const uint32_t r1 = __shfl_xor_sync(0xffffffffu, p1 ? w[2] : w[3], 1);
  // four columns of group (lane & 1) and of group 2 + (lane & 1), halves by lane & 2
  const uint32_t a0 = p1 ? r0 : w[0], a1 = p1 ? w[1] : r0;
  const uint32_t b0 = p1 ? r1 : w[2], b1 = p1 ? w[3] : r1;
  const uint32_t q0 = __shfl_xor_sync(0xffffffffu, p2 ? a0 : b0, 2);
  const uint32_t q1 = __shfl_xor_sync(0xffffffffu, p2 ? a1 : b1, 2);
  return p2 ? make_uint4(q0, q1, b0, b1) : make_uint4(a0, a1, q0, q1);
}

// A warpgroup's 64 rows of an item from its accumulator to `a.out`: rows
// of the item's expert only, columns below N only, 16 bytes a store.  A GLU's
// accumulator holds x w_in in its first Cols columns and x w_gate in the
// next Cols.
template <int A, int Cols, int Mats>
__device__ __forceinline__ void store_tile(const float (&acc)[Mats * Cols / 2], const Item& w,
                                           const Args& a, int wg, int wi, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = 64 * wg + 16 * wi + (lane >> 2) + 8 * half;
    bf16* row = a.out + (size_t)(w.start + r) * a.N + w.n0;
#pragma unroll
    for (int x0 = 0; x0 < Cols / 8; x0 += 4) {
      uint32_t word[4];  // columns 8 x + 2 (lane & 3), + 1 of groups x = x0 .. x0 + 3
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p0 = acc[4 * (x0 + i) + 2 * half + c];
          if constexpr (A == kNone) {
            v[c] = p0;
          } else {
            float g = 0.f;
            if constexpr (Mats == 2) g = bf16_round(acc[4 * (x0 + i + Cols / 8) + 2 * half + c]);
            v[c] = activate<A>(bf16_round(p0), g);
          }
        }
        word[i] = pack_bf16x2(v[0], v[1]);
      }
      const uint4 out = quad_transpose(word, lane);  // group x0 + (lane & 3)
      const int col = 8 * (x0 + (lane & 3));
      if (r < w.rows && w.n0 + col < a.N) *reinterpret_cast<uint4*>(row + col) = out;
    }
  }
}

// The grouped GEMM of one launch (see the note at the top).  Warpgroups
// 0 .. Cons-1 consume, warpgroup Cons produces.  Mats == 2 is a GLU: the
// accumulator's first Cols columns are x w_in, the next Cols x w_gate.  Up
// applies the activation in the epilogue.
template <int Cons, int Cols, int Mats, bool Up>
__device__ __forceinline__ void grouped_gemm(const CUtensorMap* tm_a, const CUtensorMap* tm_b0,
                                             const CUtensorMap* tm_b1, const Args& a) {
  using G = Geo<Cons, Cols, Mats>;
  constexpr int S = G::kStages;
  constexpr int kN = Mats * Cols;  // columns of the accumulator
  extern __shared__ __align__(1024) unsigned char moe_smem[];
  const uint32_t raw = smem_u32(moe_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = moe_smem + (base - raw);
  const uint32_t bar_full = base + G::kBar, bar_empty = bar_full + 8 * S;
  int* const wsum = reinterpret_cast<int*>(gbase + G::kWsum);
  int* const tiles = reinterpret_cast<int*>(gbase + G::kPrefix);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  if (t == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, Cons * 4);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the row tiles of each expert
  const int n_tiles = block_scan<G::kThreads>(a.E, tiles, wsum, [&](int e) {
    int start;
    return (expert_rows(a, e, start) + G::kRows - 1) / G::kRows;
  });
  const int n_items = n_tiles * a.n_ct;
  const int n_k = a.K / kDepth;

  if (warp >= 4 * Cons) {
    // ---- producer warpgroup: one thread issues every load ---------------------
    if constexpr (Cons == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (t == 128 * Cons) {
      const uint32_t tx = a.a_bytes + G::kBoxes * kPanelBytes;
      int it = 0;  // stages filled so far: the ring's slot and phase
      for (int j = blockIdx.x; j < n_items; j += gridDim.x) {
        const Item w = item_at<G::kRows, Cols>(a, tiles, j);
        const int krow = w.e * a.K;
        for (int kb = 0; kb < n_k; ++kb, ++it) {
          const int st = it % S;
          const uint32_t stage = base + st * G::kStage, full = bar_full + 8 * st;
          mbar_wait(bar_empty + 8 * st, ((it / S) & 1) ^ 1);
          mbar_expect_tx(full, tx);
          tma_load_2d(stage, tm_a, full, kb * kDepth, w.start);
#pragma unroll
          for (int b = 0; b < G::kBoxes; ++b)  // w_in's boxes, then w_gate's
            tma_load_2d(stage + G::kA + b * kPanelBytes, b < G::kBoxes / Mats ? tm_b0 : tm_b1,
                        full, w.n0 + (b % (Cols / kPanel)) * kPanel, krow + kb * kDepth);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of an item -----
    if constexpr (Cons == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = warp >> 2, wi = warp & 3;
    // a stage slot read by this warp's products: one arrival
    auto release = [&](int slot) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * slot);
    };
    float acc[kN / 2];
    int it = 0;  // stages consumed so far
    for (int j = blockIdx.x; j < n_items; j += gridDim.x) {
      const Item w = item_at<G::kRows, Cols>(a, tiles, j);
#pragma unroll
      for (int x = 0; x < kN / 2; ++x) acc[x] = 0.f;
      // a warpgroup whose rows all lie past the expert's (a ragged last
      // tile) only passes the stages on
      const bool busy = 64 * wg < w.rows;
      for (int kb = 0; kb < n_k; ++kb, ++it) {
        const int st = it % S;
        const uint32_t stage = base + st * G::kStage;
        mbar_wait(bar_full + 8 * st, (it / S) & 1);
        fence_regs(acc);
        wgmma_fence();
        if (busy) {
#pragma unroll
          for (int kk = 0; kk < kDepth / 16; ++kk)
            wgmma_tb<kN>(acc, sw128_desc(stage + wg * 64 * 128 + kk * 32, 0),
                         sw128_desc(stage + G::kA + kk * 16 * 128, kPanelBytes));
        }
        wgmma_commit();
        if (kb > 0) {  // the last stage's products are done: it may take a new tile
          wgmma_wait<1>();
          release((it - 1) % S);
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release((it - 1) % S);

      // epilogue, its activation chosen once an item
      if constexpr (!Up) {
        store_tile<kNone, Cols, Mats>(acc, w, a, wg, wi, lane);
      } else if constexpr (Mats == 2) {
        if (a.act == kSwiglu) store_tile<kSwiglu, Cols, Mats>(acc, w, a, wg, wi, lane);
        else store_tile<kGeglu, Cols, Mats>(acc, w, a, wg, wi, lane);
      } else {
        if (a.act == kGelu) store_tile<kGelu, Cols, Mats>(acc, w, a, wg, wi, lane);
        else store_tile<kRelu2, Cols, Mats>(acc, w, a, wg, wi, lane);
      }
    }
  }
}

template <int Cons, int Cols, int Mats>
__global__ void __launch_bounds__(Geo<Cons, Cols, Mats>::kThreads, 1)
    moe_up_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_in,
                  const __grid_constant__ CUtensorMap tm_gate, const Args a) {
  grouped_gemm<Cons, Cols, Mats, true>(&tm_x, &tm_in, &tm_gate, a);
}

template <int Cons, int Cols>
__global__ void __launch_bounds__(Geo<Cons, Cols, 1>::kThreads, 1)
    moe_down_kernel(const __grid_constant__ CUtensorMap tm_h,
                    const __grid_constant__ CUtensorMap tm_out, const Args a) {
  grouped_gemm<Cons, Cols, 1, false>(&tm_h, &tm_out, &tm_out, a);
}

int sm_count() {
  static int counts[32] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  int& n = counts[dev & 31];
  if (n == 0 && cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    n = 0;
  return n;
}

// A 2-D bf16 map over `outer` rows of `inner` elements, a box of 64 x
// `box_rows`: the rows (x or h [R, K]) or a weight ([E K, N] viewed 2-D; K
// is a multiple of 64, so no box crosses experts).  A map depends on these
// alone, so maps are kept by them: a layer's weights, and the rows of a
// decode step, which the allocator hands out at the same addresses, keep
// theirs from call to call.
cudaError_t map_2d(CUtensorMap* map, const void* ptr, int inner, long long outer, int box_rows) {
  struct Entry {
    const void* ptr;
    int inner;
    long long outer;
    int box_rows;
    CUtensorMap map;
  };
  static std::mutex mu;
  static Entry cache[kMapCache];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& c = cache[i];
    if (c.ptr == ptr && c.inner == inner && c.outer == outer && c.box_rows == box_rows) {
      *map = c.map;
      return cudaSuccess;
    }
  }
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kDepth, (cuuint32_t)box_rows};
  const cudaError_t err = make_map<2>(map, ptr, dims, strides, box);
  if (err != cudaSuccess) return err;
  cache[next] = Entry{ptr, inner, outer, box_rows, *map};  // the oldest goes once it is full
  next = (next + 1) % kMapCache;
  used = used < kMapCache ? used + 1 : used;
  return cudaSuccess;
}

// Launches one geometry: a CTA an SM, or fewer where the static bound gives
// fewer items.
template <int Cons, int Cols, int Mats, auto Kernel, typename... Maps>
int launch(Args a, int rows_bound, cudaStream_t stream, const Maps&... maps) {
  using G = Geo<Cons, Cols, Mats>;
  a.n_ct = (a.N + Cols - 1) / Cols;
  const long long rows = (long long)a.n_groups * rows_bound;  // an expert's, at most
  const long long most = a.E * ((rows + G::kRows - 1) / G::kRows) * a.n_ct;  // >= 1
  const int n_sm = sm_count();
  if (n_sm <= 0) return static_cast<int>(cudaErrorNoDevice);
  const cudaError_t err = smem_limit_once<Kernel>(kSmemLimit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = most < n_sm ? static_cast<int>(most) : n_sm;
  Kernel<<<grid, G::kThreads, G::smem(a.E), stream>>>(maps..., a);
  return static_cast<int>(cudaGetLastError());
}

// The row box: all 128 rows of a wide tile; for a narrow one the most rows
// an expert can hold (every group's bound), at most 64, rounded up to 8.
int box_rows(int rows_bound, int n_groups) {
  if (rows_bound > kNarrowMaxBound) return kWideRows;
  const long long rows = (long long)n_groups * rows_bound;
  return rows >= kNarrowRows ? kNarrowRows : (static_cast<int>(rows) + 7) / 8 * 8;
}

}  // namespace

// Both launches of a call: h = act(x w_gate) * (x w_in) (or act(x w_in)),
// then y = h w_out, on `stream`; `*launched` counts the kernels launched
// (0, 1 or 2).  Returns 0 or the CUDA error of the step that failed.
extern "C" int moe_mlp(const void* x, const void* offsets, const void* w_in, const void* w_gate,
                       const void* w_out, void* h, void* y, int R, int d, int f, int E,
                       int n_groups, int rows_bound, int act, void* stream, int* launched) {
  *launched = 0;
  const bool glu = act == kSwiglu || act == kGeglu;
  if (R <= 0 || d <= 0 || f <= 0 || d % kDepth || f % kDepth || E <= 0 || E > kMaxExperts ||
      n_groups <= 0 || rows_bound < 0 || act < kSwiglu || act > kRelu2 ||
      glu != (w_gate != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows_bound == 0) return 0;
  const int rows = box_rows(rows_bound, n_groups);
  CUtensorMap tx, ti, tg, th, to;
  cudaError_t err;
  if ((err = map_2d(&tx, x, d, R, rows)) != cudaSuccess ||
      (err = map_2d(&ti, w_in, f, (long long)E * d, kDepth)) != cudaSuccess ||
      (err = map_2d(&tg, glu ? w_gate : w_in, f, (long long)E * d, kDepth)) != cudaSuccess ||
      (err = map_2d(&th, h, f, R, rows)) != cudaSuccess ||
      (err = map_2d(&to, w_out, d, (long long)E * f, kDepth)) != cudaSuccess)
    return static_cast<int>(err);
  const auto* off = static_cast<const int*>(offsets);
  const Args up{off, static_cast<bf16*>(h), E, n_groups, d, f, 0, rows * kDepth * 2, act};
  const Args down{off, static_cast<bf16*>(y), E, n_groups, f, d, 0, rows * kDepth * 2, 0};
  auto s = static_cast<cudaStream_t>(stream);
  constexpr int W = kWideUpCols, M = kNarrowUpCols, WD = kWideDownCols, MD = kNarrowDownCols;
  const bool wide = rows_bound > kNarrowMaxBound;
  int rc;
  if (wide) {
    rc = glu ? launch<2, W, 2, moe_up_kernel<2, W, 2>>(up, rows_bound, s, tx, ti, tg)
             : launch<2, W, 1, moe_up_kernel<2, W, 1>>(up, rows_bound, s, tx, ti, tg);
  } else {
    rc = glu ? launch<1, M, 2, moe_up_kernel<1, M, 2>>(up, rows_bound, s, tx, ti, tg)
             : launch<1, M, 1, moe_up_kernel<1, M, 1>>(up, rows_bound, s, tx, ti, tg);
  }
  if (rc != 0) return rc;
  *launched = 1;
  rc = wide ? launch<2, WD, 1, moe_down_kernel<2, WD>>(down, rows_bound, s, th, to)
            : launch<1, MD, 1, moe_down_kernel<1, MD>>(down, rows_bound, s, th, to);
  if (rc == 0) *launched = 2;
  return rc;
}

// The geometry the wrapper checks its own copy against: wide and narrow
// rows, wide up and down columns, narrow up and down columns, depth, the
// largest narrow bound, the most experts.
extern "C" void moe_geometry(int* out) {
  const int g[9] = {kWideRows, kNarrowRows, kWideUpCols, kWideDownCols, kNarrowUpCols,
                    kNarrowDownCols, kDepth, kNarrowMaxBound, kMaxExperts};
  for (int i = 0; i < 9; ++i) out[i] = g[i];
}

extern "C" const char* moe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
