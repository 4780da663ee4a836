// Row 12 of the kernel table: the MoE FFN's routed experts
// (repro/models/ffn.py `moe_ffn`, its jnp `_expert_mlp`, not a Pallas
// site), over rows laid out compactly by (group, expert, position).
//
// The JAX function runs its expert MLP as einsums over a capacity-padded
// [n_groups, E, C, d] buffer, which reads every expert's weights whatever
// the routing.  Here the kept (token, choice) pairs of each (group, expert)
// are one run of rows in x [R, d], from offsets[g*E + e] to
// offsets[g*E + e + 1] (int32 on the device, at most `rows_bound` rows a
// run), and two launches compute
//
//   moe_up:   h = act(x @ w_gate[e]) * (x @ w_in[e])   [R, f]  (GLU), or act(x @ w_in[e])
//   moe_down: y = h @ w_out[e]                         [R, d]
//
// A block takes one (group, expert) row tile of 64 rows and one column
// tile; the grid is sized from the static bound, and a block whose tile
// lies past its run's end returns before it loads anything.  So an expert
// that no token picked costs one empty block a tile, and no size is read
// back to the host.  Blocks of one expert are adjacent in the launch order,
// so its weights are read from device memory about once while its row
// tiles take them from L2.
//
// Bound: at decode (a few rows an expert) the touched experts' weights,
// 3 d f bf16 each: bytes; at prefill (hundreds of rows an expert) the
// products, 6 R d f FLOPs.  This first version streams 32-deep stages of
// the row tile and the weight tile through a three-stage cp.async ring and
// multiplies with mma.sync m16n8k16 (bf16, f32 sums); wgmma and TMA are a
// later redesign.  Other geometries (128-row tiles, 64-deep stages, four
// stages) moved its time at deepseek-moe-16b's prefill by at most 11 % on
// an H100: the tile is not what holds it.
//
// Rounding is the plain version's (kernels/ref.py moe_expert_mlp_ref):
// each product rounded to bf16, the activation computed in f32 on that
// bf16 value and rounded, the GLU product rounded; the two differ only in
// the order of the f32 sums of a product.

#include "hopper.cuh"  // mma_bf16, smem_u32

namespace {

using bf16 = __nv_bfloat16;

// The geometry the wrapper launches: 64-row tiles, 32-deep stages in a
// three-stage ring, 4 warps (2 x 2 over the tile, 32 rows each).
constexpr int kRows = 64;
constexpr int kDepth = 32;
constexpr int kStages = 3;
constexpr int kPad = 8;         // bf16 a shared row: conflict-free ldmatrix
constexpr int kUpCols = 64;     // columns of moe_up's tile, of w_in and of w_gate each
constexpr int kDownCols = 128;  // columns of moe_down's tile

enum Act { kSwiglu = 0, kGeglu = 1, kGelu = 2, kRelu2 = 3 };

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

// The activation of one element from its bf16-rounded products h and g.
__device__ __forceinline__ float activate(int act, float h, float g) {
  switch (act) {
    case kSwiglu:
      return bf16_round(h * bf16_round(g / (1.f + expf(-g))));
    case kGeglu:
      return bf16_round(h * bf16_round(gelu_tanh(g)));
    case kGelu:
      return bf16_round(gelu_tanh(h));
    default: {  // kRelu2
      const float r = fmaxf(h, 0.f);
      return bf16_round(r * r);
    }
  }
}

// This block's run: its first row in x, its rows (1..64) and its expert;
// false where its row tile lies past the run's end (or past the grid's
// work), before anything is loaded.
struct Work {
  int start, rows, e;
};

template <int Rows>
__device__ __forceinline__ bool block_work(const int* __restrict__ offsets, int E, int n_groups,
                                           int n_tiles, Work& w) {
  const long long L = blockIdx.y + (long long)gridDim.y * blockIdx.z;
  const long long per_expert = (long long)n_groups * n_tiles;
  if (L >= (long long)E * per_expert) return false;
  const int e = static_cast<int>(L / per_expert);
  const int rem = static_cast<int>(L % per_expert);
  const int g = rem / n_tiles, r0 = (rem % n_tiles) * Rows;
  const int a = offsets[g * E + e], count = offsets[g * E + e + 1] - a;
  if (r0 >= count) return false;
  w.start = a + r0;
  w.rows = min(Rows, count - r0);
  w.e = e;
  return true;
}

// The shared memory of a block: Stages stages, each the A tile [Rows][Depth]
// and NMat B tiles [Depth][NCols], rows padded by kPad.
template <int Rows, int Depth, int Stages, int NCols, int NMat>
constexpr size_t smem_bytes() {
  return (size_t)Stages * (Rows * (Depth + kPad) + NMat * Depth * (NCols + kPad)) * sizeof(bf16);
}

// acc[m] (+)= A[rows x K] . B_m[K x N][:, col0 : col0 + NCols] for the
// Rows-row tile; A rows past `rows` read as zero.  Rows / 32 x 2 warps, each
// holding 32 rows and NCols / 2 columns of each of the NMat products.
template <int Rows, int Depth, int Stages, int NCols, int NMat>
__device__ __forceinline__ void gemm_tile(const bf16* __restrict__ A, int K, int rows,
                                          const bf16* __restrict__ B0,
                                          const bf16* __restrict__ B1, int N, int col0,
                                          bf16* smem, float (&acc)[NMat][2][NCols / 16][4]) {
  constexpr int kThreads = Rows * 2;
  constexpr int kLdA = Depth + kPad;
  constexpr int kLdB = NCols + kPad;
  constexpr int kStageA = Rows * kLdA;
  constexpr int kStage = kStageA + NMat * Depth * kLdB;
  constexpr int kN8 = NCols / 16;  // 8-column tiles of a warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;

#pragma unroll
  for (int m = 0; m < NMat; ++m)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < kN8; ++nj)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][mi][nj][c] = 0.f;

  const int n_steps = K / Depth;
  auto load_stage = [&](int stage, int step) {
    bf16* As = smem + stage * kStage;
    bf16* Bs = As + kStageA;
    const int k0 = step * Depth;
#pragma unroll
    for (int c = tid; c < Rows * Depth / 8; c += kThreads) {
      const int r = c / (Depth / 8), part = c % (Depth / 8);
      const bool ok = r < rows;
      cp_async16(As + r * kLdA + part * 8, A + (size_t)(ok ? r : 0) * K + k0 + part * 8,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int m = 0; m < NMat; ++m) {
      const bf16* W = m == 0 ? B0 : B1;
#pragma unroll
      for (int c = tid; c < Depth * NCols / 8; c += kThreads) {
        const int r = c / (NCols / 8), part = c % (NCols / 8);
        cp_async16(Bs + (m * Depth + r) * kLdB + part * 8,
                   W + (size_t)(k0 + r) * N + col0 + part * 8, 16);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < Stages - 1; ++s) {
    if (s < n_steps) load_stage(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<Stages - 2>();  // this step's stage has landed
    __syncthreads();              // ... for every thread; the last step's stage is free
    const int next = step + Stages - 1;
    if (next < n_steps) load_stage(next % Stages, next);
    cp_async_commit();
    const bf16* As = smem + (step % Stages) * kStage;
    const bf16* Bs = As + kStageA;
#pragma unroll
    for (int kk = 0; kk < Depth / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], As + (wm * 32 + mi * 16 + (lane & 15)) * kLdA + kk * 16 +
                               (lane >> 4) * 8);
      // ldmatrix.trans of the [k][n] tile: matrices (k 0-7, n), (k 8-15, n),
      // (k 0-7, n + 8), (k 8-15, n + 8): b0, b1 of two 8-column tiles
      const int krow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int m = 0; m < NMat; ++m)
#pragma unroll
        for (int nj = 0; nj < kN8; nj += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, Bs + (m * Depth + krow) * kLdB + wn * (NCols / 2) + nj * 8 +
                                   (lane >> 4) * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16(acc[m][mi][nj], a[mi], b[0], b[1]);
            mma_bf16(acc[m][mi][nj + 1], a[mi], b[2], b[3]);
          }
        }
    }
  }
  cp_async_wait<0>();
}

template <int Rows, int Depth, int Stages, int NMat>
__global__ void __launch_bounds__(Rows * 2)
    moe_up_kernel(const bf16* __restrict__ x, const int* __restrict__ offsets,
                  const bf16* __restrict__ w_in, const bf16* __restrict__ w_gate,
                  bf16* __restrict__ h, int d, int f, int E, int n_groups, int n_tiles, int act) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Work w;
  if (!block_work<Rows>(offsets, E, n_groups, n_tiles, w)) return;
  const int col0 = blockIdx.x * kUpCols;
  const size_t wofs = (size_t)w.e * d * f;
  float acc[NMat][2][kUpCols / 16][4];
  gemm_tile<Rows, Depth, Stages, kUpCols, NMat>(
      x + (size_t)w.start * d, d, w.rows, w_in + wofs, NMat == 2 ? w_gate + wofs : nullptr, f,
      col0, reinterpret_cast<bf16*>(smem_raw), acc);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 32 + mi * 16 + (lane >> 2) + half * 8;
      if (r >= w.rows) continue;
      bf16* dst = h + (size_t)(w.start + r) * f + col0 + wn * (kUpCols / 2) + (lane & 3) * 2;
#pragma unroll
      for (int nj = 0; nj < kUpCols / 16; ++nj) {
        float v[2];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const float hv = bf16_round(acc[0][mi][nj][2 * half + t]);
          const float gv = NMat == 2 ? bf16_round(acc[NMat - 1][mi][nj][2 * half + t]) : 0.f;
          v[t] = activate(act, hv, gv);
        }
        *reinterpret_cast<__nv_bfloat162*>(dst + nj * 8) = __floats2bfloat162_rn(v[0], v[1]);
      }
    }
}

template <int Rows, int Depth, int Stages>
__global__ void __launch_bounds__(Rows * 2)
    moe_down_kernel(const bf16* __restrict__ h, const int* __restrict__ offsets,
                    const bf16* __restrict__ w_out, bf16* __restrict__ y, int f, int d, int E,
                    int n_groups, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Work w;
  if (!block_work<Rows>(offsets, E, n_groups, n_tiles, w)) return;
  const int col0 = blockIdx.x * kDownCols;
  float acc[1][2][kDownCols / 16][4];
  gemm_tile<Rows, Depth, Stages, kDownCols, 1>(h + (size_t)w.start * f, f, w.rows,
                                               w_out + (size_t)w.e * f * d, nullptr, d, col0,
                                               reinterpret_cast<bf16*>(smem_raw), acc);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 32 + mi * 16 + (lane >> 2) + half * 8;
      if (r >= w.rows) continue;
      bf16* dst = y + (size_t)(w.start + r) * d + col0 + wn * (kDownCols / 2) + (lane & 3) * 2;
#pragma unroll
      for (int nj = 0; nj < kDownCols / 16; ++nj)
        *reinterpret_cast<__nv_bfloat162*>(dst + nj * 8) =
            __floats2bfloat162_rn(acc[0][mi][nj][2 * half], acc[0][mi][nj][2 * half + 1]);
    }
}

// The grid over (column tile) x (expert, group, row tile), the latter cut
// into y and z below the 65,535 limit; false when there is no work.
bool moe_grid(int cols, int rows_per_tile, int E, int n_groups, int rows_bound, int& n_tiles,
              dim3& grid) {
  n_tiles = (rows_bound + rows_per_tile - 1) / rows_per_tile;
  const long long total = (long long)E * n_groups * n_tiles;
  if (total <= 0 || cols <= 0) return false;
  const long long y = total < 65535 ? total : 65535;
  grid = dim3(cols, static_cast<unsigned>(y), static_cast<unsigned>((total + y - 1) / y));
  return true;
}

template <int Rows, int Depth, int Stages>
int launch_up(const void* x, const void* offsets, const void* w_in, const void* w_gate, void* h,
              int d, int f, int E, int n_groups, int rows_bound, int act, void* stream) {
  const bool glu = act == kSwiglu || act == kGeglu;
  if (d <= 0 || f <= 0 || d % Depth || f % kUpCols || act < kSwiglu || act > kRelu2 ||
      glu != (w_gate != nullptr) || rows_bound < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int n_tiles = 0;
  dim3 grid;
  if (!moe_grid(f / kUpCols, Rows, E, n_groups, rows_bound, n_tiles, grid)) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* off = static_cast<const int*>(offsets);
  const auto* wi = static_cast<const bf16*>(w_in);
  if (glu) {
    constexpr size_t smem = smem_bytes<Rows, Depth, Stages, kUpCols, 2>();
    const cudaError_t err = smem_limit_once<moe_up_kernel<Rows, Depth, Stages, 2>>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    moe_up_kernel<Rows, Depth, Stages, 2><<<grid, Rows * 2, smem, s>>>(
        xb, off, wi, static_cast<const bf16*>(w_gate), static_cast<bf16*>(h), d, f, E,
        n_groups, n_tiles, act);
  } else {
    constexpr size_t smem = smem_bytes<Rows, Depth, Stages, kUpCols, 1>();
    const cudaError_t err = smem_limit_once<moe_up_kernel<Rows, Depth, Stages, 1>>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    moe_up_kernel<Rows, Depth, Stages, 1><<<grid, Rows * 2, smem, s>>>(
        xb, off, wi, nullptr, static_cast<bf16*>(h), d, f, E, n_groups, n_tiles, act);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int Rows, int Depth, int Stages>
int launch_down(const void* h, const void* offsets, const void* w_out, void* y, int f, int d,
                int E, int n_groups, int rows_bound, void* stream) {
  if (d <= 0 || f <= 0 || f % Depth || d % kDownCols || rows_bound < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int n_tiles = 0;
  dim3 grid;
  if (!moe_grid(d / kDownCols, Rows, E, n_groups, rows_bound, n_tiles, grid)) return 0;
  constexpr size_t smem = smem_bytes<Rows, Depth, Stages, kDownCols, 1>();
  const cudaError_t err = smem_limit_once<moe_down_kernel<Rows, Depth, Stages>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_down_kernel<Rows, Depth, Stages><<<grid, Rows * 2, smem,
                                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const int*>(offsets),
      static_cast<const bf16*>(w_out), static_cast<bf16*>(y), f, d, E, n_groups, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int moe_up(const void* x, const void* offsets, const void* w_in, const void* w_gate,
                      void* h, int d, int f, int E, int n_groups, int rows_bound, int act,
                      void* stream) {
  return launch_up<kRows, kDepth, kStages>(x, offsets, w_in, w_gate, h, d, f, E, n_groups,
                                           rows_bound, act, stream);
}

extern "C" int moe_down(const void* h, const void* offsets, const void* w_out, void* y, int f,
                        int d, int E, int n_groups, int rows_bound, void* stream) {
  return launch_down<kRows, kDepth, kStages>(h, offsets, w_out, y, f, d, E, n_groups,
                                             rows_bound, stream);
}

extern "C" void moe_geometry(int* rows, int* up_cols, int* down_cols, int* depth) {
  *rows = kRows;
  *up_cols = kUpCols;
  *down_cols = kDownCols;
  *depth = kDepth;
}

extern "C" const char* moe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
