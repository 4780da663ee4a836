// Distance-rank count (the exact RkNN oracle) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel _rank_kernel of
// src/repro/kernels/rank_count.py (rank_count_kernel_call), and gives it a
// query axis, which serves ops.rank_count_batch (the JAX package computes
// that one with plain jnp ops, repro/kernels/ops.py rank_count_batch):
//
//   out[q, u] = #{ f < M, f != excl[q] : d(u, f) < thr[q, u] },
//   d(u, p)   = ((x_u - p_x) * (x_u - p_x)) + ((y_u - p_y) * (y_u - p_y)),
//   thr[q, u] = d(u, q_pts[q])   (computed here, in the same order).
//
// count < k <=> u is in RkNN(q), which makes this the on-card oracle the
// ray-cast count is held against.
//
// Design.  The users arrive in a spatial (Morton) order
// (repro_torch/kernels/user_order.py).  One warp owns a sub-tile of
// kSubTile = 256 consecutive users of that order, 8 a lane in registers;
// a block of 4 warps owns one (tile of 1,024 users, query, facility
// split).  Each warp computes its users' thresholds, their least and
// greatest value tmin, tmax and the bounding box of its users (warp
// reductions, so the box needs no input), then walks its split's
// facilities 32 at a time, one a lane, and sorts each into one of three
// classes on that box (below): SKIP facilities are closer to no user, FULL
// ones are closer to every user and add 1 to the whole sub-tile with no
// test, TEST ones are compacted into the warp's list in shared memory
// (ballot and a prefix count).  Each user is then tested only against that
// list, each list entry read once from shared memory for all 8 users of a
// lane.  The excluded facility is skipped by its index, as a facility at
// +inf (the plain version's way) would be.  Nothing is shared between
// warps: the kernel has no block barrier.  Each count is stored through the
// permutation straight to the user's own place (on the H100 this beat a
// store in tile order and a gather back, PERF.md).
//
// Facility splits.  A sub-tile whose users straddle a jump of the Morton
// curve has a box across much of the map, and then most facilities are
// TEST for it: one such warp tests 256 users against all M facilities and
// holds the whole launch when there are few queries.  With few (tile,
// query) blocks the wrapper therefore cuts the facilities into
// n_splits = ceil(M / per_split) runs on the grid's z axis; each split
// adds its count with an integer atomicAdd (into counts the wrapper
// zeroed), so no order of blocks changes a count.  With one split the
// count is stored.
//
// Why the classes are exact (no margin).  Rounding to nearest is
// monotone.  For a facility f and the box's x range, let a = fl(x_lo - f_x)
// and b = fl(x_hi - f_x) (so a <= b).  For every user x in [x_lo, x_hi],
// fl(x - f_x) lies in [a, b], so
//   n_x = max(a, -b, 0) <= |fl(x - f_x)| <= max(|a|, |b|) = w_x
// (n_x is a when f_x is left of the box, -b when right of it, 0 inside),
// and fl(v * v) is non-decreasing in |v|, fl(p + r) in each of p, r.
// With n_y, w_y likewise, in float32 with the kernel's order,
//   gmin = fl(fl(n_x * n_x) + fl(n_y * n_y)),  gmax = fl(fl(w_x * w_x) + fl(w_y * w_y))
// satisfy gmin <= d(u, f) <= gmax for every user u of the box.  With
// tmin <= thr[u] <= tmax over the sub-tile's real users:
//   SKIP iff gmin >= tmax: d(u, f) >= gmin >= tmax >= thr[u], never closer;
//   FULL iff gmax < tmin:  d(u, f) <= gmax < tmin <= thr[u], always closer;
//   TEST otherwise.
// Both rules compare float32 values that bound the very values a user's
// test compares, so no tie rule and no margin is needed, and the counts
// are those of testing every facility, bit for bit.  Non-finite values:
// a NaN threshold (a NaN user or query coordinate) makes the sub-tile's
// tmin and tmax NaN, so all its pairs are TEST; the box leaves NaN users
// out (fminf / fmaxf).  The maxima ignore a NaN (fmaxf).  a or b is NaN only
// when the facility is NaN (then every user's d is NaN, never closer, and
// w is NaN: never FULL) or when the facility and a box edge are the same
// infinity; then every user's d is +inf or NaN (never closer, so SKIP is
// right) and the other edge gives an infinite or NaN w (never FULL).  A
// facility at +inf on a finite box has gmin = +inf >= tmax: SKIP.  The
// plain twin of this classifier is repro_torch/kernels/ref.py
// rank_tile_classes_ref (same order, same NaN rules).
//
// Bound.  The bytes: 8 per user in, 8 per facility in, 4 per (query,
// user) out.  The classes leave a few per cent of the (user, facility)
// tests (5 operations each, none fused) to do, so the tests no longer
// bound the work; the classification (about 20 issue slots per (sub-tile,
// facility)) and the TEST pairs' tests take the time (PERF.md).
//
// Rounding contract.  Every difference, product and sum is written with
// __fsub_rn / __fmul_rn / __fadd_rn as (dx * dx) + (dy * dy), so nvcc cannot
// contract them into FMAs; the plain PyTorch version (ops.rank_count, ref.py)
// evaluates the same order with one rounding per operation.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kUsersPerLane = 8;
constexpr int kSubTile = 32 * kUsersPerLane;     // users a warp classifies for
constexpr int kTileUsers = kWarps * kSubTile;    // users a block
constexpr int kListCap = 256;                    // TEST facilities a warp holds
constexpr int kSkip = 0, kFull = 1, kTest = 2;   // ref.py TILE_SKIP / FULL / TEST

__device__ __forceinline__ float dist2(float x, float y, float px, float py) {
  const float dx = __fsub_rn(x, px), dy = __fsub_rn(y, py);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// The class of facility (fx, fy) on the box [x_lo, x_hi] x [y_lo, y_hi]
// whose users' thresholds lie in [tmin, tmax] (derivation at the top).
__device__ __forceinline__ int classify(float fx, float fy, float x_lo, float y_lo,
                                        float x_hi, float y_hi, float tmin, float tmax) {
  const float ax = __fsub_rn(x_lo, fx), bx = __fsub_rn(x_hi, fx);
  const float ay = __fsub_rn(y_lo, fy), by = __fsub_rn(y_hi, fy);
  const float nx = fmaxf(fmaxf(ax, -bx), 0.0f), ny = fmaxf(fmaxf(ay, -by), 0.0f);
  const float wx = fmaxf(fabsf(ax), fabsf(bx)), wy = fmaxf(fabsf(ay), fabsf(by));
  const float gmin = __fadd_rn(__fmul_rn(nx, nx), __fmul_rn(ny, ny));
  const float gmax = __fadd_rn(__fmul_rn(wx, wx), __fmul_rn(wy, wy));
  return gmin >= tmax ? kSkip : (gmax < tmin ? kFull : kTest);
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads)
rank_tiles_kernel(const float* __restrict__ xs_s,     // [N] users in tile order
                  const float* __restrict__ ys_s,
                  const int32_t* __restrict__ perm,   // [N] tile position -> user
                  const float2* __restrict__ fxy,     // [M] facilities
                  const float2* __restrict__ q_pts,   // [Q] query points
                  const int32_t* __restrict__ excl,   // [Q] excluded row, < 0 for none
                  int32_t* __restrict__ out,          // [Q, N] in the users' order
                  int64_t n, int m, int per_split) {
  __shared__ float2 lists[kWarps][kListCap];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kTileUsers +
                        static_cast<int64_t>(warp) * kSubTile;
  if (first >= n) return;  // the whole warp: past the ragged end
  const int64_t q = blockIdx.y;
  const int f_begin = blockIdx.z * per_split;
  const int f_end = min(m, f_begin + per_split);
  const float2 qp = q_pts[q];
  const int ex = excl[q];
  float2* list = lists[warp];

  float x[kUsersPerLane], y[kUsersPerLane], t[kUsersPerLane];
  int count[kUsersPerLane];
  float x_lo = INFINITY, y_lo = INFINITY, x_hi = -INFINITY, y_hi = -INFINITY;
  float tmin = INFINITY, tmax = -INFINITY;
  bool nan_thr = false;
#pragma unroll
  for (int j = 0; j < kUsersPerLane; ++j) {
    const int64_t u = first + j * 32 + lane;
    const bool live = u < n;
    x[j] = live ? xs_s[u] : 0.0f;
    y[j] = live ? ys_s[u] : 0.0f;
    t[j] = dist2(x[j], y[j], qp.x, qp.y);
    count[j] = 0;
    if (live) {
      x_lo = fminf(x_lo, x[j]);
      x_hi = fmaxf(x_hi, x[j]);
      y_lo = fminf(y_lo, y[j]);
      y_hi = fmaxf(y_hi, y[j]);
      tmin = fminf(tmin, t[j]);
      tmax = fmaxf(tmax, t[j]);
      nan_thr |= t[j] != t[j];
    }
  }
  x_lo = warp_min(x_lo);
  y_lo = warp_min(y_lo);
  x_hi = warp_max(x_hi);
  y_hi = warp_max(y_hi);
  tmin = warp_min(tmin);
  tmax = warp_max(tmax);
  if (__any_sync(0xffffffffu, nan_thr)) tmin = tmax = NAN;

  const unsigned below = (1u << lane) - 1u;
  int full = 0;  // FULL facilities among those this lane classified
  int len = 0;   // the list's length, the same in every lane
  for (int f0 = f_begin; f0 < f_end; f0 += 32) {
    const int f = f0 + lane;
    float2 p = make_float2(0.0f, 0.0f);
    int cls = kSkip;
    if (f < f_end && f != ex) {
      p = fxy[f];
      cls = classify(p.x, p.y, x_lo, y_lo, x_hi, y_hi, tmin, tmax);
    }
    full += cls == kFull;
    const unsigned test = __ballot_sync(0xffffffffu, cls == kTest);
    if (cls == kTest) list[len + __popc(test & below)] = p;
    len += __popc(test);
    if (len > kListCap - 32 || f0 + 32 >= f_end) {  // full, or the last chunk
      __syncwarp();  // the list is written
      for (int s = 0; s < len; ++s) {
        const float2 e = list[s];
#pragma unroll
        for (int j = 0; j < kUsersPerLane; ++j) count[j] += dist2(x[j], y[j], e.x, e.y) < t[j];
      }
      __syncwarp();  // the list is read: the next chunk may overwrite it
      len = 0;
    }
  }

  // every user of the sub-tile is closer to every FULL facility
  full = __reduce_add_sync(0xffffffffu, full);
  int32_t* oq = out + q * n;
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int j = 0; j < kUsersPerLane; ++j) {
    const int64_t u = first + j * 32 + lane;
    if (u < n) {
      int32_t* dst = oq + perm[u];
      if (split) {
        atomicAdd(dst, count[j] + full);
      } else {
        *dst = count[j] + full;
      }
    }
  }
}

}  // namespace

// out[q, perm[i]] for q < n_queries and the users i < n_users in tile
// order (xs_s, ys_s; perm maps tile order to the users' order).  fxy is
// [n_facilities] float2, q_pts [n_queries] float2, excl [n_queries] int32
// (a row to leave out, or < 0).  The facilities are cut into runs of
// per_split (a positive multiple of 32), one run per grid z; with more
// than one run, out must hold zeros and receives atomic adds.  The caller
// never passes an empty grid (n_users or n_queries of 0).  Launches on
// `stream`, allocates nothing, does not synchronize, and returns
// cudaGetLastError() (0 = cudaSuccess).
extern "C" int rank_count_tiles(const void* xs_s, const void* ys_s, const void* perm,
                                const void* fxy, const void* q_pts, const void* excl, void* out,
                                long long n_users, int n_facilities, int n_queries,
                                int per_split, void* stream) {
  if (per_split <= 0 || per_split % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int splits = n_facilities > 0 ? (n_facilities + per_split - 1) / per_split : 1;
  const dim3 grid(static_cast<unsigned>((n_users + kTileUsers - 1) / kTileUsers),
                  static_cast<unsigned>(n_queries), static_cast<unsigned>(splits));
  rank_tiles_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xs_s), static_cast<const float*>(ys_s),
      static_cast<const int32_t*>(perm), static_cast<const float2*>(fxy),
      static_cast<const float2*>(q_pts), static_cast<const int32_t*>(excl),
      static_cast<int32_t*>(out), static_cast<int64_t>(n_users), n_facilities, per_split);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rank_count_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
