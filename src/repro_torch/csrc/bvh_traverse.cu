// BVH walk with early exit at k (the paper's Algorithm 1/2), for Hopper,
// sm_90a: one walk per warp for a span of users, the stack in the warp's
// registers.
//
// Replaces the JAX package's traversal, src/repro/core/bvh.py
// bvh_hit_counts (:207) and bvh_hit_counts_batch (:302): a lax.while_loop
// under two vmaps, one stack per (query, user), not a Pallas site.
//
//   out[q, u] = min(#{t : every box on the path from the root to leaf t
//                         holds u, and u is inside t}, k_cap)
//
// for the users u < N and the queries q < Q, each query with its own tree.
// A box holds u inclusively (x >= xmin, y >= ymin, x <= xmax, y <= ymax);
// u is inside t when all three edges give >= 0.  The root is entered
// without a box test and a child only when its box holds u, as the
// reference does.
//
// The walk.  The reference walk (repro_torch/kernels/ref.py
// bvh_hit_counts_ref, one stack per user) pops a node, tests a leaf's
// triangle or pushes each child whose box holds the user (left, then
// right, so the right one pops first), and stops when the stack is empty
// or the count reaches k_cap.  Here one warp walks one query's tree once
// for a span of 32 * kUsers consecutive users of a spatial (Morton) order
// (kernels/user_order.py), kUsers a lane: user u * 32 + lane of the span
// is lane `lane`'s user u, and bit `lane` of mask word u stands for it.  A
// stack entry is a node plus kUsers mask words, the users whose boxes held
// on the way down; each step takes one node for the whole warp, and only
// the users in its mask whose count is below k_cap take part.  At an
// internal node they test both child boxes, and a ballot per child and
// word gives the children's masks; a child with an empty mask is not
// pushed.  At a leaf they test the triangle.  The right child is entered
// at once when its mask is not empty (the left one is pushed), else the
// left one, else the top of the stack is popped: the order of push left,
// push right, pop.  Restricted to one user, this is that user's own walk,
// node for node and in the same order, because each node's mask holds
// exactly the users whose own walk pushes it.  So each user's count is
// min(total, k_cap), and its pops (the internal nodes and leaves it took
// part in) are the reference's, user for user.  A node whose users all
// reached k_cap since it was pushed is popped and skipped with no load.
// The warp stops when its stack is empty or no user of it is below k_cap.
//
// The stack.  Entries are warp-uniform, so entry i lives in lane i % 32,
// slot i / 32 (two slots: kMaxStack = 64 entries, repro_torch/kernels/
// bvh.py MAX_STACK), and push and pop are predicated moves and 1 + kUsers
// __shfl_sync: no local memory.  The walk holds at most depth - 1 entries
// (the node it is in is not on the stack), and bvh.py bvh_batch refuses a
// tree deeper than kMaxStack, so no push finds the stack full; the guard
// on each push only keeps the walk inside its slots.
//
// The loads.  kernels/bvh.py pack_bvh packs each tree once per batch (on
// the host; bvh_batch uploads it): an internal node is one 48-byte record, the boxes of its two
// children (float4 each) and their codes (an internal-node index >= 0, or
// ~row for a leaf, row its triangle); a triangle is one 48-byte row of
// its nine coefficients.  Each step thus reads three float4 at one
// warp-uniform address, from a base pointer held in registers: three
// broadcast loads and one multiply-add, where the first design read left,
// right, two boxes and nine scalar coefficients per user and kept its
// stack in local memory.  A leaf that names a row >= Mt points at a
// never-inside row (0, 0, -1) that pack_bvh appends at row Mt, and a child
// >= Nn gets an empty box (min +inf, max -inf) that holds no user, so the
// walk needs no guard per pop, and pops as the reference does.  One
// query's records at the non-pruned CAL shape are 998 x 48 + 1,000 x 48 B,
// about 96 KB, and all 64 queries' about 6 MB, which stays in the 50 MB L2.
//
// What bounds it.  Measured on the CAL shapes (PERF.md, Findings): the users
// of a span take part in nearly every node their warp takes (the lane
// efficiency, the users' pops over the span's users times its busiest
// user's pops, is 0.997 for spans of 32 and 0.993 for the kernel's spans
// of 128 on the infzone batch), and a warp's steps are the union of its
// users' nodes, within 0.01 % of its busiest user's pops: the RkNN
// members, which walk the whole tree, lie together near q and fill spans
// of their own, so the lanes do not diverge.  The walk is bound by its
// instructions: each step costs its loads, shuffles, branches and stack
// moves once, and each user its compares, ballots and logic, which run at
// half the FP32 rate.  So a lane walks for kUsers = 4 users
// (USERS_PER_LANE in bvh.py; 1, 2 and 8 were slower on the card,
// PERF.md, Findings), and each user's mask bit and count start the chain
// of its compares as one predicate.
//
// The stores.  Each count is stored through the permutation straight to
// the user's own place: on the card this beat storing in Morton order and
// gathering back (PERF.md, Findings).  The optional outputs pops[2, Q, N]
// (internal nodes, row 0, and leaves, row 1, each user took part in) and
// steps[Q, n_spans] (the nodes each warp took) come from the kPops
// instance only; the serving instance has no counters.
//
// Bound (chip_smoke.py _bvh_bound_ms, the first design's yardstick).  The
// bytes of the function's inputs and output: 8 per user, 24 per node
// (left, right, box) and 36 per triangle per query in, 4 per (query, user)
// out.  The operations depend on the data: the function's own arithmetic
// on the reference walk's pops, 12 a leaf (three edges of two multiplies
// and two adds) and 8 an internal node (two child boxes of four
// compares), from the two rows of pops, all at the FP32 rate; the
// operations bound it.
//
// Rounding contract.  Each edge is ((x * a) + (y * b)) + c with __fmul_rn
// and __fadd_rn, so nvcc cannot contract it into an FMA: the contract of
// raycast.cu and grid_raycast.cu, which the plain version repeats with one
// rounding per operation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxStack = 64;  // repro_torch/kernels/bvh.py MAX_STACK: two slots a lane
constexpr int kUsers = 4;      // repro_torch/kernels/bvh.py USERS_PER_LANE
constexpr int kSpan = 32 * kUsers;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float edge(float x, float y, float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, a), __fmul_rn(y, b)), c);
}

__device__ __forceinline__ bool in_box(float x, float y, const float4 b) {
  return (x >= b.x) & (y >= b.y) & (x <= b.z) & (y <= b.w);
}

// Row layout (pack_bvh): a0 b0 c0 a1 | b1 c1 a2 b2 | c2 - - -
__device__ __forceinline__ bool in_tri(float x, float y, const float4 r0, const float4 r1,
                                       const float4 r2) {
  return (edge(x, y, r0.x, r0.y, r0.z) >= 0.0f) & (edge(x, y, r0.w, r1.x, r1.y) >= 0.0f) &
         (edge(x, y, r1.z, r1.w, r2.x) >= 0.0f);
}

// The pointer, kept in a register: one multiply-add then addresses a
// record, instead of the whole offset recomputed from the query each step.
__device__ __forceinline__ const char* pinned(const char* p) {
  uint64_t v;
  asm("mov.b64 %0, %1;" : "=l"(v) : "l"(reinterpret_cast<uint64_t>(p)));
  return reinterpret_cast<const char*>(v);
}

template <bool kPops>
__global__ void __launch_bounds__(kThreads)
bvh_walk_kernel(const float* __restrict__ xs_s,     // [N] users in Morton order
                const float* __restrict__ ys_s,
                const int32_t* __restrict__ perm,   // [N] sorted position -> user
                const float4* __restrict__ nodes,   // [Q, n_inner, 3] records
                const float4* __restrict__ tris,    // [Q, n_rows, 3] triangle rows
                const int32_t* __restrict__ root,   // [Q] the root's code
                int32_t* __restrict__ out,          // [Q, N]
                int32_t* __restrict__ pops,         // [2, Q, N] (kPops)
                int32_t* __restrict__ steps,        // [Q, ceil(N / kSpan)] (kPops)
                int64_t n, int n_inner, int n_rows, int k_cap) {
  const int lane = threadIdx.x & 31;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * kSpan;
  if (first >= n) return;  // the whole warp: no lane of it has a user
  const int64_t q = blockIdx.y;
  const unsigned bit = 1u << lane;
  float x[kUsers], y[kUsers];
  int count[kUsers], inner[kUsers], leaves[kUsers];
  unsigned mask[kUsers], m0[kUsers], m1[kUsers];  // m0, m1: the masks of the stack's entries
  bool alive = false;
#pragma unroll
  for (int u = 0; u < kUsers; ++u) {
    const int64_t i = first + u * 32 + lane;
    const bool user = i < n;
    x[u] = user ? xs_s[i] : 0.0f;
    y[u] = user ? ys_s[i] : 0.0f;
    count[u] = user ? 0 : k_cap;  // a lane with no user is never below k_cap
    inner[u] = leaves[u] = 0;
    mask[u] = __ballot_sync(kAll, user);
    m0[u] = m1[u] = 0;
    alive |= count[u] < k_cap;
  }
  const char* nq = pinned(reinterpret_cast<const char*>(nodes + q * n_inner * 3));
  const char* tq = pinned(reinterpret_cast<const char*>(tris + q * n_rows * 3));
  int code = root[q], taken = 0;
  int c0 = 0, c1 = 0, sp = 0;  // the stack: entry e in lane e % 32, slot e / 32
  // A user takes part in a step when its bit is in the node's mask and its
  // count is below k_cap; the warp stops when no user of it is below k_cap.
  while (__any_sync(kAll, alive)) {
    bool mine[kUsers], any = false;
#pragma unroll
    for (int u = 0; u < kUsers; ++u) {
      mine[u] = ((mask[u] & bit) != 0) & (count[u] < k_cap);
      any |= mine[u];
    }
    if (__any_sync(kAll, any)) {
      if (kPops) ++taken;
      if (code >= 0) {  // internal: both child boxes, one record
        const float4* r = reinterpret_cast<const float4*>(nq + static_cast<unsigned>(code) * 48u);
        const float4 lb = __ldg(r), rb = __ldg(r + 1), kids = __ldg(r + 2);
        unsigned ml[kUsers], mr[kUsers], any_l = 0, any_r = 0;
#pragma unroll
        for (int u = 0; u < kUsers; ++u) {
          ml[u] = __ballot_sync(kAll, mine[u] & in_box(x[u], y[u], lb));
          mr[u] = __ballot_sync(kAll, mine[u] & in_box(x[u], y[u], rb));
          any_l |= ml[u];
          any_r |= mr[u];
          if (kPops) inner[u] += mine[u];
        }
        const int lcode = __float_as_int(kids.x), rcode = __float_as_int(kids.y);
        if (any_r != 0) {
          if (any_l != 0 && sp < kMaxStack) {  // push the left child, enter the right
            if (lane == (sp & 31)) {
              if (sp < 32) {
                c0 = lcode;
#pragma unroll
                for (int u = 0; u < kUsers; ++u) m0[u] = ml[u];
              } else {
                c1 = lcode;
#pragma unroll
                for (int u = 0; u < kUsers; ++u) m1[u] = ml[u];
              }
            }
            ++sp;
          }
          code = rcode;
#pragma unroll
          for (int u = 0; u < kUsers; ++u) mask[u] = mr[u];
          continue;
        }
        if (any_l != 0) {
          code = lcode;
#pragma unroll
          for (int u = 0; u < kUsers; ++u) mask[u] = ml[u];
          continue;
        }
      } else {  // leaf: the any-hit test of its one triangle
        const float4* t = reinterpret_cast<const float4*>(tq + static_cast<unsigned>(~code) * 48u);
        const float4 r0 = __ldg(t), r1 = __ldg(t + 1), r2 = __ldg(t + 2);
        alive = false;
#pragma unroll
        for (int u = 0; u < kUsers; ++u) {
          if (mine[u] & in_tri(x[u], y[u], r0, r1, r2)) ++count[u];
          if (kPops) leaves[u] += mine[u];
          alive |= count[u] < k_cap;
        }
      }
    }
    if (sp == 0) break;
    --sp;  // pop
    const bool hi = sp >= 32;
    code = __shfl_sync(kAll, hi ? c1 : c0, sp & 31);
#pragma unroll
    for (int u = 0; u < kUsers; ++u) mask[u] = __shfl_sync(kAll, hi ? m1[u] : m0[u], sp & 31);
  }
#pragma unroll
  for (int u = 0; u < kUsers; ++u) {
    const int64_t i = first + u * 32 + lane;
    if (i < n) {
      const int64_t dst = q * n + perm[i];
      out[dst] = count[u];
      if (kPops) {
        pops[dst] = inner[u];
        pops[static_cast<int64_t>(gridDim.y) * n + dst] = leaves[u];
      }
    }
  }
  if (kPops && lane == 0) steps[q * ((n + kSpan - 1) / kSpan) + first / kSpan] = taken;
}

template <bool kPops>
void launch(int64_t n, int n_queries, cudaStream_t stream, const void* xs_s, const void* ys_s,
            const void* perm, const void* nodes, const void* tris, const void* root, void* out,
            void* pops, void* steps, int n_inner, int n_rows, int k_cap) {
  constexpr int kBlockUsers = kWarps * kSpan;
  const dim3 grid(static_cast<unsigned>((n + kBlockUsers - 1) / kBlockUsers),
                  static_cast<unsigned>(n_queries));
  bvh_walk_kernel<kPops><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(xs_s), static_cast<const float*>(ys_s),
      static_cast<const int32_t*>(perm), static_cast<const float4*>(nodes),
      static_cast<const float4*>(tris), static_cast<const int32_t*>(root),
      static_cast<int32_t*>(out), static_cast<int32_t*>(pops), static_cast<int32_t*>(steps), n,
      n_inner, n_rows, k_cap);
}

}  // namespace

// out[q, perm[i]] for q < n_queries and the users i < n_users in Morton
// order (xs_s, ys_s; perm maps that order to the users' order), each warp
// walking for a span of 32 * kUsers users.  nodes: [n_queries, n_inner, 12]
// float32 records, tris: [n_queries, n_rows, 12] float32 rows, root:
// [n_queries] int32 (kernels/bvh.py pack_bvh), all 16-byte aligned.  When
// pops is not null, pops [2, n_queries, n_users] and steps [n_queries,
// ceil(n_users / (32 * kUsers))] are written too (the counting instance).
// The caller never passes an empty grid (n_users or n_queries of 0), nor a
// tree deeper than kMaxStack.  Launches on `stream`, allocates nothing,
// does not synchronize, and returns cudaGetLastError() (0 = cudaSuccess).
extern "C" int bvh_traverse(const void* xs_s, const void* ys_s, const void* perm,
                            const void* nodes, const void* tris, const void* root, void* out,
                            void* pops, void* steps, long long n_users, int n_inner, int n_rows,
                            int n_queries, int k_cap, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n = static_cast<int64_t>(n_users);
  if (pops != nullptr) {
    launch<true>(n, n_queries, s, xs_s, ys_s, perm, nodes, tris, root, out, pops, steps,
                 n_inner, n_rows, k_cap);
  } else {
    launch<false>(n, n_queries, s, xs_s, ys_s, perm, nodes, tris, root, out, pops, steps,
                  n_inner, n_rows, k_cap);
  }
  return static_cast<int>(cudaGetLastError());
}

// The users a lane walks for, so the wrapper can check its own copy.
extern "C" int bvh_traverse_users_per_lane() { return kUsers; }

// The stack the kernel's walk has, so the wrapper can check its own copy.
extern "C" int bvh_traverse_max_stack() { return kMaxStack; }

extern "C" const char* bvh_traverse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
