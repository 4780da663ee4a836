// BVH stack traversal with early exit at k (the paper's Algorithm 1/2),
// for Hopper, sm_90a.
//
// Replaces the JAX package's traversal, src/repro/core/bvh.py
// bvh_hit_counts (:207) and bvh_hit_counts_batch (:302): a lax.while_loop
// under two vmaps, not a Pallas site.  On a TPU that loop runs every lane
// to the longest one in its batch and every node fetch is a gather; here
// it is what the SIMT model does natively, one thread per ray.
//
//   out[q, u] = min(#{t : every box on the path from the root to leaf t
//                         holds u, and u is inside t}, k_cap)
//
// for the users u < N and the queries q < Q, each query with its own tree
// (left, right, bbox: [Q, Nn]) and triangle table (coeffs: [Q, Mt, 3, 3]).
// Node encoding (repro_torch/core/bvh.py): root node 0; an internal node's
// children are left >= 0 and right >= 0; a leaf has left = -(tri + 1).  A
// box holds u inclusively (x >= xmin, y >= ymin, x <= xmax, y <= ymax); u
// is inside t when all three edges give >= 0.  The root is pushed without
// a box test and a child only when its box holds u, as the reference does.
// The count is min(total, k_cap) whatever order the children are popped
// in: each leaf adds 0 or 1, and the walk stops exactly when the count
// reaches k_cap.  So this kernel pops the right child first, as the
// reference does, but any order would give the same counts.
//
// Design (simple first; the plain twin is repro_torch/kernels/ref.py
// bvh_hit_counts_ref, the same walk written out over all lanes at once).
// One thread per (query, user), a block of 128 threads, a grid of
// (ceil(N / 128), Q) blocks.  The users
// arrive in a spatial (Morton) order (repro_torch/kernels/user_order.py),
// so the 32 lanes of a warp are neighbours and walk nearly the same nodes:
// their loads of one node coalesce into one transaction, and their branches
// diverge only where a box edge passes between them.  Each thread keeps a
// stack of kMaxStack int32 node ids (local memory, cached in L1).  Node
// fields and coefficient rows are read through the read-only path (__ldg):
// one query's tree and triangles at the non-pruned CAL shape are
// 1,997 x 24 B + 999 x 36 B, about 84 KB, and all 64 queries' about 5.4 MB,
// which stays in the 50 MB L2.  Each count is stored through the
// permutation straight to the user's own place (the rank-count kernel's
// way, which beat a store in tile order plus a gather back on the H100).
// An optional second output, pops[2, Q, N], holds the internal nodes
// (row 0) and the leaves (row 1) each lane popped (written only when the
// pointer is not null): the operations term of the bound is counted from
// it.
//
// Stack.  A walk pops one node and pushes at most its two children, so
// with the root at depth 1 it never holds more entries than the tree's
// depth (each internal node on a path adds one entry net).  The trees come
// in a BvhBatch (repro_torch/kernels/bvh.py), whose one maker takes the
// depth from the node arrays and refuses a batch deeper than kMaxStack, so
// no push here finds the stack full; the guard on each push only keeps the
// walk inside its array.  Leaves that name a row >= Mt and children >= Nn
// count nothing and are not pushed (an empty scene's single leaf root with
// Mt = 0 counts 0, as the reference's zero initial stack does).
//
// Bound.  The bytes: 8 per user in, 24 per node (left, right, box) and 36
// per triangle per query in, 4 per (query, user) out.  The operations
// depend on the data: the function's own arithmetic on what the lanes
// popped, 12 per leaf (three edges of two multiplies and two adds) and 8
// per internal node (two child boxes of four compares), from the two rows
// of pops (chip_smoke.py _bvh_bound_ms).  Lanes that reach k stop early,
// but a warp runs as long as its slowest lane: users near q (the RkNN
// members) walk the whole tree.
//
// Rounding contract.  Each edge is ((x * a) + (y * b)) + c with __fmul_rn
// and __fadd_rn, so nvcc cannot contract it into an FMA: the contract of
// raycast.cu and grid_raycast.cu, which the plain version repeats with one
// rounding per operation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxStack = 64;  // repro_torch/kernels/bvh.py MAX_STACK

__device__ __forceinline__ float edge(float x, float y, float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, a), __fmul_rn(y, b)), c);
}

__device__ __forceinline__ bool in_box(float x, float y, const float4 b) {
  return x >= b.x && y >= b.y && x <= b.z && y <= b.w;
}

__device__ __forceinline__ bool in_tri(float x, float y, const float* __restrict__ e) {
  return edge(x, y, __ldg(e + 0), __ldg(e + 1), __ldg(e + 2)) >= 0.0f &&
         edge(x, y, __ldg(e + 3), __ldg(e + 4), __ldg(e + 5)) >= 0.0f &&
         edge(x, y, __ldg(e + 6), __ldg(e + 7), __ldg(e + 8)) >= 0.0f;
}

__global__ void __launch_bounds__(kThreads)
bvh_traverse_kernel(const float* __restrict__ xs_s,      // [N] users in Morton order
                    const float* __restrict__ ys_s,
                    const int32_t* __restrict__ perm,    // [N] sorted position -> user
                    const int32_t* __restrict__ left,    // [Q, Nn]
                    const int32_t* __restrict__ right,   // [Q, Nn]
                    const float4* __restrict__ bbox,     // [Q, Nn] (xmin, ymin, xmax, ymax)
                    const float* __restrict__ coeffs,    // [Q, Mt, 3, 3]
                    int32_t* __restrict__ out,           // [Q, N] in the users' order
                    int32_t* __restrict__ pops,          // [2, Q, N] or null
                    int64_t n, int nn, int mt, int k_cap) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t q = blockIdx.y;
  const float x = xs_s[i], y = ys_s[i];
  const int32_t* lq = left + q * nn;
  const int32_t* rq = right + q * nn;
  const float4* bq = bbox + q * nn;
  const float* cq = coeffs + q * static_cast<int64_t>(mt) * 9;

  int stack[kMaxStack];
  int sp = 0, count = 0, inner = 0, leaves = 0;
  stack[sp++] = 0;  // the root, with no box test
  while (sp > 0 && count < k_cap) {
    const int node = stack[--sp];
    const int l = __ldg(lq + node);
    if (l < 0) {  // leaf: the any-hit test of its one triangle
      ++leaves;
      const int tri = -(l + 1);
      if (tri < mt && in_tri(x, y, cq + static_cast<int64_t>(tri) * 9)) ++count;
    } else {  // internal: push each child whose box holds the user
      ++inner;
      const int r = __ldg(rq + node);
      if (l < nn && sp < kMaxStack && in_box(x, y, __ldg(bq + l))) stack[sp++] = l;
      if (r >= 0 && r < nn && sp < kMaxStack && in_box(x, y, __ldg(bq + r))) stack[sp++] = r;
    }
  }
  const int64_t dst = q * n + perm[i];
  out[dst] = count;
  if (pops != nullptr) {
    pops[dst] = inner;
    pops[static_cast<int64_t>(gridDim.y) * n + dst] = leaves;
  }
}

}  // namespace

// out[q, perm[i]] (and pops[0 and 1, q, perm[i]] when pops is not null) for
// q < n_queries and the users i < n_users in Morton order (xs_s, ys_s; perm
// maps that order to the users' order).  left, right: [n_queries, n_nodes]
// int32; bbox: [n_queries, n_nodes] float4 (16-byte aligned); coeffs:
// [n_queries, n_tris, 3, 3] float32.  The caller never passes an empty grid
// (n_users or n_queries of 0), nor a tree deeper than kMaxStack.  Launches
// on `stream`, allocates nothing, does not synchronize, and returns
// cudaGetLastError() (0 = cudaSuccess).
extern "C" int bvh_traverse(const void* xs_s, const void* ys_s, const void* perm,
                            const void* left, const void* right, const void* bbox,
                            const void* coeffs, void* out, void* pops, long long n_users,
                            int n_nodes, int n_tris, int n_queries, int k_cap, void* stream) {
  const dim3 grid(static_cast<unsigned>((n_users + kThreads - 1) / kThreads),
                  static_cast<unsigned>(n_queries));
  bvh_traverse_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xs_s), static_cast<const float*>(ys_s),
      static_cast<const int32_t*>(perm), static_cast<const int32_t*>(left),
      static_cast<const int32_t*>(right), static_cast<const float4*>(bbox),
      static_cast<const float*>(coeffs), static_cast<int32_t*>(out),
      static_cast<int32_t*>(pops), static_cast<int64_t>(n_users), n_nodes, n_tris, k_cap);
  return static_cast<int>(cudaGetLastError());
}

// The stack the kernel's walk has, so the wrapper can check its own copy.
extern "C" int bvh_traverse_max_stack() { return kMaxStack; }

extern "C" const char* bvh_traverse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
