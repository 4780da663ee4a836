// Fused AdamW updates for Hopper, sm_90a: row 10 with float32 moments and
// row 11 with block-wise int8 moments.
//
// Neither replaces a Pallas kernel: they replace the jnp bodies of
// src/repro/optim/adamw.py adamw_update (row 10) and
// src/repro/optim/adamw8bit.py adamw8bit_update with its
// quantize_blockwise / dequantize_blockwise (row 11), which XLA fuses on
// the TPU and which PyTorch would run as about 16 (row 10) or more than 30
// (row 11) elementwise launches a leaf, each reading and writing whole
// leaves.
//
// Law, per element of a float32 leaf, after the global-norm clip:
//   g = g * scale
//   m = m * b1 + (1 - b1) * g
//   v = v * b2 + ((1 - b2) * g) * g
//   p = p - lr * ((m / bc1) / (sqrt(v / bc2) + eps) + wd * p)
// lr, bc1 = 1 - b1^t, bc2 = 1 - b2^t and the clip scale are 0-d float32
// tensors on the card (computed by torch ops, read here, so no host
// synchronisation), b1, 1 - b1, b2, 1 - b2, eps and wd float32 arguments.
//
// Row 11 keeps each moment as int8 in blocks of 128 elements with one
// float32 scale a block: m signed, q = clamp(rint(m / max(s, tiny)),
// -127, 127) with s = absmax / 127; v unsigned, stored as q - 128 with
// q = clamp(rint(v / max(s, tiny)), 0, 255) and s = max / 255.  A leaf's
// last block is padded with zeros, which quantize to 0 (m) and -128 (v).
//
// Design.  One launch updates every leaf: the wrapper uploads a table of
// (pointers, size, first chunk) per leaf, and block b finds its leaf by a
// binary search over the first chunks.  Row 10: a block owns a chunk of
// kChunkF32 elements of one leaf and walks it in float4 loads and stores
// (scalar where a leaf's pointers are not 16-byte aligned, and for its
// ragged tail).  Row 11: each warp owns whole 128-element blocks, 4 a lane;
// it dequantizes both moments in registers, applies the law, takes the new
// absmax by a warp's shuffle max and requantizes, so no float32 moment is
// ever written to device memory.
//
// Bound.  Bytes: row 10 reads p, g, m, v and writes p, m, v, 28 B an
// element; row 11 reads p, g and two int8 moments and writes p and the
// moments, 16 B and 16 B of scales a 128-element block (16.125 B an
// element).  About 20 float operations an element are far below the
// card's rate, so both are bound by device memory.
//
// Rounding contract.  The plain versions (repro_torch/kernels/ref.py
// adamw_ref, adamw8bit_ref) are torch elementwise ops, each rounding once.
// Every operation here is written with __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn / __fsqrt_rn in their order, so nvcc cannot contract a
// product and a sum into an FMA, and rintf rounds half to even as
// torch.round does: on the card the kernels are bit-identical to them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunkF32 = kThreads * 4 * 8;  // kernels/adamw.py CHUNK_F32
constexpr int kFieldsF32 = 6;                // p, g, m, v, n, first chunk
constexpr int kQBlock = 128;                 // kernels/ref.py QUANT_BLOCK
constexpr int kQBlocksPerWarp = 4;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkInt8 = kWarps * kQBlocksPerWarp * kQBlock;  // kernels/adamw.py CHUNK_INT8
constexpr int kFieldsInt8 = 8;  // p, g, mq, ms, vq, vs, n, first chunk

struct AdamScalars {
  float b1, omb1, b2, omb2, eps, wd, tiny;
};

struct Step {
  float lr, bc1, bc2, scale;
};

// The leaf whose chunks hold `chunk`: the last i with first[i] <= chunk
// (leaves without elements own no chunk and are passed over).
__device__ __forceinline__ int find_leaf(const long long* table, int fields, int n_leaves,
                                         long long chunk) {
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[static_cast<long long>(mid) * fields + fields - 1] <= chunk) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// The law on one element, in the plain version's order.
__device__ __forceinline__ void adam(float& p, float g, float& m, float& v, const Step& t,
                                     const AdamScalars& s) {
  g = __fmul_rn(g, t.scale);
  m = __fadd_rn(__fmul_rn(m, s.b1), __fmul_rn(s.omb1, g));
  v = __fadd_rn(__fmul_rn(v, s.b2), __fmul_rn(__fmul_rn(s.omb2, g), g));
  const float upd =
      __fdiv_rn(__fdiv_rn(m, t.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, t.bc2)), s.eps));
  p = __fsub_rn(p, __fmul_rn(t.lr, __fadd_rn(upd, __fmul_rn(s.wd, p))));
}

__device__ __forceinline__ Step load_step(const float* lr, const float* bc1, const float* bc2,
                                          const float* scale) {
  return Step{*lr, *bc1, *bc2, *scale};
}

__global__ void __launch_bounds__(kThreads)
adamw_f32_kernel(const long long* __restrict__ table, int n_leaves, const float* lr_p,
                 const float* bc1_p, const float* bc2_p, const float* scale_p, AdamScalars s) {
  const long long chunk = blockIdx.x;
  const long long* e = table + static_cast<long long>(find_leaf(table, kFieldsF32, n_leaves, chunk))
                                   * kFieldsF32;
  float* __restrict__ p = reinterpret_cast<float*>(e[0]);
  const float* __restrict__ g = reinterpret_cast<const float*>(e[1]);
  float* __restrict__ m = reinterpret_cast<float*>(e[2]);
  float* __restrict__ v = reinterpret_cast<float*>(e[3]);
  const long long n = e[4];
  const long long start = (chunk - e[5]) * kChunkF32;
  const long long end = min(n, start + kChunkF32);
  const Step t = load_step(lr_p, bc1_p, bc2_p, scale_p);
  const bool aligned = ((e[0] | e[1] | e[2] | e[3]) & 15) == 0;
  long long i = start;
  if (aligned) {
    const long long vend = start + ((end - start) & ~3LL);
    for (long long j = start + 4LL * threadIdx.x; j < vend; j += 4LL * kThreads) {
      float4 pp = *reinterpret_cast<const float4*>(p + j);
      const float4 gg = *reinterpret_cast<const float4*>(g + j);
      float4 mm = *reinterpret_cast<const float4*>(m + j);
      float4 vv = *reinterpret_cast<const float4*>(v + j);
      adam(pp.x, gg.x, mm.x, vv.x, t, s);
      adam(pp.y, gg.y, mm.y, vv.y, t, s);
      adam(pp.z, gg.z, mm.z, vv.z, t, s);
      adam(pp.w, gg.w, mm.w, vv.w, t, s);
      *reinterpret_cast<float4*>(p + j) = pp;
      *reinterpret_cast<float4*>(m + j) = mm;
      *reinterpret_cast<float4*>(v + j) = vv;
    }
    i = vend;
  }
  for (long long j = i + threadIdx.x; j < end; j += kThreads) {
    float pj = p[j], mj = m[j], vj = v[j];
    adam(pj, g[j], mj, vj, t, s);
    p[j] = pj;
    m[j] = mj;
    v[j] = vj;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__global__ void __launch_bounds__(kThreads)
adamw_int8_kernel(const long long* __restrict__ table, int n_leaves, const float* lr_p,
                  const float* bc1_p, const float* bc2_p, const float* scale_p, AdamScalars s) {
  const long long chunk = blockIdx.x;
  const long long* e = table + static_cast<long long>(find_leaf(table, kFieldsInt8, n_leaves, chunk))
                                   * kFieldsInt8;
  float* __restrict__ p = reinterpret_cast<float*>(e[0]);
  const float* __restrict__ g = reinterpret_cast<const float*>(e[1]);
  int8_t* __restrict__ mq = reinterpret_cast<int8_t*>(e[2]);
  float* __restrict__ ms = reinterpret_cast<float*>(e[3]);
  int8_t* __restrict__ vq = reinterpret_cast<int8_t*>(e[4]);
  float* __restrict__ vs = reinterpret_cast<float*>(e[5]);
  const long long n = e[6];
  const Step t = load_step(lr_p, bc1_p, bc2_p, scale_p);
  const bool aligned = ((e[0] | e[1]) & 15) == 0 && ((e[2] | e[4]) & 3) == 0;
  const int lane = threadIdx.x & 31;
  const long long first_qb =
      (chunk - e[7]) * (kChunkInt8 / kQBlock) + (threadIdx.x >> 5) * kQBlocksPerWarp;
#pragma unroll 1
  for (int k = 0; k < kQBlocksPerWarp; ++k) {
    const long long qb = first_qb + k;
    const long long i0 = qb * kQBlock + 4 * lane;
    if (qb * kQBlock >= n) break;  // the same for the whole warp
    float pp[4], gg[4], mm[4], vv[4];
    signed char qm[4], qv[4];
    const bool full = aligned && i0 + 4 <= n;
    if (full) {
      const float4 p4 = *reinterpret_cast<const float4*>(p + i0);
      const float4 g4 = *reinterpret_cast<const float4*>(g + i0);
      const char4 m4 = *reinterpret_cast<const char4*>(mq + i0);
      const char4 v4 = *reinterpret_cast<const char4*>(vq + i0);
      pp[0] = p4.x; pp[1] = p4.y; pp[2] = p4.z; pp[3] = p4.w;
      gg[0] = g4.x; gg[1] = g4.y; gg[2] = g4.z; gg[3] = g4.w;
      qm[0] = m4.x; qm[1] = m4.y; qm[2] = m4.z; qm[3] = m4.w;
      qv[0] = v4.x; qv[1] = v4.y; qv[2] = v4.z; qv[3] = v4.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = i0 + j < n;
        pp[j] = in ? p[i0 + j] : 0.0f;
        gg[j] = in ? g[i0 + j] : 0.0f;
        qm[j] = mq[i0 + j];  // the moments hold whole blocks
        qv[j] = vq[i0 + j];
      }
    }
    const float sm = ms[qb], sv = vs[qb];
    float am = 0.0f, av = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (i0 + j < n) {
        mm[j] = __fmul_rn(static_cast<float>(qm[j]), sm);
        vv[j] = __fmul_rn(__fadd_rn(static_cast<float>(qv[j]), 128.0f), sv);
        adam(pp[j], gg[j], mm[j], vv[j], t, s);
      } else {
        mm[j] = 0.0f;  // the zero padding of the last block
        vv[j] = 0.0f;
      }
      am = fmaxf(am, fabsf(mm[j]));
      av = fmaxf(av, vv[j]);
    }
    am = warp_max(am);
    av = warp_max(av);
    const float new_sm = __fdiv_rn(am, 127.0f), new_sv = __fdiv_rn(av, 255.0f);
    // torch.clamp(scale, min=tiny), which keeps a NaN
    const float dm = new_sm < s.tiny ? s.tiny : new_sm;
    const float dv = new_sv < s.tiny ? s.tiny : new_sv;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      qm[j] = static_cast<signed char>(fminf(fmaxf(rintf(__fdiv_rn(mm[j], dm)), -127.0f), 127.0f));
      qv[j] = static_cast<signed char>(
          __fsub_rn(fminf(fmaxf(rintf(__fdiv_rn(vv[j], dv)), 0.0f), 255.0f), 128.0f));
    }
    if (full) {
      *reinterpret_cast<float4*>(p + i0) = make_float4(pp[0], pp[1], pp[2], pp[3]);
      *reinterpret_cast<char4*>(mq + i0) = make_char4(qm[0], qm[1], qm[2], qm[3]);
      *reinterpret_cast<char4*>(vq + i0) = make_char4(qv[0], qv[1], qv[2], qv[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (i0 + j < n) p[i0 + j] = pp[j];
        mq[i0 + j] = qm[j];
        vq[i0 + j] = qv[j];
      }
    }
    if (lane == 0) {
      ms[qb] = new_sm;
      vs[qb] = new_sv;
    }
  }
}

}  // namespace

// Row 10: every leaf of `table` ([n_leaves, 6] int64: p, g, m, v, n, first
// chunk), n_chunks chunks of kChunkF32 elements in all.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int adamw_f32(const void* table, int n_leaves, long long n_chunks, const void* lr,
                         const void* bc1, const void* bc2, const void* scale, float b1,
                         float omb1, float b2, float omb2, float eps, float wd, void* stream) {
  if (n_chunks <= 0 || n_chunks > 0x7fffffffLL || n_leaves <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const AdamScalars s{b1, omb1, b2, omb2, eps, wd, 0.0f};
  adamw_f32_kernel<<<static_cast<unsigned>(n_chunks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), n_leaves, static_cast<const float*>(lr),
      static_cast<const float*>(bc1), static_cast<const float*>(bc2),
      static_cast<const float*>(scale), s);
  return static_cast<int>(cudaGetLastError());
}

// Row 11: every leaf of `table` ([n_leaves, 8] int64: p, g, mq, ms, vq, vs,
// n, first chunk), n_chunks chunks of kChunkInt8 elements in all; `tiny`
// is the floor of a scale before it divides.
extern "C" int adamw_int8(const void* table, int n_leaves, long long n_chunks, const void* lr,
                          const void* bc1, const void* bc2, const void* scale, float b1,
                          float omb1, float b2, float omb2, float eps, float wd, float tiny,
                          void* stream) {
  if (n_chunks <= 0 || n_chunks > 0x7fffffffLL || n_leaves <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const AdamScalars s{b1, omb1, b2, omb2, eps, wd, tiny};
  adamw_int8_kernel<<<static_cast<unsigned>(n_chunks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), n_leaves, static_cast<const float*>(lr),
      static_cast<const float*>(bc1), static_cast<const float*>(bc2),
      static_cast<const float*>(scale), s);
  return static_cast<int>(cudaGetLastError());
}

// The chunk sizes and the quantization block the wrapper must plan with.
extern "C" void adamw_geometry(int* chunk_f32, int* chunk_int8, int* qblock) {
  *chunk_f32 = kChunkF32;
  *chunk_int8 = kChunkInt8;
  *qblock = kQBlock;
}

extern "C" const char* adamw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
