// Elementwise skeleton for mapped kokkos.* nests, written by hand; the
// region code generator (kernels/codegen.py) supplies the per-element
// functor, the body that loads and stores each operand by its type, and an
// extern "C" launcher.
//
// Replaces the TPU kernel src/repro/kernels/generic.py:block_map /
// block_map_region (pallas_call at generic.py:50).  There each grid step
// copies one tiling["block"] block of every operand into VMEM, runs the
// nest body on it and writes the result block back, with the operands
// padded to whole blocks.  The body of a fused region keeps its
// intermediates in registers, so a chain of N elementwise ops is one
// launch that reads each operand once and writes the result once: the
// bound is those bytes over HBM bandwidth.
//
// On Hopper the IR tile adds nothing the card needs: the wrapper hands
// every operand at the output's shape, contiguous, so a nest is a flat
// stream of n elements.  What a stream needs on this card is bytes in
// flight, so:
//  * a thread takes V elements a step, V = 16 bytes / the widest element
//    among the operands and the output (4 for f32, 8 when all are bf16 or
//    f16): 16-byte loads of the widest operands, 8-byte ones of narrower;
//  * it issues the loads of `unroll` vectors of every operand before it
//    computes one, held raw (bf16 unwidened) in registers: as many as
//    INFLIGHT_BYTES hold, at most MAX_UNROLL (4 at two f32 or two bf16
//    operands, 1 at seven f32 operands: no spills);
//  * the grid is sized to the card (SM count x BLOCKS_PER_SM, whose
//    registers __launch_bounds__ holds) and walks the stream with a
//    grid-stride loop, neighbouring threads on neighbouring vectors;
//  * the ragged tail (n mod V) runs in the same launch on scalar loads;
//  * where any operand's or the output's base is off 16 bytes, the whole
//    launch runs at V = 1 (the same loop of scalar loads).
// Loads take the read-only path; stores are plain (the next kernel, a
// gemm for the MLP block's silu.mul, reads the result).
//
// plan (exported from every generated library as lapis_map_plan; its twin
// is kernels/generic.py::map_plan, held equal on the card) is the launch.
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lapis_cuda.cuh"
#include "lapis_scalar.h"

namespace lapis_map {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 4;     // the resident blocks the grid is sized to
constexpr int MAX_UNROLL = 4;        // most vectors of every operand in flight a thread
constexpr int INFLIGHT_BYTES = 128;  // loaded bytes a thread holds a step (32 registers)

// Vectors of every operand a thread loads before it computes: vectors of
// `vec` elements of operands whose element sizes sum to `in_bytes`.
__host__ __device__ constexpr int unroll_for(int vec, int in_bytes) {
  return INFLIGHT_BYTES / (vec * in_bytes) < 1 ? 1
         : INFLIGHT_BYTES / (vec * in_bytes) > MAX_UNROLL ? MAX_UNROLL
                                                           : INFLIGHT_BYTES / (vec * in_bytes);
}

struct Plan {
  int vec, unroll, threads;
  long long grid, vectors, tail;
};

// n elements whose widest operand (or output) has `item` bytes and whose
// operands' element sizes sum to `in_bytes`; `aligned`: every base on a
// 16-byte boundary.
inline Plan plan(long long n, int item, int in_bytes, bool aligned, int sm_count) {
  const int vec = aligned ? 16 / item : 1;
  const int unroll = unroll_for(vec, in_bytes);
  const long long vectors = n / vec, tail = n - vectors * vec;
  const long long per_block = (long long)THREADS * unroll;
  long long grid = (vectors + per_block - 1) / per_block;
  if (grid < 1 && n > 0) grid = 1;  // the tail alone
  const long long cap = (long long)sm_count * BLOCKS_PER_SM;
  return {vec, unroll, THREADS, grid < cap ? grid : cap, vectors, tail};
}

// The raw type of a vector of `Bytes` bytes, and its 32-bit words.
template <int Bytes>
struct Raw;
template <>
struct Raw<16> {
  using type = uint4;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<4> {
  using type = unsigned int;
};
template <>
struct Raw<2> {
  using type = unsigned short;
};

__device__ __forceinline__ unsigned word(const uint4& r, int k) {
  return k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
}
__device__ __forceinline__ unsigned word(const uint2& r, int k) { return k == 0 ? r.x : r.y; }
__device__ __forceinline__ unsigned word(unsigned r, int) { return r; }
__device__ __forceinline__ unsigned word(unsigned short r, int) { return r; }

__device__ __forceinline__ void put(uint4* q, const unsigned* w) {
  *q = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void put(uint2* q, const unsigned* w) { *q = make_uint2(w[0], w[1]); }
__device__ __forceinline__ void put(unsigned* q, const unsigned* w) { *q = w[0]; }
__device__ __forceinline__ void put(unsigned short* q, const unsigned* w) {
  *q = (unsigned short)w[0];
}

// Element h of a 32-bit word as f32 (exact), and an f32 as the bits of an
// element (bf16 / f16: one round-to-nearest-even, as torch's .to()).
__device__ __forceinline__ float widen(const float*, unsigned w, int) { return __uint_as_float(w); }
__device__ __forceinline__ float widen(const __nv_bfloat16*, unsigned w, int h) {
  return __uint_as_float(h ? (w & 0xffff0000u) : (w << 16));
}
__device__ __forceinline__ float widen(const __half*, unsigned w, int h) {
  return __half2float(__ushort_as_half((unsigned short)(h ? w >> 16 : w & 0xffffu)));
}
__device__ __forceinline__ unsigned narrow(const float*, float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned narrow(const __nv_bfloat16*, float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ unsigned narrow(const __half*, float v) {
  return __half_as_ushort(__float2half_rn(v));
}

// W elements of T as one raw vector: loaded by one load of W x sizeof(T)
// bytes on the read-only path, read element by element as f32.
template <int W, class T>
struct Vec {
  static constexpr int E = 4 / (int)sizeof(T);  // elements a 32-bit word
  using R = typename Raw<W * (int)sizeof(T)>::type;
  R r;
  __device__ __forceinline__ void load(const T* __restrict__ p, long long v) {
    r = __ldg(reinterpret_cast<const R*>(p) + v);
  }
  __device__ __forceinline__ float operator[](int e) const {
    return widen(static_cast<const T*>(nullptr), word(r, e / E), e % E);
  }
};

// y as vector v (W elements) of p: one store.
template <int W, class T>
__device__ __forceinline__ void store(T* __restrict__ p, long long v, const float (&y)[W]) {
  constexpr int E = 4 / (int)sizeof(T);
  constexpr int WORDS = (W + E - 1) / E;
  using R = typename Raw<W * (int)sizeof(T)>::type;
  unsigned w[WORDS];
#pragma unroll
  for (int k = 0; k < WORDS; ++k) w[k] = 0u;
#pragma unroll
  for (int e = 0; e < W; ++e) w[e / E] |= narrow(p, y[e]) << (16 * (e % E));
  put(reinterpret_cast<R*>(p) + v, w);
}

// Body: a functor with `template <int W, int K> void step(long long v,
// long long stride, long long lim) const` that loads vectors v, v + stride,
// ..., v + (K - 1) x stride (those below lim) of every operand, W elements
// each, then computes and stores them; IN: the operands' element sizes
// summed.
template <class Body, int V, int IN>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    map_kernel(Body body, long long n, int vector_path) {
  constexpr int UV = unroll_for(V, IN), U1 = unroll_for(1, IN);
  const long long stride = (long long)gridDim.x * THREADS;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (vector_path) {
    const long long vectors = n / V;
    for (long long v = t; v < vectors; v += UV * stride)
      body.template step<V, UV>(v, stride, vectors);
    if (t < n - vectors * V) body.template step<1, 1>(vectors * V + t, 0, n);
  } else {
    for (long long v = t; v < n; v += U1 * stride) body.template step<1, U1>(v, stride, n);
  }
}

// Launch body over n elements; ptrs are every operand's base and the
// output's, V the elements of a 16-byte vector of the widest, IN the
// operands' element sizes summed.
template <class Body, int V, int IN>
inline int launch(const Body& body, void* const* ptrs, int nptrs, long long n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  uintptr_t bits = 0;
  for (int i = 0; i < nptrs; ++i) bits |= (uintptr_t)ptrs[i];
  const Plan p = plan(n, 16 / V, IN, (bits & 15u) == 0, lapis_sm_count());
  map_kernel<Body, V, IN><<<(unsigned)p.grid, p.threads, 0, (cudaStream_t)stream>>>(
      body, n, p.vec > 1);
  return (int)cudaGetLastError();
}

}  // namespace lapis_map

// The launch plan (the twin of kernels/generic.py::map_plan): vec, unroll,
// threads, grid, vectors, tail.
extern "C" int lapis_map_plan(long long n, int item, int in_bytes, int aligned, int sm_count,
                              long long* out) {
  if (n < 0 || (item != 2 && item != 4) || in_bytes < 2 || sm_count < 1)
    return (int)cudaErrorInvalidValue;
  const lapis_map::Plan p = lapis_map::plan(n, item, in_bytes, aligned != 0, sm_count);
  const long long v[6] = {p.vec, p.unroll, p.threads, p.grid, p.vectors, p.tail};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}
