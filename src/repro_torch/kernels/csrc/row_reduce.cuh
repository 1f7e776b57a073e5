// Row reductions held in registers: the launch plan, the 16-byte vector
// loads and stores, and the warp and block reductions shared by RMSNorm
// (rmsnorm.cu) and the row softmax (row_softmax.cu).
//
// Both kernels reduce each row of a (rows, d) tensor to one or two f32
// scalars and then rescale the same row, so both are bound by reading
// the row and writing it back.  At a decode step's 4-8 rows that is a
// few microseconds of latency, not bandwidth: what counts is how many
// dependent memory round trips a row costs.  On the register path every
// thread issues all of its 16-byte loads (8 bf16 or 4 f32 values each,
// on the read-only path) before it uses one, keeps the values in
// registers, reduces, and writes the result from those registers by
// 16-byte stores: one round trip per row, and no second read.
//
// plan (exported by each library; its twin is kernels/row_reduce.py::
// row_plan, held to it on the card) picks the work split from the row
// count, the width and the card:
//
// * "warp": many rows (the grid of several rows a block fills every
//   SM): a row on one warp (on 2-8 warps where its vectors would exceed
//   MAX_VPT a thread), ROWS_THREADS threads a block, each reduction by
//   shuffles (plus one shared-memory exchange when a row spans warps);
// * "block": few rows (a decode step): one block a row, its threads
//   holding ceil(vectors / ROW_THREADS) vectors each (one or two at the
//   served bf16 widths), each reduction by shuffles plus one
//   shared-memory exchange;
// * "general": a width off a multiple of the vector, a base off 16-byte
//   alignment, a width above the register instances (or, for the
//   softmax, above SOFTMAX_MAX_COLS): one block a row, a block-stride loop
//   of scalar loads, the same reductions.
//
// A thread holds vectors t, t + tpr, t + 2·tpr, ... of its row (tpr:
// threads a row), so neighbouring threads load neighbouring 16 bytes.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace row_reduce {

constexpr int MAX_VPT = 8;            // register instances: 1..8 vectors a thread
constexpr int ROWS_THREADS = 256;     // a "warp" block: its rows share it
constexpr int ROW_THREADS = 256;      // most threads a "block" row takes
constexpr int GENERAL_THREADS = 256;  // most threads a "general" row takes
constexpr int SOFTMAX_MAX_COLS = 1024;
constexpr int GENERAL = 0, WARP = 1, BLOCK = 2;

struct Plan {
  int path, vec, vpt, tpr, rows_per_block, threads;
  long long grid;
};

__host__ __device__ constexpr long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// max_d: the widest row the register path takes (0: no limit but MAX_VPT).
inline Plan plan(long long rows, int d, int item, bool aligned, int sm_count, int max_d) {
  const int vec = 16 / item;
  if (aligned && d > 0 && d % vec == 0 && (max_d <= 0 || d <= max_d)) {
    const int nvec = d / vec;
    int tpr = 32;
    while (cdiv(nvec, tpr) > MAX_VPT && tpr < ROWS_THREADS) tpr *= 2;
    if (cdiv(nvec, tpr) <= MAX_VPT) {
      const int rpb = ROWS_THREADS / tpr;
      const long long blocks = cdiv(rows, rpb);
      if (blocks >= sm_count)
        return {WARP, vec, (int)cdiv(nvec, tpr), tpr, rpb, ROWS_THREADS, blocks};
    }
    const int vpt = (int)cdiv(nvec, ROW_THREADS);
    if (vpt <= MAX_VPT) {
      const int t = (int)cdiv(cdiv(nvec, vpt), 32) * 32;
      return {BLOCK, vec, vpt, t, 1, t, rows};
    }
  }
  const long long t = cdiv(d > 0 ? d : 1, 32) * 32;
  const int threads = (int)(t < GENERAL_THREADS ? t : GENERAL_THREADS);
  return {GENERAL, 1, 0, threads, 1, threads, rows};
}

// The plan as the exported lapis_*_plan functions write it.
inline int write_plan(const Plan& p, long long* out) {
  const long long v[7] = {p.path, p.vec, p.vpt, p.tpr, p.rows_per_block, p.threads, p.grid};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

inline bool aligned16(const void* a, const void* b, const void* c) {
  return (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) & 15u) == 0;
}

// 16 bytes of T as f32 values and back (bf16: exact widening, one
// round-to-nearest-even narrowing, as torch's .to(bfloat16)).
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&v)[N]) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[N]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&v)[N]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint32_t pack2(float a, float b) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[N]) {
    return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                      pack2(v[6], v[7]));
  }
};

// One 16-byte load on the read-only (non-coherent) path, or zeros.
__device__ __forceinline__ uint4 load16(const uint4* p, bool in) {
  return in ? __ldg(p) : make_uint4(0u, 0u, 0u, 0u);
}

// The sum (kMax: the max) over a row's tpr threads (a multiple of 32;
// the row's warps consecutive in the block): shuffles, then, where the
// row spans warps, one exchange through shared memory in a fixed order.
// Every thread of the block calls it (it syncs the block when tpr > 32);
// every thread of the row gets the same bits.  red holds a value a warp;
// a second reduction in the same kernel takes another buffer.
template <bool kMax>
__device__ __forceinline__ float row_reduce(float v, int tpr, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, u) : v + u;
  }
  if (tpr > 32) {
    const int warp = threadIdx.x / 32, wpr = tpr / 32, first = warp - warp % wpr;
    if ((threadIdx.x & 31) == 0) red[warp] = v;
    __syncthreads();
    v = red[first];
    for (int k = 1; k < wpr; ++k) v = kMax ? fmaxf(v, red[first + k]) : v + red[first + k];
  }
  return v;
}

__device__ __forceinline__ float row_sum(float v, int tpr, float* red) {
  return row_reduce<false>(v, tpr, red);
}
__device__ __forceinline__ float row_max(float v, int tpr, float* red) {
  return row_reduce<true>(v, tpr, red);
}

// Call f(std::integral_constant<int, vpt>{}) for vpt in 1..MAX_VPT: f
// launches the register kernel's instance for that many vectors a thread.
template <int V = 1, typename F>
inline void dispatch_vpt(int vpt, F&& f) {
  if constexpr (V < MAX_VPT) {
    if (vpt != V) return dispatch_vpt<V + 1>(vpt, f);
  }
  f(std::integral_constant<int, V>{});
}

}  // namespace row_reduce
