// CSR SpMM on Hopper: Y = A·B with A in CSR (indptr, indices, values) and
// B dense (n_cols × n, row-major), f32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/spmm.py:spmm_ell
// (_spmm_kernel, pallas_call at spmm.py:57).  There the CSR matrix is
// padded to ELL, XLA builds an (n_rows, width, n) copy of the gathered B
// rows outside the kernel (spmm.py:42), and the kernel contracts the
// width axis of (row block × column block) tiles, accumulating across a
// sequential width grid axis.  Here the kernel reads CSR and gathers B's
// rows itself; the gathered copy of B never exists.
//
// Bound: the CSR bytes, B and Y over HBM bandwidth (2·nnz·n flops are far
// below the ridge).  In practice the B gather bounds it: every entry reads
// a B row segment (64 bytes at n = 16 f32), so nnz x that much passes from
// L2, or from HBM where B has been evicted, to the SMs.  So:
//  * a warp owns a row; a B row segment of up to `cols` columns is read by
//    `lanes` lanes with 16-byte loads (4 lanes of float4 at n = 16 f32),
//    and the warp's 32 / lanes groups each take a different entry;
//  * the row's columns and values are read once by the warp, 16-byte
//    loads aligned to the arrays' start (4 entries a lane; the last vector
//    of the arrays entry by entry), and dealt to the groups by
//    __shfl_sync: group g takes the entries of source lanes g, g + groups,
//    ... in order, component by component, so a lane issues the gathers of
//    a whole stream vector (4 entries; 8 entries on the scalar path)
//    before it accumulates: 32 B rows in flight a warp at n = 16;
//  * at the row's end the groups' partial sums meet in a fixed shuffle
//    tree (xor over lane offsets 16 ... lanes), so two calls give the
//    same bits; group 0 writes Y by 16-byte stores;
//  * B's gathers carry an L2 evict-last cache policy, the column and
//    value stream (evict-first in L1) and Y's stores an L2 evict-first
//    one, so the CSR stream, read once and ~6x B's size at PFlow_742 x
//    16, pushes B out of L2 less; no stream-wide state is set (no
//    access-policy window).
// On the H100 at PFlow_742 x 16, either policy set to evict-normal ran
// slower, and 2 or 4 stream vectors' gathers in flight a lane ran slower
// than 1 (bring-up timing); with B small enough to stay in L2 the kernel
// still moves 64 bytes of B an entry through L2 (kernel_ab.py times it).
// n off a multiple of the 16-byte vector, or a base of B, Y, the columns
// or the values off 16 bytes, takes the scalar path (vec = 1: a lane a
// column, one entry a stream load) in the same kernel family.  Columns
// beyond `cols` go to grid.y.  bf16 accumulates in f32 and rounds once.
//
// Tiling: `row_block` rows per thread block (the sparsify pass's tiling;
// any value runs): a block of min(row_block, 4) warps walks its rows, a
// warp a row at a time (4 warps ran faster than 8 at PFlow_742 x 16).
// The plan (plan below, twin kernels/spmm.py::spmm_plan, held equal on
// the card) gives the rest.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lapis_cuda.cuh"

namespace spmm {

constexpr int MAX_WARPS = 4;
constexpr unsigned FULL = 0xffffffffu;

struct Plan {
  int vec, lanes, groups, cols, unroll, threads;
  long long grid_rows, grid_cols;
};

inline Plan plan(long long n_rows, long long n, int row_block, int item, bool aligned) {
  const int v16 = 16 / item;
  const int vec = aligned && n % v16 == 0 ? v16 : 1;
  const long long want = (n + vec - 1) / vec;  // vectors of a row of Y
  int lanes = 1;
  while (lanes < want && lanes < 32) lanes *= 2;
  const int warps = row_block < MAX_WARPS ? row_block : MAX_WARPS;
  const int cols = lanes * vec;
  return {vec,         lanes,       32 / lanes, cols, vec > 1 ? 1 : 8, warps * 32,
          (n_rows + row_block - 1) / row_block, (n + cols - 1) / cols};
}

__device__ __forceinline__ uint64_t evict_last() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// The column / value stream: read once, first out of L1, under an L2
// evict-first policy.
#define LAPIS_LD_STREAM "ld.global.nc.L1::evict_first.L2::cache_hint"
__device__ __forceinline__ void stream(const int* p, int (&c)[4], uint64_t pol) {
  asm(LAPIS_LD_STREAM ".v4.s32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
      : "l"(p), "l"(pol));
}
__device__ __forceinline__ void stream(const int* p, int (&c)[1], uint64_t pol) {
  asm(LAPIS_LD_STREAM ".s32 %0, [%1], %2;" : "=r"(c[0]) : "l"(p), "l"(pol));
}
__device__ __forceinline__ void stream(const float* p, float (&w)[4], uint64_t pol) {
  asm(LAPIS_LD_STREAM ".v4.f32 {%0, %1, %2, %3}, [%4], %5;"
      : "=f"(w[0]), "=f"(w[1]), "=f"(w[2]), "=f"(w[3])
      : "l"(p), "l"(pol));
}
__device__ __forceinline__ void stream(const float* p, float (&w)[1], uint64_t pol) {
  asm(LAPIS_LD_STREAM ".f32 %0, [%1], %2;" : "=f"(w[0]) : "l"(p), "l"(pol));
}
__device__ __forceinline__ void stream(const __nv_bfloat16* p, float (&w)[4], uint64_t pol) {
  uint32_t a, b;
  asm(LAPIS_LD_STREAM ".v2.b32 {%0, %1}, [%2], %3;" : "=r"(a), "=r"(b) : "l"(p), "l"(pol));
  w[0] = __uint_as_float(a << 16), w[1] = __uint_as_float(a & 0xffff0000u);
  w[2] = __uint_as_float(b << 16), w[3] = __uint_as_float(b & 0xffff0000u);
}
__device__ __forceinline__ void stream(const __nv_bfloat16* p, float (&w)[1], uint64_t pol) {
  unsigned short v;
  asm(LAPIS_LD_STREAM ".b16 %0, [%1], %2;" : "=h"(v) : "l"(p), "l"(pol));
  w[0] = __uint_as_float((uint32_t)v << 16);
}

// V values of a B row (gathered on the read-only path, evict-last in L2)
// and of a Y row (stored).
template <typename T, int V>
struct Vec;

template <>
struct Vec<float, 4> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw gather(const float* p, uint64_t pol) {
    Raw r;
    asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
        : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
        : "l"(p), "l"(pol));
    return r;
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&b)[4]) {
    b[0] = __uint_as_float(r.x), b[1] = __uint_as_float(r.y);
    b[2] = __uint_as_float(r.z), b[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ void store(float* p, const float (&a)[4], uint64_t pol) {
    asm volatile("st.global.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, %5;" ::"l"(p),
                 "f"(a[0]), "f"(a[1]), "f"(a[2]), "f"(a[3]), "l"(pol)
                 : "memory");
  }
};

template <>
struct Vec<float, 1> {
  using Raw = uint32_t;
  static __device__ __forceinline__ Raw gather(const float* p, uint64_t pol) {
    Raw r;
    asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;" : "=r"(r) : "l"(p), "l"(pol));
    return r;
  }
  static __device__ __forceinline__ void unpack(Raw r, float (&b)[1]) { b[0] = __uint_as_float(r); }
  static __device__ __forceinline__ void store(float* p, const float (&a)[1], uint64_t pol) {
    asm volatile("st.global.L2::cache_hint.f32 [%0], %1, %2;" ::"l"(p), "f"(a[0]), "l"(pol)
                 : "memory");
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw gather(const __nv_bfloat16* p, uint64_t pol) {
    return Vec<float, 4>::gather(reinterpret_cast<const float*>(p), pol);
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&b)[8]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      b[2 * k] = __uint_as_float(w[k] << 16);
      b[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint32_t pack2(float a, float b) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&a)[8],
                                               uint64_t pol) {
    asm volatile("st.global.L2::cache_hint.v4.b32 [%0], {%1, %2, %3, %4}, %5;" ::"l"(p),
                 "r"(pack2(a[0], a[1])), "r"(pack2(a[2], a[3])), "r"(pack2(a[4], a[5])),
                 "r"(pack2(a[6], a[7])), "l"(pol)
                 : "memory");
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ Raw gather(const __nv_bfloat16* p, uint64_t pol) {
    Raw r;
    asm("ld.global.nc.L2::cache_hint.b16 %0, [%1], %2;" : "=h"(r) : "l"(p), "l"(pol));
    return r;
  }
  static __device__ __forceinline__ void unpack(Raw r, float (&b)[1]) {
    b[0] = __uint_as_float((uint32_t)r << 16);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&a)[1],
                                               uint64_t pol) {
    asm volatile("st.global.L2::cache_hint.b16 [%0], %1, %2;" ::"l"(p),
                 "h"(__bfloat16_as_ushort(__float2bfloat16_rn(a[0]))), "l"(pol)
                 : "memory");
  }
};

// L lanes a group (a B row segment of L x V columns), U steps' gathers in
// flight a lane.
template <typename T, int L, int V, int U>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    lapis_spmm_kernel(const int* __restrict__ indptr, const int* __restrict__ cols,
                      const T* __restrict__ vals, const T* __restrict__ B, T* __restrict__ Y,
                      int n_rows, int n, int row_block, long long nnz) {
  constexpr int G = 32 / L;         // groups a warp: entries gathered at once
  constexpr int E = V > 1 ? 4 : 1;  // entries a stream load holds
  using W = Vec<T, V>;
  const uint64_t keep = evict_last(), pass = evict_first();
  const int lane = threadIdx.x & 31, grp = lane / L;
  const long long c0 = ((long long)blockIdx.y * L + lane % L) * V;  // this lane's first column
  const bool on = c0 < n;  // all V columns: V divides n on the vector path
  const int warps = blockDim.x / 32;
  const long long first = (long long)blockIdx.x * row_block;
  for (int r = threadIdx.x / 32; r < row_block; r += warps) {
    const long long row = first + r;
    if (row >= n_rows) break;  // the whole warp
    const long long j0 = __ldg(indptr + row), j1 = __ldg(indptr + row + 1);
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
    const long long q1 = j1 > j0 ? (j1 - 1) / E : -1;  // the row's stream vectors q0..q1
    for (long long qb = j0 / E; qb <= q1; qb += 32) {
      const int live = (int)(q1 - qb + 1 < 32 ? q1 - qb + 1 : 32);  // the chunk's vectors
      const long long e0 = (qb + lane) * E;
      int c[E];
      float w[E];
      if (lane < live && (E == 1 || e0 + E <= nnz)) {
        stream(cols + e0, c, pass);
        stream(vals + e0, w, pass);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          c[e] = -1, w[e] = 0.f;
          if (lane < live && e0 + e < nnz) {  // the arrays' last vector
            int c1[1];
            float w1[1];
            stream(cols + e0 + e, c1, pass);
            stream(vals + e0 + e, w1, pass);
            c[e] = c1[0], w[e] = w1[0];
          }
        }
      }
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (e0 + e < j0 || e0 + e >= j1) c[e] = -1;  // outside the row
      for (int s0 = 0; s0 * G < live; s0 += U) {
        typename W::Raw g[U][E];
        float wv[U][E];
#pragma unroll
        for (int u = 0; u < U; ++u) {  // every gather first
          const int src = (s0 + u) * G + grp;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int cc = __shfl_sync(FULL, c[e], src & 31);
            const float ww = __shfl_sync(FULL, w[e], src & 31);
            const bool take = on && src < live && cc >= 0;
            wv[u][e] = take ? ww : 0.f;
            g[u][e] = take ? W::gather(B + (long long)cc * n + c0, keep) : typename W::Raw{};
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {  // then every product, in entry order
#pragma unroll
          for (int e = 0; e < E; ++e) {
            float b[V];
            W::unpack(g[u][e], b);
#pragma unroll
            for (int k = 0; k < V; ++k) acc[k] = fmaf(wv[u][e], b[k], acc[k]);
          }
        }
      }
    }
#pragma unroll
    for (int o = 16; o >= L; o >>= 1)  // the groups' sums: a fixed tree
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] += __shfl_xor_sync(FULL, acc[k], o);
    if (grp == 0 && on) W::store(Y + row * n + c0, acc, pass);
  }
}

template <typename T, int L, int V, int U>
static void start(const Plan& p, cudaStream_t s, const void* indptr, const void* cols,
                  const void* vals, const void* B, void* Y, int n_rows, int n, int row_block,
                  long long nnz) {
  auto kernel = lapis_spmm_kernel<T, L, V, U>;
  static bool carveout = false;  // the largest L1: the kernel has no shared memory
  if (!carveout) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 0);
    carveout = true;
  }
  kernel<<<dim3((unsigned)p.grid_rows, (unsigned)p.grid_cols), p.threads, 0, s>>>(
      (const int*)indptr, (const int*)cols, (const T*)vals, (const T*)B, (T*)Y, n_rows, n,
      row_block, nnz);
}

template <typename T, int V, int U>
static void dispatch(const Plan& p, cudaStream_t s, const void* indptr, const void* cols,
                     const void* vals, const void* B, void* Y, int n_rows, int n, int row_block,
                     long long nnz) {
  switch (p.lanes) {
    case 1: start<T, 1, V, U>(p, s, indptr, cols, vals, B, Y, n_rows, n, row_block, nnz); break;
    case 2: start<T, 2, V, U>(p, s, indptr, cols, vals, B, Y, n_rows, n, row_block, nnz); break;
    case 4: start<T, 4, V, U>(p, s, indptr, cols, vals, B, Y, n_rows, n, row_block, nnz); break;
    case 8: start<T, 8, V, U>(p, s, indptr, cols, vals, B, Y, n_rows, n, row_block, nnz); break;
    case 16: start<T, 16, V, U>(p, s, indptr, cols, vals, B, Y, n_rows, n, row_block, nnz); break;
    default: start<T, 32, V, U>(p, s, indptr, cols, vals, B, Y, n_rows, n, row_block, nnz); break;
  }
}

inline bool aligned(const void* cols, const void* vals, const void* B, const void* Y) {
  return (((uintptr_t)cols | (uintptr_t)vals | (uintptr_t)B | (uintptr_t)Y) & 15u) == 0;
}

template <typename T>
static int launch(const void* indptr, const void* cols, const void* vals, const void* B,
                  void* Y, int n_rows, int n, int row_block, long long nnz, void* stream) {
  if (row_block < 1 || n < 0 || n_rows < 0 || nnz < 0) return (int)cudaErrorInvalidValue;
  if (n_rows == 0 || n == 0) return 0;
  const Plan p = plan(n_rows, n, row_block, (int)sizeof(T), aligned(cols, vals, B, Y));
  if (p.grid_rows > 2147483647LL || p.grid_cols > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  constexpr int V16 = 16 / (int)sizeof(T);
  if (p.vec > 1)
    dispatch<T, V16, 1>(p, s, indptr, cols, vals, B, Y, n_rows, n, row_block, nnz);
  else
    dispatch<T, 1, 8>(p, s, indptr, cols, vals, B, Y, n_rows, n, row_block, nnz);
  return (int)cudaGetLastError();
}

}  // namespace spmm

extern "C" int lapis_spmm_f32(const void* indptr, const void* cols, const void* vals,
                              const void* B, void* Y, int n_rows, int n, int row_block,
                              long long nnz, void* stream) {
  return spmm::launch<float>(indptr, cols, vals, B, Y, n_rows, n, row_block, nnz, stream);
}

extern "C" int lapis_spmm_bf16(const void* indptr, const void* cols, const void* vals,
                               const void* B, void* Y, int n_rows, int n, int row_block,
                               long long nnz, void* stream) {
  return spmm::launch<__nv_bfloat16>(indptr, cols, vals, B, Y, n_rows, n, row_block, nnz,
                                     stream);
}

// The launch plan (the twin of kernels/spmm.py::spmm_plan): vec, lanes,
// groups, cols, unroll, threads, grid_rows, grid_cols.
extern "C" int lapis_spmm_plan(long long n_rows, long long n, int row_block, int item,
                               int aligned, long long* out) {
  if (n_rows < 0 || n < 0 || row_block < 1 || (item != 2 && item != 4))
    return (int)cudaErrorInvalidValue;
  const spmm::Plan p = spmm::plan(n_rows, n, row_block, item, aligned != 0);
  const long long v[8] = {p.vec, p.lanes, p.groups, p.cols, p.unroll, p.threads, p.grid_rows,
                          p.grid_cols};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}
