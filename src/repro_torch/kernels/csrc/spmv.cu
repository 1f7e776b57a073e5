// CSR SpMV on Hopper: y = A·x with A in CSR (indptr, indices, values),
// f32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/spmv.py:spmv_ell
// (_spmv_kernel, pallas_call at spmv.py:121).  A TPU has no warps, so
// there the CSR matrix is converted to padded ELL whose row width is the
// lane axis, XLA gathers x[cols] outside the kernel, and the kernel
// multiplies and row-reduces regular tiles, carrying the sum across a
// sequential width axis.  Hopper has warps, so this is the paper's own
// GPU form (§6.2): row-parallel teams, each row owned by a group of lanes
// that run a vector loop over the row's entries, gather x[col] inside,
// accumulate in f32 and reduce with warp shuffles.  The kernel reads CSR
// directly: no ELL conversion per call, and no padding bytes (ELL's width
// 192 against a mean of 14.34 on StocF-1465 would read about 13× the CSR
// bytes).
//
// Bound: the bytes of the CSR arrays, x and y over HBM bandwidth (2 flops
// per 8-12 bytes is far below the ridge).  In practice the x gather bounds
// it: with scattered columns each x[col] costs a 32-byte L2 sector for 4
// useful bytes (chip_smoke.py times x.index_select(0, cols) alone beside
// the kernel as the practical ceiling), and each lane's gathers wait on
// its column loads.  So:
//  * cols and vals are read once: 16-byte loads (4 entries a lane) on the
//    read-only path, marked evict-first in L1;
//  * x is gathered on the read-only path marked evict-last in L2
//    (createpolicy + L2::cache_hint), and the kernel asks for the largest
//    L1 (it uses no shared memory);
//  * a lane loads the columns and values of UNROLL vectors before its
//    first gather, so UNROLL x 4 gathers are in flight at once, not one;
//  * no stream-wide state is set (no access-policy window): the policies
//    ride on each load.
// On the H100, cols and vals run slower with L1::no_allocate or an L2
// evict-first policy than with L1 evict-first, and the evict-last policy
// on x is neither faster nor slower (x's 2.6-5.9 MB stay in the 50 MB L2
// under the default policy too).
// A row [j0, j1) is walked in 4-entry vectors aligned to the arrays'
// start; a vector that reaches outside the row is masked entry by entry,
// and the last vector of the arrays, where it would run past nnz, is read
// entry by entry.  Bases off 16-byte alignment take vec = 1 (scalar
// loads, the same policies) in the same kernel.
//
// Tiling (the sparsify pass's choose_spmv_tiling, unchanged): `row_block`
// rows per thread block, `row_width` entries of a row per iteration.  The
// plan (spmv_plan below, twin kernels/spmv.py::spmv_plan, held equal on
// the card) gives a row G = the next power of two >= row_width / vec lanes
// (2 x row_width / vec where row_width is the warp's 32: rows of 25+
// entries on average take 16 lanes of 4 entries), so groups never
// straddle a warp and the shuffle reduction runs within G lanes; a block
// of at most 256 threads loops over its rows.  The loop bound is the same
// for every thread, so all 32 lanes of a warp reach every shuffle even
// where a group's row lies past the block or the matrix.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lapis_cuda.cuh"

namespace spmv {

constexpr int MAX_THREADS = 256;
constexpr int VEC = 4;          // entries a 16-byte load of cols holds

struct Plan {
  int vec, lanes, unroll, groups, threads;
  long long grid;
};

inline Plan plan(long long n_rows, int row_block, int row_width, bool aligned) {
  const int vec = aligned ? VEC : 1;
  // a row as wide as the warp (rows of 25+ entries) walks 2 x row_width a
  // lane-group iteration: 16 lanes of 4 entries
  const int per_lane = ((row_width >= 32 ? 2 : 1) * row_width + vec - 1) / vec;
  int lanes = 1;
  while (lanes < per_lane && lanes < 32) lanes *= 2;
  const int unroll = vec > 1 ? 2 : 4;
  const long long want = (long long)row_block * lanes;
  const int threads = (int)((want < MAX_THREADS ? want : MAX_THREADS) + 31) / 32 * 32;
  return {vec, lanes, unroll, threads / lanes, threads, (n_rows + row_block - 1) / row_block};
}

__device__ __forceinline__ uint64_t evict_last() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// Streaming loads of cols and vals: read once, first out of L1.
__device__ __forceinline__ int4 stream4(const int* p) {
  int4 v;
  asm("ld.global.nc.L1::evict_first.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}
__device__ __forceinline__ int stream1(const int* p) {
  int v;
  asm("ld.global.nc.L1::evict_first.s32 %0, [%1];"
      : "=r"(v)
      : "l"(p));
  return v;
}
__device__ __forceinline__ void stream_vals(const float* p, float (&v)[VEC]) {
  asm("ld.global.nc.L1::evict_first.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
      : "l"(p));
}
__device__ __forceinline__ void stream_vals(const __nv_bfloat16* p, float (&v)[VEC]) {
  uint32_t a, b;
  asm("ld.global.nc.L1::evict_first.v2.b32 {%0, %1}, [%2];"
      : "=r"(a), "=r"(b)
      : "l"(p));
  v[0] = __uint_as_float(a << 16), v[1] = __uint_as_float(a & 0xffff0000u);
  v[2] = __uint_as_float(b << 16), v[3] = __uint_as_float(b & 0xffff0000u);
}
__device__ __forceinline__ float stream_val(const float* p) {
  float v;
  asm("ld.global.nc.L1::evict_first.f32 %0, [%1];"
      : "=f"(v)
      : "l"(p));
  return v;
}
__device__ __forceinline__ float stream_val(const __nv_bfloat16* p) {
  unsigned short v;
  asm("ld.global.nc.L1::evict_first.b16 %0, [%1];"
      : "=h"(v)
      : "l"(p));
  return __uint_as_float((uint32_t)v << 16);
}

// The x gather: read-only path, evict-last in L2.
__device__ __forceinline__ float gather(const float* p, uint64_t pol) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ float gather(const __nv_bfloat16* p, uint64_t pol) {
  unsigned short v;
  asm("ld.global.nc.L2::cache_hint.b16 %0, [%1], %2;" : "=h"(v) : "l"(p), "l"(pol));
  return __uint_as_float((uint32_t)v << 16);
}

template <typename T, int G, int V, int U>
__global__ void __launch_bounds__(MAX_THREADS)
lapis_spmv_kernel(const int* __restrict__ indptr, const int* __restrict__ cols,
                  const T* __restrict__ vals, const T* __restrict__ x, T* __restrict__ y,
                  int n_rows, int row_block, long long nnz) {
  const uint64_t pol_x = evict_last();
  const int lane = threadIdx.x % G;
  const int groups = blockDim.x / G;
  const long long first = (long long)blockIdx.x * row_block;
  for (int base = 0; base < row_block; base += groups) {
    const int r = base + (int)threadIdx.x / G;
    const long long row = first + r;
    const bool active = r < row_block && row < n_rows;
    float acc = 0.0f;
    if (active) {
      const long long j0 = __ldg(indptr + row), j1 = __ldg(indptr + row + 1);
      if (j1 > j0) {
        const long long q1 = (j1 - 1) / V;     // the row's vectors q0..q1
        for (long long q = j0 / V + lane; q <= q1; q += (long long)G * U) {
          int c[U][V];
          float w[U][V];
#pragma unroll
          for (int k = 0; k < U; ++k) {        // every column and value first
            const long long qq = q + (long long)k * G, e0 = qq * V;
            if (qq > q1) {
#pragma unroll
              for (int e = 0; e < V; ++e) c[k][e] = -1, w[k][e] = 0.f;
            } else if (V > 1 && e0 + V <= nnz) {
              if constexpr (V > 1) {
                const int4 cv = stream4(cols + e0);
                c[k][0] = cv.x, c[k][1] = cv.y, c[k][2] = cv.z, c[k][3] = cv.w;
                stream_vals(vals + e0, w[k]);
              }
            } else {
#pragma unroll
              for (int e = 0; e < V; ++e) {
                const bool in = e0 + e < nnz;
                c[k][e] = in ? stream1(cols + e0 + e) : -1;
                w[k][e] = in ? stream_val(vals + e0 + e) : 0.f;
              }
            }
          }
#pragma unroll
          for (int k = 0; k < U; ++k) {        // then every gather
            const long long e0 = (q + (long long)k * G) * V;
#pragma unroll
            for (int e = 0; e < V; ++e) {
              if (e0 + e >= j0 && e0 + e < j1 && c[k][e] >= 0)
                acc = fmaf(w[k][e], gather(x + c[k][e], pol_x), acc);
            }
          }
        }
      }
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o, G);
    if (active && lane == 0) lapis_store(y, row, acc);
  }
}

template <typename T, int G, int V, int U>
static void start(const Plan& p, cudaStream_t s, const void* indptr, const void* cols,
                  const void* vals, const void* x, void* y, int n_rows, int row_block,
                  long long nnz) {
  auto kernel = lapis_spmv_kernel<T, G, V, U>;
  static bool carveout = false;   // the largest L1: the kernel has no shared memory
  if (!carveout) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 0);
    carveout = true;
  }
  kernel<<<(unsigned)p.grid, p.threads, 0, s>>>((const int*)indptr, (const int*)cols,
                                                (const T*)vals, (const T*)x, (T*)y, n_rows,
                                                row_block, nnz);
}

template <typename T, int V, int U>
static void dispatch(const Plan& p, cudaStream_t s, const void* indptr, const void* cols,
                     const void* vals, const void* x, void* y, int n_rows, int row_block,
                     long long nnz) {
  switch (p.lanes) {
    case 1: start<T, 1, V, U>(p, s, indptr, cols, vals, x, y, n_rows, row_block, nnz); break;
    case 2: start<T, 2, V, U>(p, s, indptr, cols, vals, x, y, n_rows, row_block, nnz); break;
    case 4: start<T, 4, V, U>(p, s, indptr, cols, vals, x, y, n_rows, row_block, nnz); break;
    case 8: start<T, 8, V, U>(p, s, indptr, cols, vals, x, y, n_rows, row_block, nnz); break;
    case 16: start<T, 16, V, U>(p, s, indptr, cols, vals, x, y, n_rows, row_block, nnz); break;
    default: start<T, 32, V, U>(p, s, indptr, cols, vals, x, y, n_rows, row_block, nnz); break;
  }
}

inline bool aligned(const void* cols, const void* vals, int item) {
  return ((uintptr_t)cols % 16) == 0 && ((uintptr_t)vals % (VEC * item)) == 0;
}

template <typename T>
static int launch(const void* indptr, const void* cols, const void* vals, const void* x,
                  void* y, int n_rows, int row_block, int row_width, long long nnz,
                  void* stream) {
  if (row_block < 1 || row_width < 1 || row_width > 32 || n_rows < 0 || nnz < 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  const Plan p = plan(n_rows, row_block, row_width, aligned(cols, vals, (int)sizeof(T)));
  if (p.grid > 2147483647LL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (p.vec > 1)
    dispatch<T, VEC, 2>(p, s, indptr, cols, vals, x, y, n_rows, row_block, nnz);
  else
    dispatch<T, 1, 4>(p, s, indptr, cols, vals, x, y, n_rows, row_block, nnz);
  return (int)cudaGetLastError();
}

}  // namespace spmv

extern "C" int lapis_spmv_f32(const void* indptr, const void* cols, const void* vals,
                              const void* x, void* y, int n_rows, int row_block,
                              int row_width, long long nnz, void* stream) {
  return spmv::launch<float>(indptr, cols, vals, x, y, n_rows, row_block, row_width, nnz,
                             stream);
}

extern "C" int lapis_spmv_bf16(const void* indptr, const void* cols, const void* vals,
                               const void* x, void* y, int n_rows, int row_block,
                               int row_width, long long nnz, void* stream) {
  return spmv::launch<__nv_bfloat16>(indptr, cols, vals, x, y, n_rows, row_block, row_width,
                                     nnz, stream);
}

// The launch plan (the twin of kernels/spmv.py::spmv_plan): vec, lanes,
// unroll, groups, threads, grid.
extern "C" int lapis_spmv_plan(long long n_rows, int row_block, int row_width, int aligned,
                               long long* out) {
  if (n_rows < 0 || row_block < 1 || row_width < 1 || row_width > 32)
    return (int)cudaErrorInvalidValue;
  const spmv::Plan p = spmv::plan(n_rows, row_block, row_width, aligned != 0);
  const long long v[6] = {p.vec, p.lanes, p.unroll, p.groups, p.threads, p.grid};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}
