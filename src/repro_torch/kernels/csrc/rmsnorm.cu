// Fused RMSNorm on Hopper: out[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * w
// for rows of width D (w in x's type), computed in f32 and written once,
// rounded, in x's type.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py:rmsnorm
// (_rmsnorm_kernel, pallas_call at rmsnorm.py:39).  There a grid step holds
// a (256, D) row block in VMEM and reduces along the lane axis.  Here a row
// is read once into registers (row_reduce.cuh): each thread issues all of
// its 16-byte loads of x and of w before it uses one, sums the squares of
// its values in f32, the row's threads reduce (shuffles, and one
// shared-memory exchange where a row spans warps), and each thread scales
// the values it holds and writes them by 16-byte stores.  The plan
// (row_reduce::plan) gives a prefill's thousands of rows a warp each,
// several rows a block, and a decode step's handful a block each, so the
// few rows spread over as many SMs.  Widths the vectors cannot take (D off
// a multiple of 8 bf16 / 4 f32 values, an unaligned base, D above the
// register instances) run lapis_rmsnorm_general: a block a row, a
// block-stride loop of scalar loads, the same reduction, a second pass
// over the row (from L1) to scale.
//
// Bound: bytes — one read of x, one write of out, one read of w over HBM
// bandwidth; the work is ~4 operations per element.  At a decode step's
// 4-8 rows (24-64 KB) the call is latency: one memory round trip a row.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lapis_cuda.cuh"
#include "row_reduce.cuh"

template <typename T, int VPT>
__global__ void __launch_bounds__(256)
    lapis_rmsnorm_vec(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                      long rows, int d, int tpr, float eps) {
  using V = row_reduce::Vec16<T>;
  constexpr int N = V::N;
  __shared__ float red[32];
  const int nvec = d / N;
  const int t = threadIdx.x % tpr;
  const long row = (long)blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool live = row < rows;
  const uint4* xr = reinterpret_cast<const uint4*>(x) + (live ? row : 0L) * nvec;
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  uint4 xv[VPT], wv[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = t + j * tpr;
    xv[j] = row_reduce::load16(xr + i, live && i < nvec);
    wv[j] = row_reduce::load16(wr + i, live && i < nvec);
  }
  float part[N];
#pragma unroll
  for (int k = 0; k < N; ++k) part[k] = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    float v[N];
    V::unpack(xv[j], v);
#pragma unroll
    for (int k = 0; k < N; ++k) part[k] += v[k] * v[k];
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) ss += part[k];
  ss = row_reduce::row_sum(ss, tpr, red);
  const float inv = rsqrtf(ss / (float)d + eps);
  if (!live) return;
  uint4* orow = reinterpret_cast<uint4*>(out) + row * nvec;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = t + j * tpr;
    if (i < nvec) {
      float v[N], g[N];
      V::unpack(xv[j], v);
      V::unpack(wv[j], g);
#pragma unroll
      for (int k = 0; k < N; ++k) v[k] = v[k] * inv * g[k];
      orow[i] = V::pack(v);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
    lapis_rmsnorm_general(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                          long rows, int d, float eps) {
  __shared__ float red[32];
  for (long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * d;
    T* orow = out + row * d;
    float ss = 0.f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float v = lapis_load(xr, i);
      ss += v * v;
    }
    ss = row_reduce::row_sum(ss, blockDim.x, red);
    const float inv = rsqrtf(ss / (float)d + eps);
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      lapis_store(orow, i, lapis_load(xr, i) * inv * lapis_load(w, i));
    if (blockDim.x > 32) __syncthreads();  // red is written again for the next row
  }
}

static row_reduce::Plan rms_plan(long rows, int d, int item, bool aligned, int sm_count) {
  return row_reduce::plan(rows, d, item, aligned, sm_count, 0);
}

template <typename T>
static int launch(const void* x, const void* w, void* out, long rows, int d, float eps,
                  void* stream) {
  if (rows < 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const row_reduce::Plan p = rms_plan(rows, d, (int)sizeof(T),
                                      row_reduce::aligned16(x, w, out), lapis_sm_count());
  const cudaStream_t st = (cudaStream_t)stream;
  if (p.path == row_reduce::GENERAL) {
    const unsigned grid = (unsigned)(rows < 2147483647L ? rows : 2147483647L);
    lapis_rmsnorm_general<T><<<grid, p.threads, 0, st>>>((const T*)x, (const T*)w, (T*)out,
                                                        rows, d, eps);
  } else {
    if (p.grid > 2147483647LL) return (int)cudaErrorInvalidValue;
    row_reduce::dispatch_vpt(p.vpt, [&](auto vpt) {
      lapis_rmsnorm_vec<T, decltype(vpt)::value><<<(unsigned)p.grid, p.threads, 0, st>>>(
          (const T*)x, (const T*)w, (T*)out, rows, d, p.tpr, eps);
    });
  }
  return (int)cudaGetLastError();
}

extern "C" int lapis_rmsnorm_f32(const void* x, const void* w, void* out, long rows, int d,
                                 float eps, void* stream) {
  return launch<float>(x, w, out, rows, d, eps, stream);
}
extern "C" int lapis_rmsnorm_bf16(const void* x, const void* w, void* out, long rows, int d,
                                  float eps, void* stream) {
  return launch<__nv_bfloat16>(x, w, out, rows, d, eps, stream);
}
// The launch plan for rows x d of item-byte values (the twin of
// kernels/rmsnorm.py::rms_plan): path, vec, vpt, tpr, rows_per_block,
// threads, grid.
extern "C" int lapis_rmsnorm_plan(long rows, int d, int item, int aligned, int sm_count,
                                  long long* out) {
  if (rows < 0 || d <= 0 || (item != 2 && item != 4) || sm_count < 1)
    return (int)cudaErrorInvalidValue;
  return row_reduce::write_plan(rms_plan(rows, d, item, aligned != 0, sm_count), out);
}
