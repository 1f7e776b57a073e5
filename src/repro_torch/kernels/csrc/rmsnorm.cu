// Fused RMSNorm on Hopper: out[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * w
// for rows of width D (w in x's type), computed in f32 and written in x's type.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py:rmsnorm
// (_rmsnorm_kernel, pallas_call at rmsnorm.py:39).  There a grid step holds
// a (256, D) row block in VMEM and reduces along the lane axis.  Here one
// warp owns one row: its lanes stride over D (neighbouring lanes on
// neighbouring elements, so every load is coalesced), sum the squares in
// f32, reduce with shuffles, and make a second pass over the row (now in
// L1) to scale and store.  Rows are independent, so a block of 8 warps
// takes 8 rows and the grid covers the rest: a decode step's handful of
// rows and a prefill's thousands take the same path.
//
// Bound: bytes — one read of x, one write of out, one read of w over HBM
// bandwidth; the work is ~4 operations per element.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lapis_cuda.cuh"

constexpr int RMS_WARPS = 8;

template <typename T>
__global__ void lapis_rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                     T* __restrict__ out, long rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * RMS_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = lapis_load(xr, i);
    ss += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float inv = rsqrtf(ss / (float)d + eps);
  for (int i = lane; i < d; i += 32)
    lapis_store(orow, i, lapis_load(xr, i) * inv * lapis_load(w, i));
}

template <typename T>
static int launch(const void* x, const void* w, void* out, long rows, int d, float eps,
                  void* stream) {
  if (rows < 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const long blocks = (rows + RMS_WARPS - 1) / RMS_WARPS;
  if (blocks > 2147483647L) return (int)cudaErrorInvalidValue;
  lapis_rmsnorm_kernel<T><<<(unsigned)blocks, RMS_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w, (T*)out, rows, d, eps);
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
