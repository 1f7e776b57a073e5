// Element loads and stores in f32 for every element type the kernels
// take, and the card's SM count, shared by the hand-written kernels and
// the generated ones.
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float lapis_load(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float lapis_load(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float lapis_load(const __half* p, long i) {
  return __half2float(p[i]);
}
__device__ __forceinline__ void lapis_store(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void lapis_store(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16(v);
}
__device__ __forceinline__ void lapis_store(__half* p, long i, float v) {
  p[i] = __float2half(v);
}

// The current device's SM count, asked once per device (the launch plans
// size their grids by it).
inline int lapis_sm_count() {
  static int cached[64] = {0};
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < 64 && cached[dev]) return cached[dev];
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev >= 0 && dev < 64) cached[dev] = n;
  return n;
}
