// Row softmax on Hopper: y = exp(x - max(x)) / sum(exp(x - max(x))) over
// the last axis, for the kind='reduce' kokkos.* nests (softmax only; the
// linalg_to_parallel pass admits rows of at most 1024 elements).
//
// Replaces the TPU kernel src/repro/kernels/generic.py:block_map when its
// body is the softmax reference (pallas_call at generic.py:50): there a
// VMEM block holds whole rows and the vectorized body reduces each row.
// Here one thread block owns one row: a block-wide max, then a block-wide
// sum of exponentials, both as warp shuffles plus one shared-memory
// exchange between warps, with all arithmetic in f32.  The row is read
// three times but from L1/L2 after the first pass, so the bound is one
// read and one write of the tensor over HBM bandwidth; at the mlp demo's
// (8, 10) it is launch-bound.
#include <cuda_runtime.h>
#include <math.h>

#include "lapis_cuda.cuh"

template <bool kMax>
__device__ __forceinline__ float lapis_block_reduce(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_warps = (blockDim.x + 31) / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, w) : v + w;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < n_warps ? red[lane] : (kMax ? -INFINITY : 0.0f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float w = __shfl_xor_sync(0xffffffffu, v, o);
      v = kMax ? fmaxf(v, w) : v + w;
    }
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  v = red[0];
  __syncthreads();  // red is reused by the next reduction
  return v;
}

template <typename T>
__global__ void lapis_row_softmax_kernel(const T* __restrict__ x,
                                         T* __restrict__ y, long rows,
                                         int cols) {
  __shared__ float red[32];
  for (long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * cols;
    T* yr = y + row * cols;
    float m = -INFINITY;
    for (int c = threadIdx.x; c < cols; c += blockDim.x) m = fmaxf(m, lapis_load(xr, c));
    m = lapis_block_reduce<true>(m, red);
    float s = 0.0f;
    for (int c = threadIdx.x; c < cols; c += blockDim.x) s += expf(lapis_load(xr, c) - m);
    s = lapis_block_reduce<false>(s, red);
    const float inv = 1.0f / s;
    for (int c = threadIdx.x; c < cols; c += blockDim.x)
      lapis_store(yr, c, expf(lapis_load(xr, c) - m) * inv);
  }
}

template <typename T>
static int lapis_row_softmax_launch(const void* x, void* y, long rows, int cols,
                                    void* stream) {
  if (rows == 0 || cols == 0) return 0;
  int threads = (cols + 31) / 32 * 32;
  threads = threads > 256 ? 256 : threads;
  const unsigned grid = (unsigned)(rows < 2147483647L ? rows : 2147483647L);
  lapis_row_softmax_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (T*)y, rows, cols);
  return (int)cudaGetLastError();
}

extern "C" int lapis_row_softmax_f32(const void* x, void* y, long rows, int cols,
                                     void* stream) {
  return lapis_row_softmax_launch<float>(x, y, rows, cols, stream);
}

extern "C" int lapis_row_softmax_bf16(const void* x, void* y, long rows, int cols,
                                      void* stream) {
  return lapis_row_softmax_launch<__nv_bfloat16>(x, y, rows, cols, stream);
}
