// Row softmax on Hopper: y = exp(x - max(x)) / sum(exp(x - max(x))) over
// the last axis, for the kind='reduce' kokkos.* nests (softmax only; the
// linalg_to_parallel pass admits rows of at most 1024 elements), all
// arithmetic in f32 and one rounding to y's type.
//
// Replaces the TPU kernel src/repro/kernels/generic.py:block_map when its
// body is the softmax reference (pallas_call at generic.py:50): there a
// VMEM block holds whole rows and the vectorized body reduces each row.
// Here a row is read once into registers (row_reduce.cuh): each thread
// issues all of its 16-byte loads, the row's threads reduce the max
// (shuffles, and a shared-memory exchange where a row spans warps), each
// thread computes e = exp(x - max) of its values once and keeps them, the
// row reduces the sum the same way, and each thread writes e / sum by
// 16-byte stores.  The plan gives many rows a warp each (a 1024-wide f32
// row is 8 vectors a lane) and few rows a block each (ResNet18's 8 x
// 1000).  Rows the vectors cannot take (a width off a multiple of 4 f32 /
// 8 bf16 values, as the mlp demo's 10 classes, an unaligned base, or wider
// than SOFTMAX_MAX_COLS, which only a direct call can give) run
// lapis_softmax_general: a block a row, a block-stride loop whose first
// 4 x blockDim values stay in registers, the same two reductions.
//
// Bound: bytes — one read and one write of the tensor over HBM bandwidth;
// at the mlp demo's (8, 10) and ResNet18's (8, 1000) it is launch-bound.
#include <cuda_runtime.h>
#include <math.h>

#include "lapis_cuda.cuh"
#include "row_reduce.cuh"

template <typename T, int VPT>
__global__ void __launch_bounds__(256)
    lapis_softmax_vec(const T* __restrict__ x, T* __restrict__ y, long rows, int cols, int tpr) {
  using V = row_reduce::Vec16<T>;
  constexpr int N = V::N;
  __shared__ float red_m[32], red_s[32];
  const int nvec = cols / N;
  const int t = threadIdx.x % tpr;
  const long row = (long)blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool live = row < rows;
  const uint4* xr = reinterpret_cast<const uint4*>(x) + (live ? row : 0L) * nvec;
  uint4 xv[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j)
    xv[j] = row_reduce::load16(xr + t + j * tpr, live && t + j * tpr < nvec);
  float v[VPT][N];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    V::unpack(xv[j], v[j]);
    if (live && t + j * tpr < nvec) {
#pragma unroll
      for (int k = 0; k < N; ++k) m = fmaxf(m, v[j][k]);
    }
  }
  m = row_reduce::row_max(m, tpr, red_m);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const bool in = live && t + j * tpr < nvec;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      v[j][k] = in ? expf(v[j][k] - m) : 0.f;
      s += v[j][k];
    }
  }
  s = row_reduce::row_sum(s, tpr, red_s);
  if (!live) return;
  const float inv = 1.0f / s;
  uint4* yr = reinterpret_cast<uint4*>(y) + row * nvec;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = t + j * tpr;
    if (i < nvec) {
#pragma unroll
      for (int k = 0; k < N; ++k) v[j][k] *= inv;
      yr[i] = V::pack(v[j]);
    }
  }
}

// The general path holds the first HELD · blockDim values of a row in
// registers (every row the pass admits: 1024 = 4 x 256) and reads the
// rest of a wider row again for the sum and the write.
constexpr int HELD = 4;

template <typename T>
__global__ void __launch_bounds__(256)
    lapis_softmax_general(const T* __restrict__ x, T* __restrict__ y, long rows, int cols) {
  __shared__ float red_m[32], red_s[32];
  const int bd = blockDim.x, rest = HELD * blockDim.x;
  for (long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * cols;
    T* yr = y + row * cols;
    float v[HELD];
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < HELD; ++k) {
      const int c = threadIdx.x + k * bd;
      v[k] = c < cols ? lapis_load(xr, c) : -INFINITY;
      m = fmaxf(m, v[k]);
    }
    for (int c = threadIdx.x + rest; c < cols; c += bd) m = fmaxf(m, lapis_load(xr, c));
    m = row_reduce::row_max(m, bd, red_m);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < HELD; ++k) {
      v[k] = threadIdx.x + k * bd < cols ? expf(v[k] - m) : 0.f;
      s += v[k];
    }
    for (int c = threadIdx.x + rest; c < cols; c += bd) s += expf(lapis_load(xr, c) - m);
    s = row_reduce::row_sum(s, bd, red_s);
    const float inv = 1.0f / s;
#pragma unroll
    for (int k = 0; k < HELD; ++k) {
      const int c = threadIdx.x + k * bd;
      if (c < cols) lapis_store(yr, c, v[k] * inv);
    }
    for (int c = threadIdx.x + rest; c < cols; c += bd)
      lapis_store(yr, c, expf(lapis_load(xr, c) - m) * inv);
    if (bd > 32) __syncthreads();  // red_m / red_s are written again for the next row
  }
}

static row_reduce::Plan softmax_plan(long rows, int cols, int item, bool aligned, int sm_count) {
  return row_reduce::plan(rows, cols, item, aligned, sm_count, row_reduce::SOFTMAX_MAX_COLS);
}

template <typename T>
static int lapis_row_softmax_launch(const void* x, void* y, long rows, int cols, void* stream) {
  if (rows < 0 || cols < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return 0;
  const row_reduce::Plan p = softmax_plan(rows, cols, (int)sizeof(T),
                                          row_reduce::aligned16(x, y, y), lapis_sm_count());
  const cudaStream_t st = (cudaStream_t)stream;
  if (p.path == row_reduce::GENERAL) {
    const unsigned grid = (unsigned)(rows < 2147483647L ? rows : 2147483647L);
    lapis_softmax_general<T><<<grid, p.threads, 0, st>>>((const T*)x, (T*)y, rows, cols);
  } else {
    if (p.grid > 2147483647LL) return (int)cudaErrorInvalidValue;
    row_reduce::dispatch_vpt(p.vpt, [&](auto vpt) {
      lapis_softmax_vec<T, decltype(vpt)::value><<<(unsigned)p.grid, p.threads, 0, st>>>(
          (const T*)x, (T*)y, rows, cols, p.tpr);
    });
  }
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

// The launch plan for rows x cols of item-byte values (the twin of
// kernels/generic.py::softmax_plan): path, vec, vpt, tpr, rows_per_block,
// threads, grid.
extern "C" int lapis_row_softmax_plan(long rows, int cols, int item, int aligned, int sm_count,
                                      long long* out) {
  if (rows < 0 || cols <= 0 || (item != 2 && item != 4) || sm_count < 1)
    return (int)cudaErrorInvalidValue;
  return row_reduce::write_plan(softmax_plan(rows, cols, item, aligned != 0, sm_count), out);
}
