// CSR SpMV on Hopper: y = A·x with A in CSR (indptr, indices, values),
// f32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/spmv.py:spmv_ell
// (_spmv_kernel, pallas_call at spmv.py:121).  A TPU has no warps, so
// there the CSR matrix is converted to padded ELL whose row width is the
// lane axis, XLA gathers x[cols] outside the kernel, and the kernel
// multiplies and row-reduces regular tiles, carrying the sum across a
// sequential width axis.  Hopper has warps, so this is the paper's own
// GPU form (§6.2): row-parallel teams, each row owned by a group of
// `row_width` lanes that run a vector loop over the row's entries,
// gather x[col] inside, accumulate in f32 and reduce with warp shuffles.
// The kernel reads CSR directly: no ELL conversion per call, and no
// padding bytes (ELL's width 192 against a mean of 14.34 on StocF-1465
// would read about 13× the CSR bytes).
//
// Bound: the bytes of the CSR arrays, x and y over HBM bandwidth
// (2 flops per 8-12 bytes is far below the ridge).  The x gather is
// irregular; it hits L2 when columns cluster, as in the real matrices.
//
// Tiling (the sparsify pass's choose_spmv_tiling): `row_block` rows per
// thread block, `row_width` lanes per row (1..32).  A row's group is the
// next power of two G >= row_width, so groups never straddle a warp and
// the shuffle reduction runs within G lanes; lanes past row_width idle
// in the vector loop.  When row_block × G exceeds 1024 threads the block
// loops over its rows.  The loop bound is the same for every thread, so
// all 32 lanes of a warp reach every shuffle even where a group's row
// lies past the block or the matrix.
#include <cuda_runtime.h>

#include "lapis_cuda.cuh"

template <typename T, int G>
__global__ void lapis_spmv_kernel(const int* __restrict__ indptr,
                                  const int* __restrict__ cols,
                                  const T* __restrict__ vals,
                                  const T* __restrict__ x, T* __restrict__ y,
                                  int n_rows, int row_block, int row_width) {
  const int lane = threadIdx.x % G;
  const int groups = blockDim.x / G;
  const long first = (long)blockIdx.x * row_block;
  for (int base = 0; base < row_block; base += groups) {
    const int r = base + (int)threadIdx.x / G;
    const long row = first + r;
    const bool active = r < row_block && row < n_rows;
    float acc = 0.0f;
    if (active && lane < row_width) {
      const int end = indptr[row + 1];
      for (int j = indptr[row] + lane; j < end; j += row_width)
        acc = fmaf(lapis_load(vals, j), lapis_load(x, cols[j]), acc);
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, o, G);
    if (active && lane == 0) lapis_store(y, row, acc);
  }
}

template <typename T, int G>
static void lapis_spmv_start(unsigned blocks, int threads, cudaStream_t s,
                             const void* indptr, const void* cols,
                             const void* vals, const void* x, void* y,
                             int n_rows, int row_block, int row_width) {
  lapis_spmv_kernel<T, G><<<blocks, threads, 0, s>>>(
      (const int*)indptr, (const int*)cols, (const T*)vals, (const T*)x,
      (T*)y, n_rows, row_block, row_width);
}

template <typename T>
static int lapis_spmv_launch(const void* indptr, const void* cols,
                             const void* vals, const void* x, void* y,
                             int n_rows, int row_block, int row_width,
                             void* stream) {
  if (row_block < 1 || row_width < 1 || row_width > 32)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  int g = 1;
  while (g < row_width) g <<= 1;
  const int groups = row_block < 1024 / g ? row_block : 1024 / g;
  const int threads = (groups * g + 31) / 32 * 32;   // whole warps
  const unsigned blocks = (unsigned)(((long)n_rows + row_block - 1) / row_block);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (g) {
    case 1: lapis_spmv_start<T, 1>(blocks, threads, s, indptr, cols, vals, x, y, n_rows, row_block, row_width); break;
    case 2: lapis_spmv_start<T, 2>(blocks, threads, s, indptr, cols, vals, x, y, n_rows, row_block, row_width); break;
    case 4: lapis_spmv_start<T, 4>(blocks, threads, s, indptr, cols, vals, x, y, n_rows, row_block, row_width); break;
    case 8: lapis_spmv_start<T, 8>(blocks, threads, s, indptr, cols, vals, x, y, n_rows, row_block, row_width); break;
    case 16: lapis_spmv_start<T, 16>(blocks, threads, s, indptr, cols, vals, x, y, n_rows, row_block, row_width); break;
    default: lapis_spmv_start<T, 32>(blocks, threads, s, indptr, cols, vals, x, y, n_rows, row_block, row_width); break;
  }
  return (int)cudaGetLastError();
}

extern "C" int lapis_spmv_f32(const void* indptr, const void* cols,
                              const void* vals, const void* x, void* y,
                              int n_rows, int row_block, int row_width,
                              void* stream) {
  return lapis_spmv_launch<float>(indptr, cols, vals, x, y, n_rows, row_block,
                                  row_width, stream);
}

extern "C" int lapis_spmv_bf16(const void* indptr, const void* cols,
                               const void* vals, const void* x, void* y,
                               int n_rows, int row_block, int row_width,
                               void* stream) {
  return lapis_spmv_launch<__nv_bfloat16>(indptr, cols, vals, x, y, n_rows,
                                          row_block, row_width, stream);
}
