// CSR SpMM on Hopper: Y = A·B with A in CSR (indptr, indices, values) and
// B dense (n_cols × n, row-major), f32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/spmm.py:spmm_ell
// (_spmm_kernel, pallas_call at spmm.py:57).  There the CSR matrix is
// padded to ELL, XLA builds an (n_rows, width, n) copy of the gathered B
// rows outside the kernel (spmm.py:42), and the kernel contracts the
// width axis of (row block × column block) tiles, accumulating across a
// sequential width grid axis.  Here each thread block covers a
// (row block × column block) tile of Y and gathers B's rows inside:
// threadIdx.x runs along Y's columns, so the read of a row B[col, c..]
// coalesces across the lanes while every lane of a row reads the same
// index and value (a broadcast), and each thread loops over its row's
// entries with an f32 accumulator.  The gathered copy of B never exists.
//
// Bound: the CSR bytes, B and Y over HBM bandwidth, or 2·nnz·n flops
// over the FP32 rate, whichever is larger; B's rows are re-read once per
// entry that names them, from L2 when B fits it.
//
// Tiling: `row_block` rows per thread block (the sparsify pass's tiling;
// any value runs, the block loops over its rows when they outnumber its
// thread rows); the column block is min(32, next power of two >= n).
#include <cuda_runtime.h>

#include "lapis_cuda.cuh"

template <typename T>
__global__ void lapis_spmm_kernel(const int* __restrict__ indptr,
                                  const int* __restrict__ cols,
                                  const T* __restrict__ vals,
                                  const T* __restrict__ B, T* __restrict__ Y,
                                  int n_rows, int n, int row_block) {
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= n) return;                         // no barrier follows
  const long first = (long)blockIdx.x * row_block;
  for (int r = threadIdx.y; r < row_block; r += blockDim.y) {
    const long row = first + r;
    if (row >= n_rows) return;
    float acc = 0.0f;
    const int end = indptr[row + 1];
    for (int j = indptr[row]; j < end; ++j)
      acc = fmaf(lapis_load(vals, j), lapis_load(B, (long)cols[j] * n + c), acc);
    lapis_store(Y, row * n + c, acc);
  }
}

template <typename T>
static int lapis_spmm_launch(const void* indptr, const void* cols,
                             const void* vals, const void* B, void* Y,
                             int n_rows, int n, int row_block, void* stream) {
  if (row_block < 1 || n < 0) return (int)cudaErrorInvalidValue;
  if (n_rows == 0 || n == 0) return 0;
  int cb = 1;
  while (cb < n && cb < 32) cb <<= 1;
  const int rows = row_block < 1024 / cb ? row_block : 1024 / cb;
  const dim3 block(cb, rows);
  const dim3 grid((unsigned)(((long)n_rows + row_block - 1) / row_block),
                  (unsigned)((n + cb - 1) / cb));
  lapis_spmm_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int*)indptr, (const int*)cols, (const T*)vals, (const T*)B,
      (T*)Y, n_rows, n, row_block);
  return (int)cudaGetLastError();
}

extern "C" int lapis_spmm_f32(const void* indptr, const void* cols,
                              const void* vals, const void* B, void* Y,
                              int n_rows, int n, int row_block, void* stream) {
  return lapis_spmm_launch<float>(indptr, cols, vals, B, Y, n_rows, n,
                                  row_block, stream);
}

extern "C" int lapis_spmm_bf16(const void* indptr, const void* cols,
                               const void* vals, const void* B, void* Y,
                               int n_rows, int n, int row_block, void* stream) {
  return lapis_spmm_launch<__nv_bfloat16>(indptr, cols, vals, B, Y, n_rows, n,
                                          row_block, stream);
}
