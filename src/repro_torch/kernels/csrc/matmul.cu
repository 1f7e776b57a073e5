// kk.gemm on Hopper: C[M,N] = A[M,K] · B[K,N], f32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py:matmul
// (_matmul_kernel, pallas_call at matmul.py:57).  There the grid is
// (M/bm, N/bn, K/bk) with K an "arbitrary" (sequential) grid axis that
// accumulates into a VMEM scratch tile, and the inputs are zero-padded to
// block multiples.  On the H100 thread blocks run in parallel and in no
// order, so the K sweep becomes a loop inside each block, and the block
// masks the ragged edges itself instead of padding copies.
//
// Design: one thread block per BM×BN tile of C, running the tile loop of
// gemm_tile.cuh (shared memory tiles, an 8×8 FFMA register micro-tile per
// thread; see there).  At the shapes of the qwen2-1.5b MLP block the
// arithmetic intensity is far above the memory ridge, so the FP32 rate
// bounds it.
//
// BM, BN, BK are compile-time: the library is built once per tiling the
// map_parallelism pass chose (-DLAPIS_BM/BN/BK; see kernels/matmul.py).
// The H100 hierarchy keeps BM a multiple of 8 and BN, BK multiples of 32,
// so every tiling it yields has whole micro-tiles.
#include <cuda_runtime.h>

#include "gemm_tile.cuh"

#ifndef LAPIS_BM
#error "build with -DLAPIS_BM=<rows> -DLAPIS_BN=<cols> -DLAPIS_BK=<depth>"
#endif

using Tile = LapisGemmTile<LAPIS_BM, LAPIS_BN, LAPIS_BK>;

template <typename TI, typename TO>
__global__ void __launch_bounds__(Tile::THREADS)
lapis_matmul_kernel(const TI* __restrict__ A, const TI* __restrict__ B,
                    TO* __restrict__ C, int M, int N, int K) {
  extern __shared__ float smem[];
  Tile::run(A, B, C, M, N, K, blockIdx.y * LAPIS_BM, blockIdx.x * LAPIS_BN,
            smem);
}

template <typename TI, typename TO>
static int lapis_matmul_launch(const void* A, const void* B, void* C, int M,
                               int N, int K, void* stream) {
  auto kernel = lapis_matmul_kernel<TI, TO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tile::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + LAPIS_BN - 1) / LAPIS_BN, (M + LAPIS_BM - 1) / LAPIS_BM);
  kernel<<<grid, Tile::THREADS, Tile::SMEM_BYTES, (cudaStream_t)stream>>>(
      (const TI*)A, (const TI*)B, (TO*)C, M, N, K);
  return (int)cudaGetLastError();
}

extern "C" int lapis_matmul_f32(const void* A, const void* B, void* C, int M,
                                int N, int K, void* stream) {
  return lapis_matmul_launch<float, float>(A, B, C, M, N, K, stream);
}

extern "C" int lapis_matmul_bf16(const void* A, const void* B, void* C, int M,
                                 int N, int K, void* stream) {
  return lapis_matmul_launch<__nv_bfloat16, __nv_bfloat16>(A, B, C, M, N, K,
                                                           stream);
}

extern "C" int lapis_matmul_bf16_f32out(const void* A, const void* B, void* C,
                                        int M, int N, int K, void* stream) {
  return lapis_matmul_launch<__nv_bfloat16, float>(A, B, C, M, N, K, stream);
}
