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
// Design: one thread block per BM×BN tile of C.  Per K step it stages a
// BM×BK tile of A and a BK×BN tile of B in shared memory (f32, converted
// on load), then each thread accumulates a TM×TN = 8×8 register
// micro-tile with FFMA.  Full f32: no TF32, no tensor cores in this
// version, so the card's bound is its FP32 rate (67 TFLOP/s on the SXM
// part); at the shapes of the qwen2-1.5b MLP block the arithmetic
// intensity is far above the memory ridge, so operations bound it.  The
// 8×8 micro-tile gives 64 FFMA per 16 shared-memory loads, and the A
// tile's row stride is padded by one float so its staging stores do not
// hit the same bank.
//
// BM, BN, BK are compile-time: the library is built once per tiling the
// map_parallelism pass chose (-DLAPIS_BM/BN/BK; see kernels/matmul.py).
// The H100 hierarchy keeps BM a multiple of 8 and BN, BK multiples of 32,
// so every tiling it yields has whole micro-tiles.
#include <cuda_runtime.h>
#include <stddef.h>

#include "lapis_cuda.cuh"

#ifndef LAPIS_BM
#error "build with -DLAPIS_BM=<rows> -DLAPIS_BN=<cols> -DLAPIS_BK=<depth>"
#endif

constexpr int BM = LAPIS_BM;
constexpr int BN = LAPIS_BN;
constexpr int BK = LAPIS_BK;
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int THREADS = (BM / TM) * (BN / TN);
constexpr int AS_STRIDE = BK + 1;   // padded row stride of the A tile
static_assert(BM % TM == 0 && BN % TN == 0, "tile must hold whole 8x8 micro-tiles");
static_assert(THREADS >= 1 && THREADS <= 1024, "one thread per micro-tile, at most 1024");
constexpr size_t SMEM_BYTES = sizeof(float) * (size_t)(BM * AS_STRIDE + BK * BN);

template <typename TI, typename TO>
__global__ void __launch_bounds__(THREADS)
lapis_matmul_kernel(const TI* __restrict__ A, const TI* __restrict__ B,
                    TO* __restrict__ C, int M, int N, int K) {
  extern __shared__ float smem[];
  float* As = smem;                      // [BM][AS_STRIDE], row-major
  float* Bs = smem + BM * AS_STRIDE;     // [BK][BN], row-major
  const int tid = threadIdx.x;
  const int tr = tid / (BN / TN);        // micro-tile row within the tile
  const int tc = tid % (BN / TN);        // micro-tile column
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // stage the A and B tiles; out-of-range elements read as zero, the
    // additive identity of the sum (the ragged edge, masked in place)
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[r * AS_STRIDE + c] =
          (gm < M && gk < K) ? lapis_load(A, (long)gm * K + gk) : 0.0f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r * BN + c] =
          (gk < K && gn < N) ? lapis_load(B, (long)gk * N + gn) : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[(tr * TM + i) * AS_STRIDE + kk];
      const float4* bp = reinterpret_cast<const float4*>(Bs + kk * BN + tc * TN);
      const float4 b0 = bp[0], b1 = bp[1];
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + tr * TM + i;
    if (gm >= M) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tc * TN + j;
      if (gn < N) lapis_store(C, (long)gm * N + gn, acc[i][j]);
    }
  }
}

template <typename TI, typename TO>
static int lapis_matmul_launch(const void* A, const void* B, void* C, int M,
                               int N, int K, void* stream) {
  auto kernel = lapis_matmul_kernel<TI, TO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
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
