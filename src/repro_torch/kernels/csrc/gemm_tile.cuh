// One BM×BN tile of C = A · B with f32 accumulation: the tile loop of
// kk.gemm (csrc/matmul.cu, one tile per block) and of the tiled
// kk.batched_gemm (csrc/batched_gemm.cu, the same tile of one matrix of
// the batch per block).
//
// A is M×K, B is K×N and C is M×N, each row-major and contiguous; the
// caller offsets the pointers to its matrix.  Per K step the block stages
// a BM×BK tile of A and a BK×BN tile of B in shared memory (f32,
// converted on load, eight loads a thread in flight at a time: a batched
// product of few matrices has few blocks to hide a load's latency behind
// each other), then each thread accumulates a TM×TN = 8×8
// register micro-tile with FFMA.  Full f32: no TF32, no tensor cores in
// this version, so the card's bound is its FP32 rate (67 TFLOP/s on the
// SXM part) wherever the product is large.  The 8×8 micro-tile gives 64
// FFMA per 16 shared-memory loads, and the A tile's row stride is padded
// by one float so its staging stores do not hit the same bank.  Ragged
// M, N and K edges read as zero (the additive identity of the sum) and
// are not stored: masked in place, no padded copies.
#pragma once
#include <stddef.h>

#include "lapis_cuda.cuh"

template <int BM, int BN, int BK>
struct LapisGemmTile {
  static constexpr int TM = 8;
  static constexpr int TN = 8;
  static constexpr int THREADS = (BM / TM) * (BN / TN);
  static constexpr int AS_STRIDE = BK + 1;   // padded row stride of the A tile
  static constexpr int STAGE = 8;            // loads in flight a thread
  static constexpr size_t SMEM_BYTES =
      sizeof(float) * (size_t)(BM * AS_STRIDE + BK * BN);
  static_assert(BM % TM == 0 && BN % TN == 0,
                "tile must hold whole 8x8 micro-tiles");
  static_assert(THREADS >= 1 && THREADS <= 1024,
                "one thread per micro-tile, at most 1024");

  // The tile of C at (m0, n0); every thread of the block calls it, with
  // SMEM_BYTES of dynamic shared memory at ``smem``.  It ends behind a
  // barrier, so a block may call it again for another matrix.
  template <typename TI, typename TO>
  static __device__ __forceinline__ void run(
      const TI* __restrict__ A, const TI* __restrict__ B, TO* __restrict__ C,
      int M, int N, int K, int m0, int n0, float* smem) {
    float* As = smem;                      // [BM][AS_STRIDE], row-major
    float* Bs = smem + BM * AS_STRIDE;     // [BK][BN], row-major
    const int tid = threadIdx.x;
    const int tr = tid / (BN / TN);        // micro-tile row within the tile
    const int tc = tid % (BN / TN);        // micro-tile column

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += BK) {
      // stage in rounds of STAGE loads a thread, all issued before any
      // is stored, so a block with few neighbours on its SM still keeps
      // loads in flight
#pragma unroll 1
      for (int e0 = 0; e0 < BM * BK; e0 += STAGE * THREADS) {
        float v[STAGE];
#pragma unroll
        for (int u = 0; u < STAGE; ++u) {
          const int e = e0 + u * THREADS + tid;
          const int gm = m0 + e / BK, gk = k0 + e % BK;
          v[u] = (e < BM * BK && gm < M && gk < K)
                     ? lapis_load(A, (long)gm * K + gk) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < STAGE; ++u) {
          const int e = e0 + u * THREADS + tid;
          if (e < BM * BK) As[(e / BK) * AS_STRIDE + e % BK] = v[u];
        }
      }
#pragma unroll 1
      for (int e0 = 0; e0 < BK * BN; e0 += STAGE * THREADS) {
        float v[STAGE];
#pragma unroll
        for (int u = 0; u < STAGE; ++u) {
          const int e = e0 + u * THREADS + tid;
          const int gk = k0 + e / BN, gn = n0 + e % BN;
          v[u] = (e < BK * BN && gk < K && gn < N)
                     ? lapis_load(B, (long)gk * N + gn) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < STAGE; ++u) {
          const int e = e0 + u * THREADS + tid;
          if (e < BK * BN) Bs[e] = v[u];
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[(tr * TM + i) * AS_STRIDE + kk];
        const float4* bp =
            reinterpret_cast<const float4*>(Bs + kk * BN + tc * TN);
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
};
