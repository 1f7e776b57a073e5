// kk.batched_gemm on Hopper: C[b] = A[b] · B[b] for b < batch, f32
// accumulation, output in A's dtype (or f32).
//
// Replaces the two TPU kernels of src/repro/kernels/batched_gemm.py:
//
// * _small_kernel (pallas_call at batched_gemm.py:73), vectorize_batch:
//   one grid step per batch_block whole matrices, contracted together in
//   VMEM.  Built with -DLAPIS_SMALL=1 -DLAPIS_BK=<depth>.
// * _tiled_kernel (pallas_call at batched_gemm.py:94): per matrix a grid
//   over (M/bm, N/bn) tiles and a sequential K axis accumulating in a
//   VMEM scratch tile.  Built with -DLAPIS_BM/BN/BK.
//
// The reference pads the batch to a multiple of batch_block and M, N, K
// to block multiples, and materialises a broadcast B once per batch
// entry.  Here every ragged edge (batch tail, M, N, K) is masked in the
// kernel, and A and B are read through a batch stride each: a broadcast
// B has stride 0 and is never copied.  The last two dims of A and B are
// contiguous (the wrapper copies only where they are not); C is
// contiguous.
//
// Small: the H100 hierarchy picks it when m·n <= 1024.  A block owns
// batch_block consecutive matrices (the pass's choice) and walks them in
// groups of ``group`` that fit its shared memory and its threads'
// registers: 32 matrices of 32×32×32 in f32 would take 256 KiB of
// staged A and B, over the 227 KiB a block may use.  Per K step of BK the
// group's A (row stride padded by one float) and B chunks are staged as
// f32; then each thread owns up to SMALL_OUT outputs of the group, one
// (matrix, row, column) each, and sums BK products from shared memory:
// lanes of a warp run along a row of C, so B's reads are consecutive and
// A's are a broadcast.  Batch is the grid's x axis (y and z stop at
// 65,535).  Such small products move few flops per byte: at 16384 ×
// 32×32×32 the bound is HBM's (201 MB), and this version's inner loop, two
// shared-memory loads per FMA, is well short of it.
//
// Tiled: one block per BM×BN tile of one matrix, the tile loop of
// gemm_tile.cuh (shared with kk.gemm); the matrix is the grid's z axis,
// looping past 65,535.  At the large shapes the FP32 rate bounds it.
#include <cuda_runtime.h>

#include "gemm_tile.cuh"

#ifndef LAPIS_BK
#error "build with -DLAPIS_SMALL=1 -DLAPIS_BK=<depth>, or -DLAPIS_BM/BN/BK"
#endif

constexpr int BK = LAPIS_BK;

#ifdef LAPIS_SMALL

constexpr int SMALL_THREADS = 256;
constexpr int SMALL_OUT = 8;       // outputs a thread accumulates
constexpr int AS_STRIDE = BK + 1;  // padded row stride of a staged A chunk
constexpr int STAGE = 8;           // loads in flight a thread while staging

template <typename TI, typename TO>
__global__ void __launch_bounds__(SMALL_THREADS)
lapis_bgemm_small(const TI* __restrict__ A, const TI* __restrict__ B,
                  TO* __restrict__ C, int batch, int M, int N, int K,
                  long long sA, long long sB, int batch_block, int group) {
  extern __shared__ float smem[];
  float* As = smem;                              // [group][M][AS_STRIDE]
  float* Bs = smem + (size_t)group * M * AS_STRIDE;   // [group][BK][N]
  const int tid = threadIdx.x;
  const int mn = M * N;
  const long long first = (long long)blockIdx.x * batch_block;
  const int owned = (int)min((long long)batch_block, batch - first);

  for (int g0 = 0; g0 < owned; g0 += group) {
    const int gn = min(group, owned - g0);       // matrices in this group
    const long long b0 = first + g0;
    float acc[SMALL_OUT];
#pragma unroll
    for (int o = 0; o < SMALL_OUT; ++o) acc[o] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += BK) {
      // stage in rounds of STAGE loads a thread, all issued before any is
      // stored: a block walks its groups one after another, so the loads
      // of one round are all it has in flight
      const int a_n = gn * M * BK, b_n = gn * BK * N;
      for (int e0 = 0; e0 < a_n; e0 += STAGE * SMALL_THREADS) {
        float v[STAGE];
#pragma unroll
        for (int u = 0; u < STAGE; ++u) {
          const int e = e0 + u * SMALL_THREADS + tid;
          const int g = e / (M * BK), r = (e / BK) % M, gk = k0 + e % BK;
          v[u] = (e < a_n && gk < K)
                     ? lapis_load(A, (b0 + g) * sA + (long long)r * K + gk)
                     : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < STAGE; ++u) {
          const int e = e0 + u * SMALL_THREADS + tid;
          if (e < a_n) As[(e / BK) * AS_STRIDE + e % BK] = v[u];
        }
      }
      for (int e0 = 0; e0 < b_n; e0 += STAGE * SMALL_THREADS) {
        float v[STAGE];
#pragma unroll
        for (int u = 0; u < STAGE; ++u) {
          const int e = e0 + u * SMALL_THREADS + tid;
          const int g = e / (BK * N), gk = k0 + (e / N) % BK, c = e % N;
          v[u] = (e < b_n && gk < K)
                     ? lapis_load(B, (b0 + g) * sB + (long long)gk * N + c)
                     : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < STAGE; ++u) {
          const int e = e0 + u * SMALL_THREADS + tid;
          if (e < b_n) Bs[e] = v[u];
        }
      }
      __syncthreads();
#pragma unroll
      for (int o = 0; o < SMALL_OUT; ++o) {
        const int e = tid + o * SMALL_THREADS;
        if (e < gn * mn) {
          const int g = e / mn, i = (e % mn) / N, j = e % N;
          const float* ap = As + (g * M + i) * AS_STRIDE;
          const float* bp = Bs + (size_t)g * BK * N + j;
          float s = acc[o];
#pragma unroll 8
          for (int kk = 0; kk < BK; ++kk) s = fmaf(ap[kk], bp[kk * N], s);
          acc[o] = s;
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int o = 0; o < SMALL_OUT; ++o) {
      const int e = tid + o * SMALL_THREADS;
      if (e < gn * mn) lapis_store(C, b0 * mn + e, acc[o]);
    }
  }
}

template <typename TI, typename TO>
static int lapis_bgemm_launch(const void* A, const void* B, void* C,
                              int batch, int M, int N, int K, long long sA,
                              long long sB, int batch_block, int group,
                              void* stream) {
  if (batch_block < 1 || group < 1 || group > batch_block ||
      (long long)group * M * N > (long long)SMALL_THREADS * SMALL_OUT)
    return (int)cudaErrorInvalidValue;
  auto kernel = lapis_bgemm_small<TI, TO>;
  const size_t smem =
      sizeof(float) * (size_t)group * ((size_t)M * AS_STRIDE + (size_t)BK * N);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (batch + (long long)batch_block - 1) / batch_block;
  kernel<<<(unsigned)blocks, SMALL_THREADS, smem, (cudaStream_t)stream>>>(
      (const TI*)A, (const TI*)B, (TO*)C, batch, M, N, K, sA, sB,
      batch_block, group);
  return (int)cudaGetLastError();
}

#else  // the tiled kernel

using Tile = LapisGemmTile<LAPIS_BM, LAPIS_BN, LAPIS_BK>;
constexpr int MAX_GRID_Z = 65535;

template <typename TI, typename TO>
__global__ void __launch_bounds__(Tile::THREADS)
lapis_bgemm_tiled(const TI* __restrict__ A, const TI* __restrict__ B,
                  TO* __restrict__ C, int batch, int M, int N, int K,
                  long long sA, long long sB) {
  extern __shared__ float smem[];
  const long long sC = (long long)M * N;
  for (int b = blockIdx.z; b < batch; b += gridDim.z)
    Tile::run(A + b * sA, B + b * sB, C + b * sC, M, N, K,
              blockIdx.y * LAPIS_BM, blockIdx.x * LAPIS_BN, smem);
}

template <typename TI, typename TO>
static int lapis_bgemm_launch(const void* A, const void* B, void* C,
                              int batch, int M, int N, int K, long long sA,
                              long long sB, int batch_block, int group,
                              void* stream) {
  (void)batch_block;
  (void)group;
  auto kernel = lapis_bgemm_tiled<TI, TO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tile::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + LAPIS_BN - 1) / LAPIS_BN, (M + LAPIS_BM - 1) / LAPIS_BM,
                  batch < MAX_GRID_Z ? batch : MAX_GRID_Z);
  kernel<<<grid, Tile::THREADS, Tile::SMEM_BYTES, (cudaStream_t)stream>>>(
      (const TI*)A, (const TI*)B, (TO*)C, batch, M, N, K, sA, sB);
  return (int)cudaGetLastError();
}

#endif

// A, B, C: device pointers; sA, sB: the batch strides of A and B in
// elements (0 for a broadcast operand); batch_block and group: the small
// kernel's matrices per block and per shared-memory stage (the tiled
// kernel ignores them).  Returns the cudaError_t of the launch.
#define LAPIS_BGEMM_ENTRY(NAME, TI, TO)                                      \
  extern "C" int NAME(const void* A, const void* B, void* C, int batch,      \
                      int M, int N, int K, long long sA, long long sB,       \
                      int batch_block, int group, void* stream) {            \
    return lapis_bgemm_launch<TI, TO>(A, B, C, batch, M, N, K, sA, sB,       \
                                      batch_block, group, stream);           \
  }

LAPIS_BGEMM_ENTRY(lapis_batched_gemm_f32, float, float)
LAPIS_BGEMM_ENTRY(lapis_batched_gemm_bf16, __nv_bfloat16, __nv_bfloat16)
LAPIS_BGEMM_ENTRY(lapis_batched_gemm_bf16_f32out, __nv_bfloat16, float)
