// The FFMA route of kk.gemm and the tiled kk.batched_gemm: C[z] = A[z] ·
// B[z] with f32 accumulation on the FP32 pipes.  Every f32 product takes
// it (the f32 bar is 1e-5 against torch.matmul in full f32, which rules
// out TF32 and the tensor cores), and so do the bf16 products TMA cannot
// address (K or N not a multiple of 8, a base off 16-byte alignment,
// kk.gemv's one column).  gemm.cuh chooses the tile (gemm_plan) and
// launches it.
//
// A is M×K, B is K×N and C is M×N, rows contiguous; a matrix of the batch
// is z / split, its K range z % split.  One block of BM·BN/64 threads owns
// one BM × BN tile (128 × 128, 128 × 64 or 64 × 64), each thread an 8 × 8
// register micro-tile laid out as 2 × 2 sub-tiles of 4 × 4 (rows tr·4 and
// BM/2 + tr·4, columns tc·4 and BN/2 + tc·4), so the four 16-byte shared
// loads a k step takes (two of A, two of B) fall in distinct banks across
// a warp and the 64 FFMA they feed need no other load.
//
// * Staging: BK = 16 deep K steps through a ring of three stages filled by
//   cp.async (LDGSTS), so two steps' loads are in flight while one is
//   computed, behind one barrier a step.  A is staged k-major (its rows
//   transposed by 4-byte copies, 16 threads along a row's 64 contiguous
//   bytes, the row stride padded by 16 bytes); B row-major by 16-byte
//   copies where its base, row and batch strides are 16-byte aligned,
//   4-byte copies where not (MALA's N = 201, kk.gemv's single column).
//   Copies past M, N or the K range are zero-filled (src-size 0): nothing
//   is padded in device memory.
// * bf16 inputs are converted on load: global loads into registers for
//   the next step are issued before this step's FFMA and stored to the
//   (f32) ring after them, two stages deep.
// * Stores are 16-byte (f32) or 8-byte (bf16) vectors of four outputs
//   where N is a multiple of 4, masked elements otherwise.
//
// Bound: the FP32 rate (67 TFLOP/s on the SXM part) for the large
// products; the grid's fill of 132 SMs for the small ones, which the plan
// answers with a smaller tile or a split K range.
#pragma once
#include <stdint.h>

#include "lapis_cuda.cuh"

namespace gemm_ffma {

constexpr int BK = 16;
constexpr int STAGES = 3;

template <int BM, int BN>
struct Shape {
  static constexpr int THREADS = BM * BN / 64;   // one 8 × 8 micro-tile a thread
  static constexpr int TC = BN / 8;              // micro-tiles across a row
  static constexpr int LDA = BM + 4;             // k-major A: BK rows of BM (+16 bytes)
  static constexpr int LDB = BN;                 // row-major B: BK rows of BN
  static constexpr int STAGE = BK * LDA + BK * LDB;   // floats a stage
  static constexpr int SMEM_BYTES = STAGES * STAGE * 4;
  static_assert(BM % 8 == 0 && BN % 8 == 0 && THREADS <= 1024, "whole micro-tiles");
  static_assert(THREADS % BK == 0 && THREADS % BN == 0 && BK * BN % (4 * THREADS) == 0,
                "every thread copies the same number of pieces, in fixed rows");
  static_assert(BM * BK / THREADS <= 32, "A's row mask fits 32 bits");
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  uint2 x;
  x.x = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(v[0]))) |
        (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(v[1]))) << 16);
  x.y = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(v[2]))) |
        (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(v[3]))) << 16);
  *reinterpret_cast<uint2*>(p) = x;
}

// grid: (M tiles, N tiles, min(batch · split, 65535)); C + (s · batch + b)
// · M · N for matrix b and K range s of k_chunk elements (a multiple of
// BK).  vec_b: B's rows are 16-byte aligned (f32 only); vec_c: N % 4 == 0.
// f32 blocks are held to 128 registers (two 256-thread blocks an SM); the
// bf16 route's staging registers get what they need.
template <typename TI, typename TO, int BM, int BN>
__global__ void __launch_bounds__(Shape<BM, BN>::THREADS,
                                  sizeof(TI) == 4 ? 512 / Shape<BM, BN>::THREADS
                                                  : (Shape<BM, BN>::THREADS >= 256
                                                         ? 1 : 256 / Shape<BM, BN>::THREADS))
    lapis_gemm_ffma_kernel(const TI* __restrict__ A, const TI* __restrict__ B,
                           TO* __restrict__ C, int M, int N, int K, int batch, long long sA,
                           long long sB, int split, int k_chunk, int vec_b, int vec_c) {
  using S = Shape<BM, BN>;
  constexpr int THREADS = S::THREADS, LDA = S::LDA, LDB = S::LDB;
  constexpr int A_PER = BM * BK / THREADS;        // A elements a thread stages
  constexpr int A_ROWS = THREADS / BK;            // rows between them
  constexpr int B_PER = BK * BN / THREADS;        // B elements (4-byte copies)
  constexpr int B_ROWS = THREADS / BN;            // K rows between them
  constexpr int V_PER = B_PER / 4;                // B 16-byte pieces
  constexpr int V_ROWS = 4 * THREADS / BN;        // K rows between them
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, tr = tid / S::TC, tc = tid % S::TC;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  // this thread's copies: A rows a_r + u·A_ROWS at K column a_k; B K rows
  // b_k + u·B_ROWS at column b_c (or 16-byte pieces v_k + u·V_ROWS, v_c)
  const int a_k = tid % BK, a_r = tid / BK;
  const int b_c = tid % BN, b_k = tid / BN;
  const int v_c = (tid % (BN / 4)) * 4, v_k = tid / (BN / 4);
  uint32_t a_rows = 0;  // bit u: A row a_r + u·A_ROWS is inside M
#pragma unroll
  for (int u = 0; u < A_PER; ++u) a_rows |= (uint32_t)(m0 + a_r + u * A_ROWS < M) << u;
  const bool b_in = n0 + b_c < N, v_in = n0 + v_c < N;

  for (int z = blockIdx.z; z < batch * split; z += gridDim.z) {
    const int b = z / split, s_k = z % split;
    const int k_lo = s_k * k_chunk, k_hi = min(K, k_lo + k_chunk);
    const int nk = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;
    const TI* const a_src = A + b * sA + (long long)(m0 + a_r) * K + k_lo + a_k;
    const TI* const b_src = B + b * sB + (long long)(k_lo + b_k) * N + n0 + b_c;
    const TI* const v_src = B + b * sB + (long long)(k_lo + v_k) * N + n0 + v_c;

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    // the FFMA of one staged K step
    auto compute = [&](int slot) {
      const float* As = smem + slot * S::STAGE;
      const float* Bs = As + BK * LDA;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(As + kk * LDA + tr * 4);
        const float4 a1 = *reinterpret_cast<const float4*>(As + kk * LDA + BM / 2 + tr * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * LDB + tc * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(Bs + kk * LDB + BN / 2 + tc * 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    };

    if constexpr (sizeof(TI) == 4) {
      const float* const af = reinterpret_cast<const float*>(A);
      const float* const bf = reinterpret_cast<const float*>(B);
      // K step t into ring slot t % STAGES by cp.async (zero-filled outside)
      auto issue = [&](int t) {
        float* As = smem + (t % STAGES) * S::STAGE;
        float* Bs = As + BK * LDA;
        const int k0 = k_lo + t * BK;
        const bool a_kin = k0 + a_k < k_hi;
        const float* src = reinterpret_cast<const float*>(a_src) + t * BK;
#pragma unroll
        for (int u = 0; u < A_PER; ++u) {
          const bool ok = a_kin && (a_rows >> u & 1u);
          cp_async4(As + a_k * LDA + a_r + u * A_ROWS, ok ? src : af, ok ? 4 : 0);
          src += (long long)A_ROWS * K;
        }
        if (vec_b) {
          const float* vs = reinterpret_cast<const float*>(v_src) + (long long)t * BK * N;
#pragma unroll
          for (int u = 0; u < V_PER; ++u) {
            const bool ok = v_in && k0 + v_k + u * V_ROWS < k_hi;
            cp_async16(Bs + (v_k + u * V_ROWS) * LDB + v_c, ok ? vs : bf, ok ? 16 : 0);
            vs += (long long)V_ROWS * N;
          }
        } else {
          const float* bs = reinterpret_cast<const float*>(b_src) + (long long)t * BK * N;
#pragma unroll
          for (int u = 0; u < B_PER; ++u) {
            const bool ok = b_in && k0 + b_k + u * B_ROWS < k_hi;
            cp_async4(Bs + (b_k + u * B_ROWS) * LDB + b_c, ok ? bs : bf, ok ? 4 : 0);
            bs += (long long)B_ROWS * N;
          }
        }
      };
#pragma unroll
      for (int t = 0; t < STAGES - 1; ++t) {
        if (t < nk) issue(t);
        cp_async_commit();
      }
      for (int t = 0; t < nk; ++t) {
        cp_async_wait<STAGES - 2>();  // step t has landed (this thread's copies)
        __syncthreads();              // ... everyone's, and step t - 1 is computed
        if (t + STAGES - 1 < nk) issue(t + STAGES - 1);
        cp_async_commit();
        compute(t % STAGES);
      }
      cp_async_wait<0>();
    } else {
      // bf16: converted on load, the next step's loads in flight during
      // this step's FFMA, two ring slots
      float ra[A_PER], rb[B_PER];
      auto load = [&](int t) {
        const int k0 = k_lo + t * BK;
        const bool a_kin = k0 + a_k < k_hi;
#pragma unroll
        for (int u = 0; u < A_PER; ++u)
          ra[u] = a_kin && (a_rows >> u & 1u)
                      ? lapis_load(a_src, (long long)u * A_ROWS * K + t * BK)
                      : 0.f;
#pragma unroll
        for (int u = 0; u < B_PER; ++u)
          rb[u] = b_in && k0 + b_k + u * B_ROWS < k_hi
                      ? lapis_load(b_src, ((long long)t * BK + u * B_ROWS) * N)
                      : 0.f;
      };
      auto store = [&](int slot) {
        float* As = smem + slot * S::STAGE;
        float* Bs = As + BK * LDA;
#pragma unroll
        for (int u = 0; u < A_PER; ++u) As[a_k * LDA + a_r + u * A_ROWS] = ra[u];
#pragma unroll
        for (int u = 0; u < B_PER; ++u) Bs[(b_k + u * B_ROWS) * LDB + b_c] = rb[u];
      };
      if (nk > 0) {
        load(0);
        store(0);
      }
      __syncthreads();
      for (int t = 0; t < nk; ++t) {
        if (t + 1 < nk) load(t + 1);
        compute(t % 2);
        if (t + 1 < nk) store((t + 1) % 2);
        __syncthreads();
      }
    }
    __syncthreads();  // the ring is free before the next z stages into it

    TO* const c = C + ((long long)s_k * batch + b) * M * N;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = m0 + (i < 4 ? tr * 4 + i : BM / 2 + tr * 4 + i - 4);
      if (row >= M) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + h * (BN / 2) + tc * 4;
        TO* const dst = c + (long long)row * N + col;
        if (vec_c && col + 4 <= N) {
          store4(dst, &acc[i][4 * h]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (col + j < N) lapis_store(dst, j, acc[i][4 * h + j]);
        }
      }
    }
  }
}

// C = the sum of `split` partial products in ws (f32, split × total), in
// order 0, 1, ...: the same bits on every call
template <typename TO>
__global__ void lapis_gemm_splitk_reduce(const float* __restrict__ ws, TO* __restrict__ C,
                                         long long total, int split) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int p = 1; p < split; ++p) s += ws[p * total + i];
    lapis_store(C, i, s);
  }
}

template <typename TI, typename TO, int BM, int BN>
int launch(const TI* A, const TI* B, TO* C, int M, int N, int K, int batch, long long sA,
           long long sB, int split, int k_chunk, dim3 grid, cudaStream_t stream) {
  using S = Shape<BM, BN>;
  auto kern = lapis_gemm_ffma_kernel<TI, TO, BM, BN>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int vec_b = sizeof(TI) == 4 && reinterpret_cast<uintptr_t>(B) % 16 == 0 && N % 4 == 0 &&
                    (sB * 4) % 16 == 0;
  const int vec_c = N % 4 == 0 && reinterpret_cast<uintptr_t>(C) % 16 == 0;
  kern<<<grid, S::THREADS, S::SMEM_BYTES, stream>>>(A, B, C, M, N, K, batch, sA, sB, split,
                                                    k_chunk, vec_b, vec_c);
  return (int)cudaGetLastError();
}

}  // namespace gemm_ffma
