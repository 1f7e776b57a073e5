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
//   VMEM scratch tile.  Built without defines: every tile of gemm.cuh.
//
// The reference pads the batch to a multiple of batch_block and M, N, K
// to block multiples, and materialises a broadcast B once per batch
// entry.  Here every ragged edge (batch tail, M, N, K) is masked in the
// kernel, and A and B are read through a batch stride each: a broadcast
// B has stride 0 and is never copied.  The last two dims of A and B are
// contiguous (the wrapper copies only where they are not); C is
// contiguous.
//
// Small: the H100 hierarchy picks it when m·n <= 1024 (an explicit
// vectorize_batch tiling may ask for up to 2048 outputs).  Such products
// do few flops per byte: at 16384 × 32×32×32 f32 the bound is HBM's (201
// MB), so the design is about keeping bytes in flight on every SM.
//
// * The grid comes from the card, not from the pass: the launcher gives
//   each block at most batch_block matrices (the IR's tiling) and no more
//   than brings the grid to two blocks per SM (small_plan below; its twin
//   is kernels/batched_gemm.py::small_plan).  A block holds ``teams``
//   matrices at once, one team of threads each (about 128 threads a
//   block: at 16384 × 32³ that beat 256 on an H100), and walks its
//   matrices in rounds of ``teams``.
// * A register micro-tile: a thread owns TM × 4 outputs of one matrix
//   (4 × 4 at 32 × 32: 64 threads a matrix; TM is 1 or 2 for m < 3 and 8
//   for m > 1024 at n = 1) and per 4-deep K step reads a
//   4-wide row fragment of A for each of its TM rows and four 4-wide row
//   fragments of B from shared memory (16-byte loads in f32, 8 in bf16),
//   then does TM × 16 FMAs.  Outputs past M or N are computed from
//   whatever the padding holds and never stored: nothing is padded in
//   device memory.
// * Staging: each (round, K chunk of bk) is one stage of a two-stage
//   shared ring.  Rows whose start is 16-byte aligned (the operand's
//   base, batch stride and row length in bytes all multiples of 16) are
//   copied by cp.async.cg in 16-byte pieces (LDGSTS), zero-filling past
//   K or N, so the next stage's operands are in flight while this stage
//   is computed; other operands take element loads inside the same
//   kernel.  Shared rows keep the input dtype; A's rows are padded by 16
//   bytes so the TM row reads of a warp fall in different banks.
// * f32 stays FFMA (the f32 bar is 1e-5, which rules out TF32); bf16 is
//   converted to f32 in registers and takes the same FFMA loop.
//
// Tiled (built without -DLAPIS_SMALL): the products of gemm.cuh, shared
// with kk.gemm — bf16 that TMA can address on wgmma (gemm_sm90.cuh), the
// rest on FFMA (gemm_tile.cuh) — with the matrix (and the K range, where
// the plan splits K) on the grid's third axis, looping past 65,535; a B
// shared by a packed batch of A folds into one product of batch·M rows.
// One library holds every tile: the plan picks it from the extents, and
// the IR's (bm, bn, bk) is only checked (kernels/batched_gemm.py).
#include <cuda_runtime.h>

#ifdef LAPIS_SMALL

#ifndef LAPIS_BK
#error "build the small kernel with -DLAPIS_SMALL=1 -DLAPIS_BK=<depth>"
#endif

#include <stdint.h>

#include <algorithm>

#include "lapis_cuda.cuh"

constexpr int BK = LAPIS_BK;

constexpr int SMALL_TN = 4;              // output columns a thread owns
constexpr int SMALL_MAX_OUTPUTS = 2048;  // m·n the kernel takes
constexpr int SMALL_MAX_THREADS = 512;   // a block: teams × threads a matrix
constexpr int SMALL_TM4_THREADS = 256;   // most threads a matrix at TM >= 4
constexpr int SMALL_BLOCK_THREADS = 128; // threads a block aims for
constexpr int SMALL_TARGET_BLOCKS = 2 * 132;   // two per H100 SM
constexpr int SMALL_SMEM_LIMIT = 232448;       // a block's opt-in maximum

static int cdiv(int a, int b) { return (a + b - 1) / b; }
static int rup(int a, int b) { return cdiv(a, b) * b; }

// The launch plan of one batched product; kernels/batched_gemm.py's
// small_plan computes the same numbers (held to this one on the card).
struct SmallPlan {
  int tm;          // output rows a thread owns (× SMALL_TN columns): 1, 2, 4, 8
  int tpm;         // threads a matrix
  int teams;       // matrices a block computes at once
  int per_block;   // matrices a block owns (<= batch_block)
  int grid;        // blocks
  int threads;     // teams × tpm
  int bk;          // K chunk of one stage
  int lda, ldb;    // shared row strides (elements) of A and B chunks
  int stages;      // 1, or 2 when a block has more than one stage
  int smem;        // dynamic shared memory (bytes)
};

static SmallPlan small_plan(int m, int n, int k, int batch, int batch_block,
                            int itemsize) {
  SmallPlan p;
  const int vec = 16 / itemsize;   // elements of a 16-byte piece
  const int ng = cdiv(n, SMALL_TN);
  // 8 rows only where 4 would need more than 256 threads (m > 1024, n = 1)
  p.tm = m == 1 ? 1 : m == 2 ? 2 : cdiv(m, 4) * ng <= SMALL_TM4_THREADS ? 4 : 8;
  const int mp = rup(m, p.tm);
  p.tpm = (mp / p.tm) * ng;
  p.ldb = rup(ng * SMALL_TN, vec);
  // the chunk: the library's BK at most (a multiple of 8, so chunk starts
  // stay 16-byte aligned), halved until two stages of one matrix fit
  int bk = std::max(8, std::min(rup(std::max(BK, 8), 8), rup(k, 8)));
  auto tile = [&](int c) { return itemsize * (mp * (c + vec) + c * p.ldb); };
  while (bk > 8 && 2 * tile(bk) > SMALL_SMEM_LIMIT)
    bk = std::max(8, rup(bk / 2, 8));
  p.bk = bk;
  p.lda = bk + vec;
  p.per_block = std::max(1, std::min(batch_block, batch / SMALL_TARGET_BLOCKS));
  p.teams = std::max(1, std::min(p.per_block, SMALL_BLOCK_THREADS / p.tpm));
  while (p.teams > 1 && 2 * p.teams * tile(bk) > SMALL_SMEM_LIMIT) --p.teams;
  const int stages_needed = cdiv(p.per_block, p.teams) * std::max(1, cdiv(k, bk));
  p.stages = stages_needed > 1 ? 2 : 1;
  p.smem = p.stages * p.teams * tile(bk);
  p.grid = cdiv(batch, p.per_block);
  p.threads = p.teams * p.tpm;
  return p;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// four consecutive elements of a shared row, as f32
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(x.x << 16);
  v[1] = __uint_as_float(x.x & 0xffff0000u);
  v[2] = __uint_as_float(x.y << 16);
  v[3] = __uint_as_float(x.y & 0xffff0000u);
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 x;
  x.x = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(v[0]))) |
        (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(v[1]))) << 16);
  x.y = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(v[2]))) |
        (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(v[3]))) << 16);
  *reinterpret_cast<uint2*>(p) = x;
}

// TM >= 4 keeps a block at 256 threads (small_plan), a bound that leaves
// its 16 or 32 accumulators room without spilling
template <typename TI, typename TO, int TM>
__global__ void __launch_bounds__(TM >= 4 ? SMALL_TM4_THREADS : SMALL_MAX_THREADS)
lapis_bgemm_small(const TI* __restrict__ A, const TI* __restrict__ B,
                  TO* __restrict__ C, int batch, int M, int N, int K,
                  long long sA, long long sB, SmallPlan p, int vec_a,
                  int vec_b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TI* const smem = reinterpret_cast<TI*>(smem_raw);
  constexpr int VEC = 16 / sizeof(TI);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int mp = (M + TM - 1) / TM * TM;
  const int tile = mp * p.lda + p.bk * p.ldb;   // one matrix's A and B chunks
  const long long first = (long long)blockIdx.x * p.per_block;
  const int owned = (int)min((long long)p.per_block, (long long)batch - first);
  const int chunks = max(1, (K + p.bk - 1) / p.bk);
  const int n_stages = (owned + p.teams - 1) / p.teams * chunks;

  // this thread's TM × 4 outputs: rows i0.., columns j0..
  const int team = tid / p.tpm, t = tid - team * p.tpm;
  const int ng = (N + SMALL_TN - 1) / SMALL_TN;
  const int i0 = (t / ng) * TM, j0 = (t % ng) * SMALL_TN;

  // stage s = (round s / chunks, K chunk s % chunks) into ring slot s % stages
  auto issue = [&](int s) {
    const int round = s / chunks, k0 = (s - round * chunks) * p.bk;
    const int kc = min(p.bk, K - k0), kc4 = (kc + 3) & ~3;
    TI* const buf = smem + (size_t)(s % p.stages) * p.teams * tile;
    for (int g = 0; g < p.teams; ++g) {
      const int idx = round * p.teams + g;
      if (idx >= owned) break;
      const TI* a = A + (first + idx) * sA;
      const TI* b = B + (first + idx) * sB;
      TI* const As = buf + g * tile;
      TI* const Bs = As + mp * p.lda;
      if (vec_a) {   // 16-byte pieces, zero-filled past the chunk's kc
        const int pa = (kc4 + VEC - 1) / VEC;
        for (int e = tid; e < M * pa; e += nthr) {
          const int r = e / pa, c = (e - r * pa) * VEC;
          const int bytes = max(0, min(VEC, kc - c)) * (int)sizeof(TI);
          cp_async16(As + r * p.lda + c, bytes ? a + (long long)r * K + k0 + c : a,
                     bytes);
        }
      } else {
        for (int e = tid; e < M * kc4; e += nthr) {
          const int r = e / kc4, c = e - r * kc4;
          if (c < kc)
            As[r * p.lda + c] = a[(long long)r * K + k0 + c];
          else
            lapis_store(As, r * p.lda + c, 0.0f);
        }
      }
      if (vec_b) {
        const int pb = (N + VEC - 1) / VEC;
        for (int e = tid; e < kc4 * pb; e += nthr) {
          const int r = e / pb, c = (e - r * pb) * VEC;
          const int bytes = r < kc ? max(0, min(VEC, N - c)) * (int)sizeof(TI) : 0;
          cp_async16(Bs + r * p.ldb + c,
                     bytes ? b + (long long)(k0 + r) * N + c : b, bytes);
        }
      } else {
        for (int e = tid; e < kc4 * N; e += nthr) {
          const int r = e / N, c = e - r * N;
          if (r < kc)
            Bs[r * p.ldb + c] = b[(long long)(k0 + r) * N + c];
          else
            lapis_store(Bs, r * p.ldb + c, 0.0f);
        }
      }
    }
  };

  float acc[TM][SMALL_TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < SMALL_TN; ++j) acc[i][j] = 0.0f;

  issue(0);
  cp_async_commit();
  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) issue(s + 1);
    cp_async_commit();
    cp_async_wait1();   // every group but the newest has landed: stage s
    __syncthreads();
    const int round = s / chunks, chunk = s - round * chunks;
    const int kc = min(p.bk, K - chunk * p.bk), kc4 = (kc + 3) & ~3;
    const TI* const As =
        smem + (size_t)(s % p.stages) * p.teams * tile + team * tile + i0 * p.lda;
    const TI* const Bs = smem + (size_t)(s % p.stages) * p.teams * tile +
                         team * tile + mp * p.lda + j0;
#pragma unroll 1
    for (int kk = 0; kk < kc4; kk += 4) {
      float a[TM][4], b[4][SMALL_TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) load4(As + i * p.lda + kk, a[i]);
#pragma unroll
      for (int q = 0; q < 4; ++q) load4(Bs + (kk + q) * p.ldb, b[q]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < SMALL_TN; ++j)
            acc[i][j] = fmaf(a[i][q], b[q][j], acc[i][j]);
    }
    if (chunk == chunks - 1) {   // the round's matrices are done
      const int idx = round * p.teams + team;
      if (idx < owned) {
        TO* const c = C + (first + idx) * (long long)M * N;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          if (i0 + i >= M || j0 >= N) continue;
          TO* const row = c + (long long)(i0 + i) * N + j0;
          if (N % SMALL_TN == 0) {
            store4(row, acc[i]);
          } else {
#pragma unroll
            for (int j = 0; j < SMALL_TN; ++j)
              if (j0 + j < N) lapis_store(row, j, acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < SMALL_TN; ++j) acc[i][j] = 0.0f;
    }
    __syncthreads();   // slot s % stages is refilled by the next issue
  }
}

static bool aligned16(const void* ptr, long long stride, int itemsize) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && (stride * itemsize) % 16 == 0;
}

template <typename TI, typename TO>
static int lapis_bgemm_launch(const void* A, const void* B, void* C, void* ws,
                              long long ws_bytes, int batch, int M, int N,
                              int K, long long sA, long long sB,
                              int batch_block, void* stream) {
  (void)ws;
  (void)ws_bytes;
  if (batch < 1 || batch_block < 1 || M < 1 || N < 1 || K < 0 ||
      (long long)M * N > SMALL_MAX_OUTPUTS)
    return (int)cudaErrorInvalidValue;
  const int item = (int)sizeof(TI);
  const SmallPlan p = small_plan(M, N, K, batch, batch_block, item);
  // 16-byte pieces need every staged row to start 16-byte aligned
  const int vec_a = aligned16(A, sA, item) && (M == 1 || (K * item) % 16 == 0);
  const int vec_b = aligned16(B, sB, item) && (K <= 1 || (N * item) % 16 == 0);
  void (*kernel)(const TI*, const TI*, TO*, int, int, int, int, long long,
                 long long, SmallPlan, int, int) =
      p.tm == 1   ? lapis_bgemm_small<TI, TO, 1>
      : p.tm == 2 ? lapis_bgemm_small<TI, TO, 2>
      : p.tm == 4 ? lapis_bgemm_small<TI, TO, 4>
                  : lapis_bgemm_small<TI, TO, 8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)p.grid, p.threads, p.smem, (cudaStream_t)stream>>>(
      (const TI*)A, (const TI*)B, (TO*)C, batch, M, N, K, sA, sB, p, vec_a,
      vec_b);
  return (int)cudaGetLastError();
}

// The plan the launcher takes for these extents (itemsize 4: f32 inputs,
// 2: bf16), for tests that hold the Python twin to it: tm, threads a
// matrix, teams, matrices a block, grid, threads, bk, stages, smem bytes.
extern "C" int lapis_batched_gemm_small_plan(int m, int n, int k, int batch,
                                             int batch_block, int itemsize,
                                             int* out) {
  if (m < 1 || n < 1 || k < 0 || batch < 1 || batch_block < 1 ||
      (itemsize != 2 && itemsize != 4))
    return (int)cudaErrorInvalidValue;
  const SmallPlan p = small_plan(m, n, k, batch, batch_block, itemsize);
  const int v[9] = {p.tm, p.tpm, p.teams, p.per_block, p.grid,
                    p.threads, p.bk, p.stages, p.smem};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

#else  // the tiled products

#include "gemm.cuh"

template <typename TI, typename TO>
static int lapis_bgemm_launch(const void* A, const void* B, void* C, void* ws,
                              long long ws_bytes, int batch, int M, int N,
                              int K, long long sA, long long sB,
                              int batch_block, void* stream) {
  (void)batch_block;
  return gemm::run<TI, TO>(A, B, C, ws, ws_bytes, batch, M, N, K, sA, sB,
                           (cudaStream_t)stream);
}

#endif

// A, B, C: device pointers; sA, sB: the batch strides of A and B in
// elements (0 for a broadcast operand); batch_block: the most matrices a
// small-kernel block owns (the tiled products ignore it); ws, ws_bytes:
// the tiled plan's f32 split-K workspace (null and 0 where it does not
// split K; the small kernel takes none).  Returns the cudaError_t of the
// launches.
#define LAPIS_BGEMM_ENTRY(NAME, TI, TO)                                      \
  extern "C" int NAME(const void* A, const void* B, void* C, void* ws,       \
                      long long ws_bytes, int batch, int M, int N, int K,    \
                      long long sA, long long sB, int batch_block,           \
                      void* stream) {                                        \
    return lapis_bgemm_launch<TI, TO>(A, B, C, ws, ws_bytes, batch, M, N, K, \
                                      sA, sB, batch_block, stream);          \
  }

LAPIS_BGEMM_ENTRY(lapis_batched_gemm_f32, float, float)
LAPIS_BGEMM_ENTRY(lapis_batched_gemm_bf16, __nv_bfloat16, __nv_bfloat16)
LAPIS_BGEMM_ENTRY(lapis_batched_gemm_bf16_f32out, __nv_bfloat16, float)
