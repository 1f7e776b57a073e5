// The bf16 route of kk.gemm and the tiled kk.batched_gemm on Hopper:
// C[z] = A[z] · B[z] with A (M×K) and B (K×N) bf16, f32 accumulators on
// the tensor cores, C bf16 or f32.  Included by matmul.cu and
// batched_gemm.cu; gemm.cuh chooses this route (gemm_plan) and launches
// it.
//
// Replaces, for bf16 operands TMA can address, the TPU kernels
// src/repro/kernels/matmul.py:matmul (pallas_call at matmul.py:57) and
// src/repro/kernels/batched_gemm.py:_tiled_kernel (pallas_call at
// batched_gemm.py:94): a grid over (M/bm, N/bn) tiles with a sequential
// K axis accumulating in VMEM on the MXU.  Here one block of 384 threads
// computes 128 × 128 tiles of C (of one matrix of the batch, and of one
// K range when the plan splits K), one block per SM walking the tiles:
//
// * warpgroup 0 is the producer: after `setmaxnreg` gives its registers
//   away, one thread issues TMA loads (cp.async.bulk.tensor over 3-D
//   tensor maps (K, M, batch) of A and (N, K, batch) of B, with the
//   caller's batch strides) of A's 128 × 64 tile and B's 64 × 128 tile
//   into a ring of four 32 KB stages, with full / empty mbarriers per
//   stage, running ahead into the block's next tile while the consumers
//   store this one.  TMA zero-fills rows and columns past M, N and K, so
//   ragged edges need no padded copy; a broadcast operand is read through
//   a batch extent of 1.
// * warpgroups 1 and 2 are consumers of 64 rows each: per 64-deep K
//   step four wgmma m64n128k16 with both operands in shared memory,
//   128-byte-swizzled rows as TMA writes them; A K-major, B (K × N
//   row-major) MN-major through the transpose bit, as flash attention
//   reads V.  One step's group stays in flight while the next is issued
//   (wgmma.wait_group 1), and a stage is released when its group is done.
// * epilogue: each consumer writes its f32 fragments, converted to C's
//   type, into a padded staging tile of its own in shared memory, then
//   stores whole 16-byte rows of it, masked past M and N: every warp
//   writes contiguous 512-byte runs (the 12 × 2048 × 128 × 2048 product
//   is bound by writing its 100 MB output).
//
// Bound: the bf16 tensor-core rate (989 TFLOP/s dense) for the large
// products; HBM's rate where K is short and C large.
#pragma once
#include "sm90.cuh"

namespace gemm_sm90 {

constexpr int BM = 128, BN = 128, BK = 64;   // BK: one 128-byte swizzle row of bf16
constexpr int STAGES = 4;
constexpr int THREADS = 384;                 // a producer warpgroup and two consumers
constexpr int CONSUMERS = 256;               // each consumer thread arrives on `empty`
constexpr uint32_t A_BYTES = BM * BK * 2, B_BYTES = BK * BN * 2;
constexpr uint32_t STAGE_BYTES = A_BYTES + B_BYTES;
// one consumer's staging tile: 64 rows of BN f32 (the widest C) + 16 bytes,
// so a quad's row writes fall in distinct banks
constexpr int STAGE_ROW = BN * 4 + 16;
constexpr int EPI_BYTES = 2 * 64 * STAGE_ROW;
// 1 KB of slack aligns the ring to the swizzle's 1 KB period; then the
// ring, the two staging tiles and the mbarriers (full and empty per stage)
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + EPI_BYTES + 8 * 2 * STAGES;

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// One block per SM walks the output tiles t = blockIdx.x, + gridDim.x, ...
// in order (M tile fastest, then N tile, then z), so the producer loads
// the next tile while the consumers store this one.  z = b · split + s:
// matrix b, K range s of k_chunk elements (a multiple of BK), written to
// C + (s · batch + b) · M · N.  a_bcast / b_bcast: the operand has one
// matrix for the whole batch.
template <typename TO>
__global__ void __launch_bounds__(THREADS, 1)
    lapis_gemm_sm90_kernel(const __grid_constant__ CUtensorMap ta,
                           const __grid_constant__ CUtensorMap tb, TO* __restrict__ C, int M,
                           int N, int K, int batch, int split, int k_chunk, int a_bcast,
                           int b_bcast) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const epi = smem_raw + (base - raw) + STAGES * STAGE_BYTES;
  const uint32_t bars = base + STAGES * STAGE_BYTES + EPI_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };
  auto s_a = [&](int s) { return base + s * STAGE_BYTES; };
  auto s_b = [&](int s) { return base + s * STAGE_BYTES + A_BYTES; };

  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const long long n_tiles = (long long)tiles_m * tiles_n * batch * split;
  // tile t: its first row and column, matrix, K range
  auto tile = [&](long long t, int& m0, int& n0, int& b, int& s_k) {
    m0 = (int)(t % tiles_m) * BM;
    const long long rest = t / tiles_m;
    n0 = (int)(rest % tiles_n) * BN;
    const int z = (int)(rest / tiles_n);
    b = z / split;
    s_k = z % split;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full across the block's tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int g = 0;  // K steps issued so far: ring slot g % STAGES
      for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        int m0, n0, b, s_k;
        tile(t, m0, n0, b, s_k);
        const int k_lo = s_k * k_chunk, k_hi = min(K, k_lo + k_chunk);
        for (int k0 = k_lo; k0 < k_hi; k0 += BK, ++g) {
          const int s = g % STAGES;
          mbar_wait(empty(s), ((g / STAGES) & 1) ^ 1);
          mbar_expect_tx(full(s), STAGE_BYTES);
          tma_load(s_a(s), &ta, full(s), k0, m0, a_bcast ? 0 : b);
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            tma_load(s_b(s) + c * BK * 128, &tb, full(s), n0 + 64 * c, k0, b_bcast ? 0 : b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1;  // consumer warpgroup: rows m0 + 64 cw ...
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int r0 = 16 * (tid / 32) + lane / 4;  // this thread's rows: r0, r0 + 8
    uint8_t* const stage_tile = epi + cw * 64 * STAGE_ROW;
    int g = 0;
    for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      int m0, n0, b, s_k;
      tile(t, m0, n0, b, s_k);
      const int k_lo = s_k * k_chunk, k_hi = min(K, k_lo + k_chunk);
      float acc[BN / 2];
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
      int prev = -1;  // the slot whose group is still in flight
      for (int k0 = k_lo; k0 < k_hi; k0 += BK, ++g) {
        const int s = g % STAGES;
        mbar_wait(full(s), (g / STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)
          // A: this warpgroup's 64 rows, 32 bytes a k16 step inside the
          // swizzled rows; B: 16 K rows (2 KB) a step, 64-column chunks
          // BK * 128 bytes apart (LBO), 8-row groups 1 KB apart (SBO)
          wgmma_ss<BN, 1>(acc, sw128_desc(s_a(s) + cw * 64 * 128 + ks * 32, 16, 1024),
                          sw128_desc(s_b(s) + ks * 16 * 128, BK * 128, 1024), 1);
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's group is done: free its slot
        if (prev >= 0) mbar_arrive(empty(prev));
        prev = s;
      }
      wgmma_wait_all();
      fence_regs(acc);
      if (prev >= 0) mbar_arrive(empty(prev));

      // epilogue: fragments to the staging tile (fragment e: row r0 +
      // 8 ((e / 2) % 2), column 8 (e / 4) + 2 (lane % 4) + e % 2), then
      // 16-byte pieces of whole rows to C
      TO* const st = reinterpret_cast<TO*>(stage_tile);
      constexpr int ROW = STAGE_ROW / sizeof(TO);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          store_pair(st + (r0 + 8 * h) * ROW + 8 * j + 2 * (lane % 4), acc[4 * j + 2 * h],
                     acc[4 * j + 2 * h + 1]);
      named_sync(1 + cw, 128);
      constexpr int PIECES = BN * sizeof(TO) / 16;  // 16-byte pieces of a row
      constexpr int PER = 16 / sizeof(TO);
      TO* const c = C + ((long long)s_k * batch + b) * M * N;
      for (int i = tid; i < 64 * PIECES; i += 128) {
        const int r = i / PIECES, p = i % PIECES;
        const int row = m0 + 64 * cw + r, col = n0 + p * PER;
        if (row < M && col < N)
          *reinterpret_cast<uint4*>(c + (long long)row * N + col) =
              *reinterpret_cast<const uint4*>(st + r * ROW + p * PER);
      }
      named_sync(1 + cw, 128);  // the tile is read before the next one writes it
    }
  }
}

// A 3-D map (inner, rows, matrices) of a bf16 operand, boxes of 64 inner
// elements × `rows`; a broadcast operand (batch stride 0) has one matrix
static bool operand_map(CUtensorMap* map, const void* ptr, int inner, int rows, int batch,
                        long long stride, int box_rows) {
  const bool bcast = stride == 0;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)(bcast ? 1 : batch)};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2,
                                 (cuuint64_t)(bcast ? (long long)inner * rows : stride) * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return encode_bf16_sw128(map, ptr, 3, dims, strides, box);
}

// C (or the split-K workspace, TO = float) from the plan's `blocks`; the
// caller has checked what TMA needs: 16-byte aligned bases, K and N
// multiples of 8, batch strides multiples of 8 elements
template <typename TO>
int launch(const void* A, const void* B, TO* C, int M, int N, int K, int batch, long long sA,
           long long sB, int split, int k_chunk, int blocks, cudaStream_t stream) {
  CUtensorMap ta, tb;
  if (!operand_map(&ta, A, K, M, batch, sA, BM) || !operand_map(&tb, B, N, K, batch, sB, BK))
    return (int)cudaErrorInvalidValue;
  auto kern = lapis_gemm_sm90_kernel<TO>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  kern<<<blocks, THREADS, SMEM_BYTES, stream>>>(ta, tb, C, M, N, K, batch, split, k_chunk,
                                              sA == 0, sB == 0);
  return (int)cudaGetLastError();
}

}  // namespace gemm_sm90
