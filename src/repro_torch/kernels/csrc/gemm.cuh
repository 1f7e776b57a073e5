// The launch plan and the router of kk.gemm and the tiled
// kk.batched_gemm (matmul.cu and batched_gemm.cu include it): one
// library per kernel with every tile compiled in, the tile chosen here
// from the extents and the card, not from the IR's tiling.
//
// gemm_plan (exported as lapis_gemm_plan; its twin is
// kernels/matmul.py::gemm_plan, held to it on the card) picks:
//
// * the route: bf16 inputs TMA can address (16-byte aligned bases and
//   batch strides, K and N multiples of 8) go to the wgmma kernel of
//   gemm_sm90.cuh; f32, and the bf16 products TMA cannot address, to the
//   FFMA kernel of gemm_tile.cuh;
// * the fold: B shared by the batch (batch stride 0) and A's matrices
//   packed (stride M·K) make one product of batch·M rows;
// * the tile: 128 × 128 on wgmma; on FFMA the one of 128 × 128, 128 × 64
//   and 64 × 64 whose busiest SM has the least work (whole tiles per SM
//   times its area, weighted by what the smaller tiles lose to shared
//   memory traffic);
// * split-K, K cut into ranges of whole K steps: on FFMA, jointly with
//   the tile, where two to four ranges of at least BALANCE_MIN_K even out
//   the SMs' work by more than the reduce costs (the MLP block's 2048 ×
//   8960 × 1536: 192 tiles of 128² are 1.45 an SM, 384 half-deep ones
//   2.9); on either route, where the tiles fill at most a quarter of the
//   132 SMs and K is long (ResNet18's fc, 8 × 512 × 1000: 16 tiles), until
//   the grid has about two blocks an SM.  The partial products go to an
//   f32 workspace the caller allocates and a second kernel sums them in a
//   fixed order (the same bits every call; no atomics);
// * the grid — on wgmma one block an SM (at most one a tile), each
//   walking the tiles in order; on FFMA (M tiles, N tiles, batch · split
//   up to 65,535, the rest walked by the blocks) — and the dynamic shared
//   memory.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"
#include "gemm_tile.cuh"

namespace gemm {

constexpr int SMS = 132;           // H100 SXM
constexpr int MAX_GRID_Z = 65535;
constexpr int ROUTE_FFMA = 0, ROUTE_WGMMA = 1;
constexpr int SPLIT_MIN_K = 256;   // "long" K: at least this deep to split
// FFMA tiles and their weight (eighths) per output: what a smaller tile
// loses to shared-memory traffic and fewer warps
constexpr int FFMA_TILES[3][3] = {{128, 128, 8}, {128, 64, 9}, {64, 64, 10}};
constexpr int BALANCE_MIN_K = 1024;   // K range depth a balancing split keeps
constexpr int BALANCE_MAX_SPLIT = 4;
// the split-K reduce in the cost's unit (weighted multiply-adds on one
// SM at the FFMA loop's rate, ~1.2e12 a second): its f32 traffic, 2s + 1
// words an output, at HBM's rate (~2 units a word), and its launch (~5 us)
constexpr long long REDUCE_PER_WORD = 2, REDUCE_LAUNCH = 6000000;

struct Plan {
  int route, bm, bn, bk, threads, stages;
  int m, batch;          // after the fold
  int split, k_chunk;    // K ranges of k_chunk elements (whole K steps)
  int grid_x, grid_y, grid_z;
  int smem;              // dynamic shared memory (bytes)
};

static int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// itemsize: 4 f32 inputs, 2 bf16; aligned: both bases 16-byte aligned and
// both batch strides multiples of 16 bytes; fold: B's batch stride is 0
// and A's is m·k
static Plan gemm_plan(int m, int n, int k, int batch, int itemsize, int aligned, int fold) {
  Plan p;
  const bool f = fold && batch > 1 && (long long)m * batch < (1LL << 31);
  p.m = f ? m * batch : m;
  p.batch = f ? 1 : batch;
  p.route = itemsize == 2 && aligned && k > 0 && k % 8 == 0 && n % 8 == 0 ? ROUTE_WGMMA
                                                                            : ROUTE_FFMA;
  p.split = 1;
  if (p.route == ROUTE_WGMMA) {
    p.bm = gemm_sm90::BM;
    p.bn = gemm_sm90::BN;
    p.bk = gemm_sm90::BK;
    p.threads = gemm_sm90::THREADS;
    p.stages = gemm_sm90::STAGES;
    p.smem = gemm_sm90::SMEM_BYTES;
  } else {
    // the tile and the split whose busiest SM has the least work
    long long best = -1;
    for (const auto& t : FFMA_TILES) {
      const long long tiles = (long long)cdiv(p.m, t[0]) * cdiv(n, t[1]) * p.batch;
      for (int s = 1; s <= BALANCE_MAX_SPLIT; ++s) {
        if (s > 1 && cdiv(k, s) < BALANCE_MIN_K) break;
        const int kc = k > 0 ? cdiv(cdiv(k, s), gemm_ffma::BK) * gemm_ffma::BK : gemm_ffma::BK;
        if (k > 0 && cdiv(k, kc) != s) continue;  // no distinct split
        long long cost = ((tiles * s + SMS - 1) / SMS) * t[0] * t[1] * kc * t[2];
        if (s > 1) cost += REDUCE_PER_WORD * (2 * s + 1) * p.batch * p.m * n + REDUCE_LAUNCH;
        if (best < 0 || cost < best) {
          best = cost;
          p.bm = t[0];
          p.bn = t[1];
          p.split = s;
        }
      }
    }
    using gemm_ffma::Shape;
    p.bk = gemm_ffma::BK;
    p.stages = gemm_ffma::STAGES;
    p.threads = p.bn == 128 ? Shape<128, 128>::THREADS
                : p.bm == 128 ? Shape<128, 64>::THREADS : Shape<64, 64>::THREADS;
    p.smem = p.bn == 128 ? Shape<128, 128>::SMEM_BYTES
             : p.bm == 128 ? Shape<128, 64>::SMEM_BYTES : Shape<64, 64>::SMEM_BYTES;
  }
  p.grid_x = cdiv(p.m, p.bm);
  p.grid_y = cdiv(n, p.bn);
  const long long tiles = (long long)p.grid_x * p.grid_y * p.batch;
  if (4 * tiles <= SMS && k >= SPLIT_MIN_K) {
    // about two blocks an SM, each range at least two K steps deep
    const int want = cdiv(2 * SMS, tiles), most = cdiv(k, 2 * p.bk);
    p.split = want < most ? want : most;
  }
  p.k_chunk = cdiv(cdiv(k, p.split), p.bk) * p.bk;
  if (p.k_chunk == 0) p.k_chunk = p.bk;
  p.split = k > 0 ? cdiv(k, p.k_chunk) : 1;
  const long long z = (long long)p.batch * p.split;
  if (p.route == ROUTE_WGMMA) {  // persistent: one block an SM walks the tiles
    const long long all = tiles * p.split;
    p.grid_x = (int)(all < SMS ? all : SMS);
    p.grid_y = p.grid_z = 1;
  } else {
    p.grid_z = (int)(z < MAX_GRID_Z ? z : MAX_GRID_Z);
  }
  return p;
}

template <typename TI, typename TO>
static int ffma(const Plan& p, const void* A, const void* B, TO* C, int N, int K, long long sA,
                long long sB, cudaStream_t st) {
  const dim3 grid(p.grid_x, p.grid_y, p.grid_z);
  const TI* a = static_cast<const TI*>(A);
  const TI* b = static_cast<const TI*>(B);
  if (p.bm == 128 && p.bn == 128)
    return gemm_ffma::launch<TI, TO, 128, 128>(a, b, C, p.m, N, K, p.batch, sA, sB, p.split,
                                               p.k_chunk, grid, st);
  if (p.bm == 128 && p.bn == 64)
    return gemm_ffma::launch<TI, TO, 128, 64>(a, b, C, p.m, N, K, p.batch, sA, sB, p.split,
                                              p.k_chunk, grid, st);
  return gemm_ffma::launch<TI, TO, 64, 64>(a, b, C, p.m, N, K, p.batch, sA, sB, p.split,
                                           p.k_chunk, grid, st);
}

template <typename TI, typename TO>
static int product(const Plan& p, const void* A, const void* B, TO* C, int N, int K,
                   long long sA, long long sB, cudaStream_t st) {
  if constexpr (sizeof(TI) == 2) {
    if (p.route == ROUTE_WGMMA)
      return gemm_sm90::launch<TO>(A, B, C, p.m, N, K, p.batch, sA, sB, p.split, p.k_chunk,
                                   p.grid_x, st);
  }
  return ffma<TI, TO>(p, A, B, C, N, K, sA, sB, st);
}

// C[b] = A[b] · B[b] for b < batch: A, B with contiguous rows and batch
// strides sA, sB in elements (0: one matrix for the whole batch); C
// contiguous; ws: at least split · batch · M · N f32 of workspace where
// the plan splits K (ws_bytes says how much there is).  Returns the
// cudaError_t of the launches.
template <typename TI, typename TO>
int run(const void* A, const void* B, void* C, void* ws, long long ws_bytes, int batch, int M,
        int N, int K, long long sA, long long sB, cudaStream_t st) {
  if (batch < 1 || M < 0 || N < 0 || K < 0) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const int item = (int)sizeof(TI);
  const int aligned = reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(B) % 16 == 0 && (sA * item) % 16 == 0 &&
                      (sB * item) % 16 == 0;
  const int fold = batch > 1 && sB == 0 && sA == (long long)M * K;
  const Plan p = gemm_plan(M, N, K, batch, item, aligned, fold);
  if (p.split == 1) return product<TI, TO>(p, A, B, static_cast<TO*>(C), N, K, sA, sB, st);
  const long long total = (long long)p.batch * p.m * N;
  if (ws == nullptr || ws_bytes < 4 * total * p.split) return (int)cudaErrorInvalidValue;
  const int err = product<TI, float>(p, A, B, static_cast<float*>(ws), N, K, sA, sB, st);
  if (err != 0) return err;
  const long long blocks = (total + 255) / 256;
  gemm_ffma::lapis_gemm_splitk_reduce<TO><<<(unsigned)(blocks < 4 * SMS ? blocks : 4 * SMS),
                                            256, 0, st>>>(static_cast<const float*>(ws),
                                                          static_cast<TO*>(C), total, p.split);
  return (int)cudaGetLastError();
}

}  // namespace gemm

// The plan the launchers take for these extents, for tests that hold the
// Python twin to it: route (0 FFMA, 1 wgmma), bm, bn, bk, threads, stages,
// m and batch after the fold, split, k_chunk, grid x, y, z, smem bytes.
extern "C" int lapis_gemm_plan(int m, int n, int k, int batch, int itemsize, int aligned,
                               int fold, int* out) {
  if (m < 1 || n < 1 || k < 0 || batch < 1 || (itemsize != 2 && itemsize != 4))
    return (int)cudaErrorInvalidValue;
  const gemm::Plan p = gemm::gemm_plan(m, n, k, batch, itemsize, aligned, fold);
  const int v[14] = {p.route, p.bm,      p.bn,     p.bk,     p.threads, p.stages, p.m,
                     p.batch, p.split,   p.k_chunk, p.grid_x, p.grid_y, p.grid_z, p.smem};
  for (int i = 0; i < 14; ++i) out[i] = v[i];
  return 0;
}
