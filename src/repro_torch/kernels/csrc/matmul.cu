// kk.gemm on Hopper: C[M,N] = A[M,K] · B[K,N], f32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py:matmul
// (_matmul_kernel, pallas_call at matmul.py:57).  There the grid is
// (M/bm, N/bn, K/bk) with K an "arbitrary" (sequential) grid axis that
// accumulates into a VMEM scratch tile, and the inputs are zero-padded to
// block multiples.  On the H100 thread blocks run in parallel and in no
// order, so the K sweep becomes a loop inside each block (or a few K
// ranges summed by a second kernel where the tiles alone cannot fill the
// card), and the kernels mask the ragged edges themselves instead of
// padding copies.
//
// Two routes, chosen by gemm.cuh's plan: bf16 inputs TMA can address run
// on the tensor cores (gemm_sm90.cuh: wgmma fed by a TMA ring); f32, and
// bf16 that TMA cannot address, on the FP32 pipes (gemm_tile.cuh: FFMA
// behind a cp.async ring).  At the shapes of the qwen2-1.5b MLP block the
// arithmetic intensity is far above the memory ridge, so the bf16
// tensor-core rate or the FP32 rate bounds them.
//
// One library holds every tile; the map_parallelism pass's tiling no
// longer instantiates it (kernels/matmul.py says how the two relate).
#include "gemm.cuh"

// ws / ws_bytes: the f32 split-K workspace of the plan (null and 0 where
// it does not split K)
#define LAPIS_MATMUL_ENTRY(NAME, TI, TO)                                                  \
  extern "C" int NAME(const void* A, const void* B, void* C, void* ws, long long ws_bytes, \
                      int M, int N, int K, void* stream) {                                \
    return gemm::run<TI, TO>(A, B, C, ws, ws_bytes, 1, M, N, K, 0, 0,                     \
                             (cudaStream_t)stream);                                       \
  }

LAPIS_MATMUL_ENTRY(lapis_matmul_f32, float, float)
LAPIS_MATMUL_ENTRY(lapis_matmul_bf16, __nv_bfloat16, __nv_bfloat16)
LAPIS_MATMUL_ENTRY(lapis_matmul_bf16_f32out, __nv_bfloat16, float)
