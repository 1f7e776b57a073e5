// Flash-attention forward on Hopper (GQA, causal / sliding-window masks,
// optional tanh logit softcap, Sq != Skv):
//   out[b, h, i] = softmax_j(mask(cap(q[b, h, i] . k[b, h / group, j] * scale))) v[b, h / group, j]
// f32 accumulation and online softmax, output in q's type.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention
// (_attn_kernel, pallas_call at flash_attention.py:120).  There the grid is
// (B*Hq, Sq/bq, Skv/bkv) with the KV axis sequential, carrying (m, l, acc) in
// VMEM, and the q head's KV head comes from the index map (h // group).  Here
// one thread block takes one (b*Hq + h, 64-query tile) and loops over the KV
// tiles itself, since Hopper's blocks run in no order and carry nothing
// between them.  The query tile and each 64-position K and V tile are staged
// in shared memory as f32 (rows padded by one word, so the 16 threads that
// share a query row read 16 different banks); the 256 threads form a 16 x 16
// grid in which thread (ty, tx) owns query rows ty + 16i and key columns
// tx + 16j (i, j < 4) of the score tile and output columns tx + 16jj of D.
// Row maxima and sums reduce with shuffles over the 16 threads of a row; the
// probabilities pass to the P.V product through shared memory.  A KV tile
// wholly above the causal diagonal or wholly before the window is skipped
// before it is loaded (the reference's pl.when), and positions past Skv are
// masked, their V rows zeroed.  A row with no valid key writes 0.
//
// Head dims are multiples of 16 up to 256 (recurrentgemma's local
// attention): at 256 the staged tiles take 214 KB of shared memory, inside
// the 227 KB a block may opt in to, and each thread accumulates 4 x 16
// output columns in registers.
//
// Bound: the FP32 FFMA rate outside the tensor cores for the unmasked
// (q, k) pairs (4 * D operations each); bytes at HBM bandwidth for short
// sequences.  This is the f32 path: tensor cores would not meet its bar.
// bf16 runs flash_attention_sm90.cu (wgmma fed by TMA).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lapis_cuda.cuh"

constexpr int FA_BQ = 64, FA_BKV = 64, FA_THREADS = 256;

template <int DJ>
constexpr int fa_smem_floats() {
  return FA_BQ * (16 * DJ + 1) + 2 * FA_BKV * (16 * DJ + 1) + FA_BQ * (FA_BKV + 1);
}

template <typename T, int DJ>
__global__ void __launch_bounds__(FA_THREADS)
lapis_flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ out, int hq, int group,
                             int sq, int skv, long q_sb, long q_sh, long q_ss, long k_sb,
                             long k_sh, long k_ss, long v_sb, long v_sh, long v_ss, int causal,
                             int window, float scale, float softcap) {
  constexpr int D = 16 * DJ, LD = D + 1, LP = FA_BKV + 1;
  extern __shared__ float smem[];
  float* qs = smem;                  // [FA_BQ][LD]
  float* ks = qs + FA_BQ * LD;       // [FA_BKV][LD]
  float* vs = ks + FA_BKV * LD;      // [FA_BKV][LD]
  float* ps = vs + FA_BKV * LD;      // [FA_BQ][LP]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, b = bh / hq, h = bh % hq, hk = h / group;
  const int q0 = blockIdx.x * FA_BQ;
  const T* qb = q + (long)b * q_sb + (long)h * q_sh;
  const T* kb = k + (long)b * k_sb + (long)hk * k_sh;
  const T* vb = v + (long)b * v_sb + (long)hk * v_sh;

  for (int idx = threadIdx.x; idx < FA_BQ * D; idx += FA_THREADS) {
    const int r = idx / D, dd = idx % D;
    qs[r * LD + dd] = q0 + r < sq ? lapis_load(qb, (long)(q0 + r) * q_ss + dd) : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }

  const int tiles = (skv + FA_BKV - 1) / FA_BKV;
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * FA_BKV;
    if (causal && k0 > q0 + FA_BQ - 1) continue;              // above the diagonal
    if (window >= 0 && k0 + FA_BKV - 1 <= q0 - window) continue;  // before the window
    __syncthreads();   // the previous tile's reads are done (and q is staged)
    for (int idx = threadIdx.x; idx < FA_BKV * D; idx += FA_THREADS) {
      const int j = idx / D, dd = idx % D;
      const bool in = k0 + j < skv;
      ks[j * LD + dd] = in ? lapis_load(kb, (long)(k0 + j) * k_ss + dd) : 0.f;
      vs[j * LD + dd] = in ? lapis_load(vb, (long)(k0 + j) * v_ss + dd) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * LD + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * LD + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool ok = kpos < skv && (!causal || kpos <= qpos) &&
                        (window < 0 || kpos > qpos - window);
        s[i][j] = ok ? x : -INFINITY;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float mn = fmaxf(m[i], rmax);
      const float base = mn == -INFINITY ? 0.f : mn;   // no valid key yet
      const float alpha = expf(m[i] - base);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - base);
        rsum += p;
        ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= alpha;
      m[i] = mn;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < FA_BKV; ++j) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * LP + j];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) vv[jj] = vs[j * LD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) acc[i][jj] += pv[i] * vv[jj];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sq) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      lapis_store(out, ((long)bh * sq + r) * D + tx + 16 * jj,
                  l[i] == 0.f ? 0.f : acc[i][jj] / l[i]);
  }
}

template <typename T, int DJ>
static int launch_dj(const void* q, const void* k, const void* v, void* out, int batch, int hq,
                     int group, int sq, int skv, const long* st, int causal, int window,
                     float scale, float softcap, cudaStream_t stream) {
  constexpr int bytes = fa_smem_floats<DJ>() * (int)sizeof(float);
  auto kern = lapis_flash_attention_kernel<T, DJ>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + FA_BQ - 1) / FA_BQ, batch * hq);
  kern<<<grid, FA_THREADS, bytes, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)out, hq,
                                            group, sq, skv, st[0], st[1], st[2], st[3], st[4],
                                            st[5], st[6], st[7], st[8], causal, window, scale,
                                            softcap);
  return (int)cudaGetLastError();
}

// strides: q (batch, head, position), k (same), v (same), in elements; D is
// contiguous in all three
template <typename T>
static int launch(const void* q, const void* k, const void* v, void* out, int batch, int hq,
                  int hkv, int sq, int skv, int d, const long* strides, int causal, int window,
                  float scale, float softcap, void* stream) {
  if (batch < 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq < 0 || skv < 0 || d <= 0 ||
      d % 16 != 0 || d > 256 || (long)batch * hq > 65535L)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || sq == 0) return 0;
  const int group = hq / hkv;
  cudaStream_t st = (cudaStream_t)stream;
  switch (d / 16) {
#define LAPIS_FA_CASE(DJ) \
  case DJ:                \
    return launch_dj<T, DJ>(q, k, v, out, batch, hq, group, sq, skv, strides, causal, window, \
                            scale, softcap, st);
    LAPIS_FA_CASE(1)
    LAPIS_FA_CASE(2)
    LAPIS_FA_CASE(3)
    LAPIS_FA_CASE(4)
    LAPIS_FA_CASE(5)
    LAPIS_FA_CASE(6)
    LAPIS_FA_CASE(7)
    LAPIS_FA_CASE(8)
    LAPIS_FA_CASE(9)
    LAPIS_FA_CASE(10)
    LAPIS_FA_CASE(11)
    LAPIS_FA_CASE(12)
    LAPIS_FA_CASE(13)
    LAPIS_FA_CASE(14)
    LAPIS_FA_CASE(15)
    LAPIS_FA_CASE(16)
#undef LAPIS_FA_CASE
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int lapis_flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                         int batch, int hq, int hkv, int sq, int skv, int d,
                                         const long* strides, int causal, int window,
                                         float scale, float softcap, void* stream) {
  return launch<float>(q, k, v, out, batch, hq, hkv, sq, skv, d, strides, causal, window,
                       scale, softcap, stream);
}
