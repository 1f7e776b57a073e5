// Flash-attention forward on Hopper in f32 (GQA, causal / sliding-window
// masks, optional tanh logit softcap, Sq != Skv):
//   out[b, h, i] = softmax_j(mask(cap(q[b, h, i] . k[b, h / group, j] * scale))) v[b, h / group, j]
// f32 throughout, online softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention
// (_attn_kernel, pallas_call at flash_attention.py:120).  There the grid is
// (B*Hq, Sq/bq, Skv/bkv) with the KV axis sequential, carrying (m, l, acc) in
// VMEM, and the q head's KV head comes from the index map (h // group).  Here
// one thread block takes one (b*Hq + h, 64-query tile) and walks the KV tiles
// itself, since Hopper's blocks run in no order and carry nothing between
// them.
//
// Bound: the FP32 FFMA rate outside the tensor cores for the unmasked
// (q, k) pairs (4 * D operations each).  This is the f32 path: TF32 tensor
// cores would not meet its bar (2e-4 against the plain version, greedy
// tokens equal to the torch target's).  bf16 runs flash_attention_sm90.cu.
//
// The design (plan: plan() below, twin kernels/flash_attention.py::ffma_plan):
// * Register micro-tiles fed by 16-byte shared loads.  A thread owns RM query
//   rows (8 up to D = 128, two groups of 4 consecutive rows; 4 above) and the
//   keys tc + 16 j (j < 4) of the 64-key tile: S = Q.K^T takes RM + 4 LDS.128
//   per 4 * RM * 4 FFMA (12 per 128 at RM = 8).  K rows sit in shared memory
//   with their 16-byte columns XOR-swizzled by the key, so the 8 threads of a
//   load phase (consecutive keys) hit 8 distinct bank groups.
//   P goes to shared memory transposed (key-major, swizzled by the key) and
//   O += P.V takes 2 (or 1) LDS.128 of P and D/64 vector loads of V per
//   RM * D/16 FFMA.  (Q needs no swizzle: a load phase reads one row.)
//   Each query row's 16 threads are one half-warp: row
//   maxima reduce by four shuffles, row sums stay per thread until the end,
//   and P is read back only by the half-warp that wrote it.
// * Loads overlap the arithmetic.  Q is staged once; K and V tiles come by
//   16-byte cp.async into one K slot and one V slot: K(t+1) is in flight
//   during P.V(t), V(t+1) during S(t+1) and its softmax.  Rows past Sq or Skv
//   are zero-filled by the copy (src-size 0).  The wrapper hands the kernel
//   only 16-byte aligned bases and strides (a view that is not is copied).
// * Occupancy.  Up to D = 128 a block is 128 threads and 112 KB of shared
//   memory (Q, K, V of 64 rows and P of 64 x 64, no padding): two blocks an
//   SM.  Above, 256 threads (4 rows each) and up to 208 KB: one block.
// * The heaviest tiles first.  The grid is (B*Hq, Sq/64) with the q tile
//   taken in reverse: the blocks the hardware dispatches first are the last
//   q tiles of every head, whose causal KV walks are the longest.
// * exp2 with log2(e) folded into the scale; masks are applied only on the
//   tiles that cross the diagonal, the window's edge or Skv.  A KV tile wholly
//   above the diagonal or before the window is never loaded.  A row with no
//   valid key writes 0.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "lapis_cuda.cuh"

namespace fa32 {

constexpr int BQ = 64, BKV = 64;
constexpr int SM_SMEM = 233472;   // shared memory an SM has (228 KB)
constexpr int BLOCK_RESERVED = 1024;
constexpr float LOG2E = 1.4426950408889634f;

// The launch of head dim d: threads a block, query rows a thread, the tile
// sizes, the dynamic shared memory, and the blocks an SM's shared memory
// holds (registers may allow fewer; lapis_flash_f32_occupancy asks the card).
struct Plan {
  int threads, rows, block_q, block_kv, smem_bytes, blocks_per_sm;
};

inline Plan plan(int d) {
  const int threads = d <= 128 ? 128 : 256;
  const int rows = d <= 128 ? 8 : 4;
  const int smem = (BQ * d + 2 * BKV * d + BKV * BQ) * (int)sizeof(float);
  int fit = SM_SMEM / (smem + BLOCK_RESERVED);
  if (fit > 2048 / threads) fit = 2048 / threads;
  return {threads, rows, BQ, BKV, smem, fit};
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// DJ = D / 16; RM query rows a thread; NT threads (16 along the keys)
template <int DJ, int RM, int NT>
__global__ void __launch_bounds__(NT)
lapis_flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out, int hq, int group,
                       int sq, int skv, long q_sb, long q_sh, long q_ss, long k_sb, long k_sh,
                       long k_ss, long v_sb, long v_sh, long v_ss, int causal, int window,
                       float scale, float softcap) {
  constexpr int D = 16 * DJ, N4 = D / 4;
  constexpr int TR = NT / 16;               // thread rows
  constexpr int RG = RM / 4;                // groups of 4 consecutive query rows
  constexpr int GS = TR * 4;                // rows between two groups
  static_assert(TR * RM == BQ, "the threads' rows cover the query tile");
  constexpr int LOW = N4 & -N4;             // the swizzle stays inside a row
  constexpr int SWM = (LOW < 8 ? LOW : 8) - 1;
  constexpr int CW = DJ % 4 == 0 ? 4 : (DJ % 2 == 0 ? 2 : 1);   // output columns a vector
  constexpr int NC = DJ / CW;               // vectors a thread: DJ columns
  // unroll factors of the S and P.V loops: the largest that ptxas holds
  // without a spill at every head dim (D = 96 spills at 4 in S)
  constexpr int US = DJ == 6 ? 1 : 4, UP = 8;
  extern __shared__ __align__(16) float smem[];
  float* const qs = smem;                   // [BQ][D]
  float* const ks = qs + BQ * D;            // [BKV][D], swizzled by key
  float* const vs = ks + BKV * D;           // [BKV][D]
  float* const ps = vs + BKV * D;           // [BKV][BQ] P^T, swizzled by key
  const int tid = threadIdx.x, tc = tid & 15, tr = tid >> 4;
  const int bh = blockIdx.x, b = bh / hq, h = bh % hq, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // the longest walks first
  const float* const qb = q + (long)b * q_sb + (long)h * q_sh;
  const float* const kb = k + (long)b * k_sb + (long)hk * k_sh;
  const float* const vb = v + (long)b * v_sb + (long)hk * v_sh;

  const int tiles = (skv + BKV - 1) / BKV;
  int t_lo = 0, t_hi = tiles;
  if (causal && (q0 + BQ - 1) / BKV + 1 < t_hi) t_hi = (q0 + BQ - 1) / BKV + 1;
  if (window >= 0 && q0 - window + 1 > 0) t_lo = (q0 - window + 1) / BKV;

  // 64 rows of D values from row0 on (zero past `limit`) into dst by cp.async
  auto stage = [&](float* dst, const float* src, long stride, int row0, int limit, bool swz) {
#pragma unroll 4
    for (int p = tid; p < 64 * N4; p += NT) {
      const int row = p / N4, c4 = p % N4;
      const bool in = row0 + row < limit;
      cp_async16(dst + row * D + (swz ? c4 ^ (row & SWM) : c4) * 4,
                 in ? src + (long)(row0 + row) * stride + c4 * 4 : src, in);
    }
  };

  float m[RM], l[RM], acc[RM][DJ];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DJ; ++c) acc[i][c] = 0.f;
  }
  if (t_lo < t_hi) {
    stage(qs, qb, q_ss, q0, sq, false);
    stage(ks, kb, k_ss, t_lo * BKV, skv, true);
    cp_async_commit();
    stage(vs, vb, v_ss, t_lo * BKV, skv, false);
    cp_async_commit();
  }
  const float sc2 = scale * LOG2E;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BKV;
    cp_async_wait<1>();   // Q and K(t) have landed (this thread's copies)
    __syncthreads();      // ... everyone's

    // S = Q K^T: RM rows x keys tc + 16 j
    float s[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    const int kx = tc & SWM;   // key & SWM for all four keys
#pragma unroll (US)
    for (int c4 = 0; c4 < N4; ++c4) {
      float4 qv[RM], kv[4];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            qs + ((i / 4) * GS + tr * 4 + i % 4) * D + c4 * 4);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tc + 16 * j) * D + (c4 ^ kx) * 4);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(qv[i], kv[j], s[i][j]);
    }

    // online softmax in the log2 domain; masks only on the edge tiles
    const bool edge = k0 + BKV > skv || (causal && k0 + BKV - 1 > q0) ||
                      (window >= 0 && k0 <= q0 + BQ - 1 - window);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qpos = q0 + (i / 4) * GS + tr * 4 + i % 4;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j];
        x = softcap > 0.f ? softcap * tanhf(x * scale / softcap) * LOG2E : x * sc2;
        if (edge) {
          const int kpos = k0 + tc + 16 * j;
          const bool ok = kpos < skv && (!causal || kpos <= qpos) &&
                          (window < 0 || kpos > qpos - window);
          x = ok ? x : -INFINITY;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float base = mn == -INFINITY ? 0.f : mn;   // no valid key yet
      const float alpha = exp2f(m[i] - base);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - base);
        sum += s[i][j];
      }
      l[i] = fmaf(l[i], alpha, sum);   // this thread's keys; the row sums at the end
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < DJ; ++c) acc[i][c] *= alpha;
    }
    // P^T: key-major, 4 consecutive rows a 16-byte store
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = tc + 16 * j;
#pragma unroll
      for (int g = 0; g < RG; ++g)
        *reinterpret_cast<float4*>(ps + key * BQ + (g * GS / 4 + (tr ^ (key & 7))) * 4) =
            make_float4(s[4 * g][j], s[4 * g + 1][j], s[4 * g + 2][j], s[4 * g + 3][j]);
    }
    cp_async_wait<0>();   // V(t) has landed
    __syncthreads();      // P is written, V is in, and no thread reads K(t) any more
    if (t + 1 < t_hi) stage(ks, kb, k_ss, k0 + BKV, skv, true);
    cp_async_commit();

    // O += P V: RM rows x columns tc * CW + 16 CW c + e
#pragma unroll (UP)
    for (int j = 0; j < BKV; ++j) {
      const int jb = j & 7;   // P^T's swizzle
      float p[RM], vv[DJ];
#pragma unroll
      for (int g = 0; g < RG; ++g) {   // (g GS/4 + tr) ^ jb stays in its 8-group
        const float4 pv = *reinterpret_cast<const float4*>(
            ps + j * BQ + (g * GS / 4 + (tr ^ jb)) * 4);
        p[4 * g] = pv.x, p[4 * g + 1] = pv.y, p[4 * g + 2] = pv.z, p[4 * g + 3] = pv.w;
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float* src = vs + j * D + tc * CW + 16 * CW * c;
        if constexpr (CW == 4) {
          const float4 x = *reinterpret_cast<const float4*>(src);
          vv[4 * c] = x.x, vv[4 * c + 1] = x.y, vv[4 * c + 2] = x.z, vv[4 * c + 3] = x.w;
        } else if constexpr (CW == 2) {
          const float2 x = *reinterpret_cast<const float2*>(src);
          vv[2 * c] = x.x, vv[2 * c + 1] = x.y;
        } else {
          vv[c] = *src;
        }
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < DJ; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
    __syncthreads();      // no thread reads V(t) or P any more
    if (t + 1 < t_hi) stage(vs, vb, v_ss, k0 + BKV, skv, false);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int row = q0 + (i / 4) * GS + tr * 4 + i % 4;
    if (row >= sq) continue;
    float* const dst = out + ((long)bh * sq + row) * D + tc * CW;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float o[CW];
#pragma unroll
      for (int e = 0; e < CW; ++e) o[e] = lt == 0.f ? 0.f : acc[i][CW * c + e] / lt;
      if constexpr (CW == 4) {
        *reinterpret_cast<float4*>(dst + 16 * CW * c) = make_float4(o[0], o[1], o[2], o[3]);
      } else if constexpr (CW == 2) {
        *reinterpret_cast<float2*>(dst + 16 * CW * c) = make_float2(o[0], o[1]);
      } else {
        dst[16 * c] = o[0];
      }
    }
  }
}

template <int DJ>
static auto kernel_of() {
  return lapis_flash_f32_kernel<DJ, DJ <= 8 ? 8 : 4, DJ <= 8 ? 128 : 256>;
}

// call f(std::integral_constant<int, DJ>{}) for DJ = d / 16
template <int DJ = 1, typename F>
static int dispatch(int dj, F&& f) {
  if constexpr (DJ < 16) {
    if (dj != DJ) return dispatch<DJ + 1>(dj, f);
  }
  return f(std::integral_constant<int, DJ>{});
}

static bool aligned16(const void* p, const long* st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st[0] % 4 == 0 && st[1] % 4 == 0 &&
         st[2] % 4 == 0;
}

// strides: q (batch, head, position), k (same), v (same), in elements; D is
// contiguous in all three, every base 16-byte aligned and every stride a
// multiple of 4 elements
static int launch(const void* q, const void* k, const void* v, void* out, int batch, int hq,
                  int hkv, int sq, int skv, int d, const long* st, int causal, int window,
                  float scale, float softcap, void* stream) {
  if (batch < 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq < 0 || skv < 0 || d <= 0 ||
      d % 16 != 0 || d > 256 || (long)batch * hq > 65535L || (sq + BQ - 1) / BQ > 65535 ||
      !aligned16(q, st) || !aligned16(k, st + 3) || !aligned16(v, st + 6))
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || sq == 0) return 0;
  const Plan p = plan(d);
  return dispatch(d / 16, [&](auto dj_c) {
    constexpr int DJ = decltype(dj_c)::value;
    auto kern = kernel_of<DJ>();
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(batch * hq, (sq + BQ - 1) / BQ);
    kern<<<grid, p.threads, p.smem_bytes, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, hq, hq / hkv, sq, skv,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, window, scale,
        softcap);
    return (int)cudaGetLastError();
  });
}

}  // namespace fa32

extern "C" int lapis_flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                         int batch, int hq, int hkv, int sq, int skv, int d,
                                         const long* strides, int causal, int window,
                                         float scale, float softcap, void* stream) {
  return fa32::launch(q, k, v, out, batch, hq, hkv, sq, skv, d, strides, causal, window, scale,
                      softcap, stream);
}

// The launch plan (the twin of kernels/flash_attention.py::ffma_plan):
// threads, rows, block_q, block_kv, smem_bytes, blocks_per_sm.
extern "C" int lapis_flash_f32_plan(int d, int* out) {
  if (d <= 0 || d % 16 != 0 || d > 256) return (int)cudaErrorInvalidValue;
  const fa32::Plan p = fa32::plan(d);
  const int v[6] = {p.threads, p.rows, p.block_q, p.block_kv, p.smem_bytes, p.blocks_per_sm};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// Blocks of head dim d's kernel an SM holds at once, as the card computes it
// (registers and shared memory, after the launcher's shared-memory opt-in).
extern "C" int lapis_flash_f32_occupancy(int d, int* blocks) {
  if (d <= 0 || d % 16 != 0 || d > 256) return (int)cudaErrorInvalidValue;
  const fa32::Plan p = fa32::plan(d);
  return fa32::dispatch(d / 16, [&](auto dj_c) {
    constexpr int DJ = decltype(dj_c)::value;
    auto kern = fa32::kernel_of<DJ>();
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, p.threads, p.smem_bytes);
    return (int)err;
  });
}

