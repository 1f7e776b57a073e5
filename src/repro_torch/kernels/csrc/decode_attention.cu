// One-token GQA decode attention on Hopper:
//   out[b, h*rep + g, :] = softmax_s(q[b, h*rep + g] . K[b, h, s] * scale) V[b, h, s]
// over the valid positions s of row b: s < lengths[b], and, with a sliding
// window, s >= lengths[b] - window.  f32 accumulation, output in q's type.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:decode_attention
// (_decode_kernel, pallas_call at decode_attention.py:100).  There the grid is
// (B*Hkv, S/bs) with the S axis sequential: each step multiplies the rep query
// heads of one KV head by a (bs, D) block on the MXU and carries the online
// softmax state (m, l, acc) in VMEM across steps.  Hopper runs blocks in
// parallel and in no order, and B*Hkv is small at decode (16 at 8 slots and
// 2 KV heads, for 132 SMs), so the S axis is split instead: block
// (b*Hkv + h, split) sweeps one chunk of the row's positions.  Inside it each
// of 8 warps takes every 8th group of 4 positions and keeps its own (m, l,
// acc) for the rep query heads in registers (lane i holds elements i, i+32,
// ... of D), scoring a position with a shuffle reduction across the warp; the
// warps merge their states in shared memory.  With one split the block writes
// the output; with several it writes its chunk's (m, l, acc) and a second
// kernel merges the splits of each (row, KV head, query head).  Positions outside
// [lo, hi) are never read, so a short row costs only its own length; a row
// with no valid position writes 0 (the reference kernel's l == 0 guard).  K
// and V are read through their batch, head and position strides (D
// contiguous), so a cache broadcast over the batch with stride 0 (the chunked
// prefill's one gathered row for C query rows) is read in place, never copied.
//
// Query heads come in groups of HB per block, a third grid axis over the
// groups, so any rep fits: each lane keeps HB heads' q and acc (DPL values
// each) in registers, HB = 8 up to D = 128 and 4 at D = 256 (recurrentgemma:
// 16 query heads over one KV head of 256), and the warps' merge buffers,
// [8 warps][HB][32 * DPL] floats, stay at 32 KB of static shared memory.
// The groups of one (row, KV head, chunk) read the same K and V, from L2
// after the first.
//
// Bound: bytes — q, the valid positions' K and V, and out, once each, over
// HBM bandwidth; the arithmetic is 4 * rep * D operations per position.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lapis_cuda.cuh"

constexpr int DA_WARPS = 8;
constexpr int DA_GROUP = 4;    // positions a warp scores together

__device__ __forceinline__ float da_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// head-dim elements a lane keeps (D up to 32 * DPL)
static int da_dpl(int d) { return d <= 32 ? 1 : d <= 64 ? 2 : d <= 128 ? 4 : 8; }

// query heads a block keeps in registers, HB below: 8 up to DPL 4, 4 at DPL 8,
// so the merge buffers [DA_WARPS][HB][32 * DPL] stay at 32 KB
constexpr int da_heads_per_block(int dpl) { return dpl <= 4 ? 8 : 4; }

template <typename T, int DPL, int HB>
__global__ void __launch_bounds__(DA_WARPS * 32)
lapis_decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const int* __restrict__ lengths,
                              T* __restrict__ out, float* __restrict__ part_ml,
                              float* __restrict__ part_acc, int hkv, int rep, int s_len,
                              int d, long q_sb, long q_sh, long k_sb, long k_sh, long k_ss,
                              long v_sb, long v_sh, long v_ss, int window, float scale,
                              int chunk) {
  __shared__ float sm_m[DA_WARPS][HB];
  __shared__ float sm_l[DA_WARPS][HB];
  __shared__ float sm_acc[DA_WARPS][HB][32 * DPL];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g0 = blockIdx.z * HB;               // this block's first head
  const int nh = min(HB, rep - g0);             // and how many it takes
  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv;
  const int length = lengths[b];
  const int split = blockIdx.y, n_splits = gridDim.y;
  const int hi = min(min(length, s_len), (split + 1) * chunk);
  const int lo = max(window >= 0 ? max(0, length - window) : 0, split * chunk);
  const T* kb = k + (long)b * k_sb + (long)h * k_sh;
  const T* vb = v + (long)b * v_sb + (long)h * v_sh;

  float qr[HB][DPL], acc[HB][DPL], m[HB], l[HB];
#pragma unroll
  for (int g = 0; g < HB; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int dd = lane + 32 * j;
      qr[g][j] = (g < nh && dd < d)
                     ? lapis_load(q, (long)b * q_sb + (long)(h * rep + g0 + g) * q_sh + dd)
                     : 0.f;
      acc[g][j] = 0.f;
    }
  }

  for (int s0 = lo + warp * DA_GROUP; s0 < hi; s0 += DA_WARPS * DA_GROUP) {
    float kr[DA_GROUP][DPL], vr[DA_GROUP][DPL];
#pragma unroll
    for (int p = 0; p < DA_GROUP; ++p) {
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int dd = lane + 32 * j;
        const bool in = s0 + p < hi && dd < d;
        kr[p][j] = in ? lapis_load(kb, (long)(s0 + p) * k_ss + dd) : 0.f;
        vr[p][j] = in ? lapis_load(vb, (long)(s0 + p) * v_ss + dd) : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < HB; ++g) {
      if (g >= nh) continue;     // nh is uniform: no divergence
      float sc[DA_GROUP];
      float cmax = -INFINITY;
#pragma unroll
      for (int p = 0; p < DA_GROUP; ++p) {
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < DPL; ++j) part += qr[g][j] * kr[p][j];
        part = da_warp_sum(part) * scale;
        sc[p] = s0 + p < hi ? part : -INFINITY;
        cmax = fmaxf(cmax, sc[p]);
      }
      // s0 < hi, so position s0 is valid and cmax is finite
      const float mn = fmaxf(m[g], cmax);
      const float alpha = expf(m[g] - mn);
      l[g] *= alpha;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[g][j] *= alpha;
#pragma unroll
      for (int p = 0; p < DA_GROUP; ++p) {
        const float e = expf(sc[p] - mn);
        l[g] += e;
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[g][j] += e * vr[p][j];
      }
      m[g] = mn;
    }
  }

#pragma unroll
  for (int g = 0; g < HB; ++g) {
    if (g >= nh) continue;
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int dd = lane + 32 * j;
      if (dd < d) sm_acc[warp][g][dd] = acc[g][j];
    }
  }
  __syncthreads();
  const int hq = hkv * rep;
  for (int idx = threadIdx.x; idx < nh * d; idx += blockDim.x) {
    const int g = idx / d, dd = idx % d;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < DA_WARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, asum = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < DA_WARPS; ++w) {
        const float e = expf(sm_m[w][g] - mx);
        lsum += sm_l[w][g] * e;
        asum += sm_acc[w][g][dd] * e;
      }
    }
    if (n_splits == 1) {
      lapis_store(out, ((long)b * hq + h * rep + g0 + g) * d + dd,
                  lsum == 0.f ? 0.f : asum / lsum);
    } else {
      const long part = ((long)blockIdx.x * n_splits + split) * rep + g0 + g;
      part_acc[part * d + dd] = asum;
      if (dd == 0) {
        part_ml[2 * part] = mx;
        part_ml[2 * part + 1] = lsum;
      }
    }
  }
}

// merges the splits of one (row, KV head, query head g = blockIdx.y):
// out = sum_s e_s acc_s / sum_s e_s l_s with e_s = exp(m_s - max_s m_s)
template <typename T>
__global__ void __launch_bounds__(DA_WARPS * 32)
lapis_decode_attention_merge(const float* __restrict__ part_ml,
                             const float* __restrict__ part_acc, T* __restrict__ out,
                             int hkv, int rep, int d, int n_splits) {
  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv, hq = hkv * rep;
  const int g = blockIdx.y;
  for (int dd = threadIdx.x; dd < d; dd += blockDim.x) {
    const long first = (long)blockIdx.x * n_splits * rep + g;
    float mx = -INFINITY;
    for (int sp = 0; sp < n_splits; ++sp) mx = fmaxf(mx, part_ml[2 * (first + (long)sp * rep)]);
    float lsum = 0.f, asum = 0.f;
    if (mx != -INFINITY) {
      for (int sp = 0; sp < n_splits; ++sp) {
        const long part = first + (long)sp * rep;
        const float e = expf(part_ml[2 * part] - mx);
        lsum += part_ml[2 * part + 1] * e;
        asum += part_acc[part * d + dd] * e;
      }
    }
    lapis_store(out, ((long)b * hq + h * rep + g) * d + dd,
                lsum == 0.f ? 0.f : asum / lsum);
  }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, const void* lengths, void* out,
                  void* part_ml, void* part_acc, int batch, int hkv, int rep, int s_len, int d,
                  long q_sb, long q_sh, long k_sb, long k_sh, long k_ss, long v_sb, long v_sh,
                  long v_ss, int window, float scale, int n_splits, int chunk, void* stream) {
  if (batch < 0 || hkv <= 0 || rep <= 0 || s_len < 0 || d <= 0 || d > 256 ||
      (long)batch * hkv > 2147483647L || n_splits < 1 || n_splits > 65535 ||
      chunk <= 0 || (long)n_splits * chunk < s_len ||
      (n_splits > 1 && (part_ml == nullptr || part_acc == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const int dpl = da_dpl(d), hb = da_heads_per_block(dpl);
  const int n_groups = (rep + hb - 1) / hb;
  if (n_groups > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(batch * hkv, n_splits, n_groups), block(DA_WARPS * 32);
  cudaStream_t st = (cudaStream_t)stream;
#define LAPIS_DA_LAUNCH(DPL)                                                                \
  case DPL:                                                                                 \
    lapis_decode_attention_kernel<T, DPL, da_heads_per_block(DPL)><<<grid, block, 0, st>>>( \
        (const T*)q, (const T*)k, (const T*)v, (const int*)lengths, (T*)out,                \
        (float*)part_ml, (float*)part_acc, hkv, rep, s_len, d, q_sb, q_sh, k_sb, k_sh, k_ss, \
        v_sb, v_sh, v_ss, window, scale, chunk);                                            \
    break
  switch (dpl) {
    LAPIS_DA_LAUNCH(1);
    LAPIS_DA_LAUNCH(2);
    LAPIS_DA_LAUNCH(4);
    LAPIS_DA_LAUNCH(8);
  }
#undef LAPIS_DA_LAUNCH
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return (int)err;
  if (rep > 65535) return (int)cudaErrorInvalidValue;
  lapis_decode_attention_merge<T><<<dim3(batch * hkv, rep), DA_WARPS * 32, 0, st>>>(
      (const float*)part_ml, (const float*)part_acc, (T*)out, hkv, rep, d, n_splits);
  return (int)cudaGetLastError();
}

#define LAPIS_DA_EXPORT(NAME, T)                                                             \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* lengths,       \
                      void* out, void* part_ml, void* part_acc, int batch, int hkv, int rep,  \
                      int s_len, int d, long q_sb, long q_sh, long k_sb, long k_sh,           \
                      long k_ss, long v_sb, long v_sh, long v_ss, int window, float scale,    \
                      int n_splits, int chunk, void* stream) {                                \
    return launch<T>(q, k, v, lengths, out, part_ml, part_acc, batch, hkv, rep, s_len, d,     \
                     q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, window, scale, n_splits, \
                     chunk, stream);                                                          \
  }
LAPIS_DA_EXPORT(lapis_decode_attention_f32, float)
LAPIS_DA_EXPORT(lapis_decode_attention_bf16, __nv_bfloat16)

// the query heads one block takes at head dim d (the Python wrapper sizes
// its split plan by the number of head groups)
extern "C" int lapis_decode_attention_heads_per_block(int d) {
  return da_heads_per_block(da_dpl(d));
}
