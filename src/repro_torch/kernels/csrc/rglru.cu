// RG-LRU scan (recurrentgemma / Griffin) on Hopper, for every (batch b,
// channel d):
//   a_t = exp(-8 softplus(L[d]) sigmoid(r_t)),
//   h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) sigmoid(i_t) x_t,
// with a_t^2 taken as exp(2 (-8 softplus(L[d])) sigmoid(r_t)),
// in f32, from the given initial h (or zeros); y_t = h_t is written in x's
// type and the final h in f32.
//
// Replaces the TPU kernel src/repro/kernels/rglru.py:rglru_scan
// (_rglru_kernel, pallas_call at rglru.py:69).  There the grid is
// (B, D/d_block, T/chunk): channel blocks on the 128 lanes in parallel, time
// sequential with h in VMEM scratch, zero initial state, padded tails.
// Every channel's recurrence is independent, so here one thread owns one
// (b, d), neighbouring threads on neighbouring channels (every load and store
// coalesced along D), and walks time with h in a register.  The loads of a
// group of RG_UNROLL steps are issued before their arithmetic, since they do
// not depend on h: only the one FMA per step that updates h is a chain.
// Blocks of 64 threads spread B*D channels over more SMs (256 blocks at
// B = 4, D = 4096).  The softplus, exp and sqrt forms are ref.rglru_scan's.
// The serving decode calls the same kernel at T = 1 with the cached h.
//
// Bound: bytes — x, r, i read and y written once (2 bytes each in bf16)
// against about 17 f32 operations per element: 2 operations per byte, under
// the 20 per byte at which the FP32 rate and HBM balance.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lapis_cuda.cuh"

constexpr int RG_THREADS = 64, RG_UNROLL = 8;
constexpr float RG_C = 8.0f;

__device__ __forceinline__ float rg_sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// log(1 + exp(x)) as torch.nn.functional.softplus computes it (x above 20: x)
__device__ __forceinline__ float rg_softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}

template <typename T>
__global__ void __launch_bounds__(RG_THREADS)
lapis_rglru_kernel(const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ ig,
                   const T* __restrict__ log_a_param, const float* __restrict__ h_in,
                   T* __restrict__ y, float* __restrict__ h_out, int t_len, int d) {
  const long c = (long)blockIdx.x * RG_THREADS + threadIdx.x;
  const long b = blockIdx.y;
  if (c >= d) return;
  const float log_a = -RG_C * rg_softplus(lapis_load(log_a_param, c));
  float h = h_in != nullptr ? h_in[b * d + c] : 0.f;
  const long base = b * (long)t_len * d + c;
  for (int t0 = 0; t0 < t_len; t0 += RG_UNROLL) {
    float xs[RG_UNROLL], rs[RG_UNROLL], is[RG_UNROLL];
#pragma unroll
    for (int u = 0; u < RG_UNROLL; ++u) {
      const bool in = t0 + u < t_len;
      const long at = base + (long)(t0 + u) * d;
      xs[u] = in ? lapis_load(x, at) : 0.f;
      rs[u] = in ? lapis_load(r, at) : 0.f;
      is[u] = in ? lapis_load(ig, at) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < RG_UNROLL; ++u) {
      if (t0 + u < t_len) {
        const float la_r = log_a * rg_sigmoid(rs[u]);
        const float scale = sqrtf(fmaxf(1.f - expf(2.f * la_r), 1e-12f));
        h = expf(la_r) * h + scale * (rg_sigmoid(is[u]) * xs[u]);
        lapis_store(y, base + (long)(t0 + u) * d, h);
      }
    }
  }
  h_out[b * d + c] = h;
}

template <typename T>
static int launch(const void* x, const void* r, const void* ig, const void* log_a,
                  const void* h_in, void* y, void* h_out, int batch, int t_len, int d,
                  void* stream) {
  if (batch < 0 || batch > 65535 || t_len < 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const dim3 grid((d + RG_THREADS - 1) / RG_THREADS, batch);
  lapis_rglru_kernel<T><<<grid, RG_THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)r, (const T*)ig, (const T*)log_a, (const float*)h_in, (T*)y,
      (float*)h_out, t_len, d);
  return (int)cudaGetLastError();
}

// x, r, i and y: (batch, t_len, d) contiguous; log_a: (d,) in x's type;
// h_in (may be null) and h_out: (batch, d) f32
#define LAPIS_RG_EXPORT(NAME, T)                                                        \
  extern "C" int NAME(const void* x, const void* r, const void* ig, const void* log_a,     \
                      const void* h_in, void* y, void* h_out, int batch, int t_len, int d, \
                      void* stream) {                                                      \
    return launch<T>(x, r, ig, log_a, h_in, y, h_out, batch, t_len, d, stream);         \
  }
LAPIS_RG_EXPORT(lapis_rglru_f32, float)
LAPIS_RG_EXPORT(lapis_rglru_bf16, __nv_bfloat16)
