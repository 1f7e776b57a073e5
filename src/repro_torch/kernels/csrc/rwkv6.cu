// RWKV6 (Finch) WKV scan on Hopper, for every (batch b, head h):
//   y[b, t, h, :] = r_t . (S + diag(u[h]) k_t v_t^T)
//   S             = diag(w_t) S + k_t v_t^T
// with the state S (K x V) in f32, from the given initial state (or zeros),
// and the final S written out.  y is written in the inputs' type.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6.py:rwkv6_scan
// (_wkv_kernel, pallas_call at rwkv6.py:78).  There the grid is
// (B*H, T/chunk) with the time axis sequential ("arbitrary"), the (K, V)
// state in VMEM scratch across the sweep, r/k/v/w streamed through VMEM in
// time chunks, and the time tail padded with w = 1; it always starts from
// zero and returns no state.  Hopper's blocks run in parallel and carry
// nothing between them, so one block owns one (b, h) and walks all of time
// itself, with 4 threads per state column: thread (q, j) keeps rows
// q*K/4 .. (q+1)*K/4 of column j of S in registers.
// The bonus term factors out of the (k, v) work:
//   y_t[j] = sum_k r_t[k] S[k, j] + v_t[j] c_t,  c_t = sum_k r_t[k] u[k] k_t[k],
// so per (t, k, v) a thread does one FMA for y and a multiply and an FMA
// for S, and c_t costs O(K) per step, a warp reduction per time step.
// For a chunk of time steps the block stages r, k, w and v in shared memory
// as f32 (coalesced along the contiguous last dim, read through the
// (b, t, h) strides, so nothing is transposed or padded: the last chunk is
// just shorter; rows past K are zeros, which keep their state at zero) and
// each warp reduces c_t for some of its steps; then each thread steps
// through the chunk reading its rows of r, k and w as float4 broadcasts and
// leaves its partial sum of y_t[j] in shared memory; after the chunk the
// block adds the four partial sums and v_t[j] c_t and writes y.  The
// initial state is read and the final state written by the same launch, so
// the serving prefill needs no second (plain) scan for its decode state.
//
// Bound: operations — 5 f32 operations per (t, k, v) (and 3 K + 2 V per
// step) against 2 bytes read or written per (t, k) and (t, v) in bf16: at
// K = V = 64 that is 32 operations per byte, above the 20 per byte at
// which the FP32 rate (67 TFLOP/s) and HBM (3.35 TB/s) balance.  Only B*H
// blocks run (160 of 256 threads at the serving shape), and each thread's
// time steps are a chain: latency, not a rate, bounds it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lapis_cuda.cuh"

constexpr int WKV_SPLIT = 4;             // threads per state column
constexpr int WKV_SMEM_FLOATS = 12288;   // 48 KB of staged inputs per block
constexpr int WKV_MAX_V = 1024 / WKV_SPLIT;

__device__ __forceinline__ float wkv_warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// NT: the most threads a launch gives the block (4 * vd), so the compiler
// may keep more registers where the block is small
template <typename T, int KMAX, int NT>
__global__ void __launch_bounds__(NT)
lapis_rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ w, const T* __restrict__ u,
                   const float* __restrict__ s_in, T* __restrict__ y, float* __restrict__ s_out,
                   int n_heads, int t_len, int kd, int vd, long rs_b, long rs_t, long rs_h,
                   long ks_b, long ks_t, long ks_h, long vs_b, long vs_t, long vs_h, long ws_b,
                   long ws_t, long ws_h, int chunk) {
  constexpr int KPT = KMAX / WKV_SPLIT;   // state rows a thread keeps
  extern __shared__ __align__(16) float smem[];
  float* us = smem;                  // [KMAX] u[h], rows past kd zero
  float* rs = us + KMAX;             // [chunk][KMAX], rows past kd zero
  float* kks = rs + chunk * KMAX;    // [chunk][KMAX]
  float* wss = kks + chunk * KMAX;   // [chunk][KMAX]
  float* vss = wss + chunk * KMAX;   // [chunk][vd]
  float* cs = vss + chunk * vd;      // [chunk] c_t = sum_k r_t[k] u[k] k_t[k]
  float* yp = cs + chunk;            // [WKV_SPLIT][chunk][vd] partial sums of y
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid % 32, warp = tid / 32, nwarps = nthreads / 32;
  const int j = tid % vd, kq = tid / vd;   // column j, rows kq*KPT .. +KPT
  const int b = blockIdx.x / n_heads, h = blockIdx.x % n_heads;
  const long bh = (long)blockIdx.x;

  float s[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int row = kq * KPT + i;
    s[i] = (row < kd && s_in != nullptr) ? s_in[(bh * kd + row) * vd + j] : 0.f;
  }
  for (int i = tid; i < KMAX; i += nthreads)
    us[i] = i < kd ? lapis_load(u, (long)h * kd + i) : 0.f;
  const T* rb = r + (long)b * rs_b + (long)h * rs_h;
  const T* kb = k + (long)b * ks_b + (long)h * ks_h;
  const T* vb = v + (long)b * vs_b + (long)h * vs_h;
  const T* wb = w + (long)b * ws_b + (long)h * ws_h;
  const long ys_t = (long)n_heads * vd;
  T* yb = y + ((long)b * t_len * n_heads + h) * vd;

  for (int t0 = 0; t0 < t_len; t0 += chunk) {
    const int n = min(chunk, t_len - t0);
    __syncthreads();   // the previous chunk's reads of the staged arrays are done
#pragma unroll 4
    for (int idx = tid; idx < n * KMAX; idx += nthreads) {
      const int tt = idx / KMAX, i = idx % KMAX;
      const long t = t0 + tt;
      const bool in = i < kd;
      rs[idx] = in ? lapis_load(rb, t * rs_t + i) : 0.f;
      kks[idx] = in ? lapis_load(kb, t * ks_t + i) : 0.f;
      wss[idx] = in ? lapis_load(wb, t * ws_t + i) : 0.f;
    }
#pragma unroll 4
    for (int idx = tid; idx < n * vd; idx += nthreads) {
      const int tt = idx / vd, i = idx % vd;
      vss[idx] = lapis_load(vb, (long)(t0 + tt) * vs_t + i);
    }
    __syncthreads();
    // c_t, read after the chunk's last sync: a warp reduction per step
    // when the block has whole warps (4 * vd a multiple of 32), else a
    // thread per step
    if (nwarps > 0) {
      for (int tt = warp; warp < nwarps && tt < n; tt += nwarps) {
        float c = 0.f;
#pragma unroll
        for (int i = lane; i < KMAX; i += 32)
          c += rs[tt * KMAX + i] * us[i] * kks[tt * KMAX + i];
        c = wkv_warp_sum(c);
        if (lane == 0) cs[tt] = c;
      }
    } else {
      for (int tt = tid; tt < n; tt += nthreads) {
        float c = 0.f;
        for (int i = 0; i < KMAX; ++i) c += rs[tt * KMAX + i] * us[i] * kks[tt * KMAX + i];
        cs[tt] = c;
      }
    }
    for (int tt = 0; tt < n; ++tt) {
      const float vj = vss[tt * vd + j];
      const float4* r4 = reinterpret_cast<const float4*>(rs + tt * KMAX + kq * KPT);
      const float4* k4 = reinterpret_cast<const float4*>(kks + tt * KMAX + kq * KPT);
      const float4* w4 = reinterpret_cast<const float4*>(wss + tt * KMAX + kq * KPT);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < KPT / 4; ++q) {
        const float4 rr = r4[q], kk = k4[q], ww = w4[q];
        const float rv[4] = {rr.x, rr.y, rr.z, rr.w};
        const float kv4[4] = {kk.x, kk.y, kk.z, kk.w};
        const float wv[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e;
          acc[e] += rv[e] * s[i];
          s[i] = wv[e] * s[i] + kv4[e] * vj;
        }
      }
      yp[(kq * chunk + tt) * vd + j] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
    __syncthreads();
    for (int idx = tid; idx < n * vd; idx += nthreads) {
      const int tt = idx / vd, jj = idx % vd;
      float sum = vss[tt * vd + jj] * cs[tt];
#pragma unroll
      for (int q = 0; q < WKV_SPLIT; ++q) sum += yp[(q * chunk + tt) * vd + jj];
      lapis_store(yb, (long)(t0 + tt) * ys_t + jj, sum);
    }
  }
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int row = kq * KPT + i;
    if (row < kd) s_out[(bh * kd + row) * vd + j] = s[i];
  }
}

template <typename T, int KMAX, int NT>
static int launch_k(const void* r, const void* k, const void* v, const void* w, const void* u,
                    const void* s_in, void* y, void* s_out, int batch, int n_heads, int t_len,
                    int kd, int vd, const long* st, cudaStream_t stream) {
  const int per_step = 3 * KMAX + (1 + WKV_SPLIT) * vd + 1;   // floats a step stages
  int chunk = (WKV_SMEM_FLOATS - KMAX) / per_step;
  if (chunk > 64) chunk = 64;
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  const int bytes = (KMAX + chunk * per_step) * (int)sizeof(float);
  lapis_rwkv6_kernel<T, KMAX, NT><<<batch * n_heads, WKV_SPLIT * vd, bytes, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, (const T*)u, (const float*)s_in,
      (T*)y, (float*)s_out, n_heads, t_len, kd, vd, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], chunk);
  return (int)cudaGetLastError();
}

// strides: r, k, v, w, each (batch, time, head), in elements; the last dim
// is contiguous in all four; u (heads, kd), the states (batch, heads, kd, vd)
// and y (batch, time, heads, vd) are contiguous
template <typename T>
static int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                  const void* s_in, void* y, void* s_out, int batch, int n_heads, int t_len,
                  int kd, int vd, const long* strides, void* stream) {
  if (batch < 0 || n_heads <= 0 || t_len < 0 || kd <= 0 || kd > 128 || vd <= 0 ||
      vd > WKV_MAX_V || (long)batch * n_heads > 2147483647L)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define LAPIS_WKV_LAUNCH(KMAX)                                                             \
  return vd <= 64 ? launch_k<T, KMAX, WKV_SPLIT * 64>(r, k, v, w, u, s_in, y, s_out, batch, \
                                                      n_heads, t_len, kd, vd, strides, st)  \
                  : launch_k<T, KMAX, WKV_SPLIT * WKV_MAX_V>(                              \
                        r, k, v, w, u, s_in, y, s_out, batch, n_heads, t_len, kd, vd,      \
                        strides, st)
  if (kd <= 16) LAPIS_WKV_LAUNCH(16);
  if (kd <= 32) LAPIS_WKV_LAUNCH(32);
  if (kd <= 64) LAPIS_WKV_LAUNCH(64);
  LAPIS_WKV_LAUNCH(128);
#undef LAPIS_WKV_LAUNCH
}

#define LAPIS_WKV_EXPORT(NAME, T)                                                            \
  extern "C" int NAME(const void* r, const void* k, const void* v, const void* w,            \
                      const void* u, const void* s_in, void* y, void* s_out, int batch,      \
                      int n_heads, int t_len, int kd, int vd, const long* strides,           \
                      void* stream) {                                                        \
    return launch<T>(r, k, v, w, u, s_in, y, s_out, batch, n_heads, t_len, kd, vd, strides,  \
                     stream);                                                                \
  }
LAPIS_WKV_EXPORT(lapis_rwkv6_f32, float)
LAPIS_WKV_EXPORT(lapis_rwkv6_bf16, __nv_bfloat16)
