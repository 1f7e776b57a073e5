// Fused AdamW on Hopper: one optimizer step over every leaf of the master
// tree (kernels/adamw.py), in three kernels that never synchronise with the
// host:
//
// 1. lapis_adamw_norm_<g>: one launch a leaf.  Each block sums the squares
//    of its share of the leaf's gradient (16-byte loads, the square rounded
//    in f32 as torch.square rounds it, the sum kept in f64) and writes its
//    total, as f32, to its own slot of a scratch buffer.  No atomics: a
//    leaf's grid depends on its size alone, so every run sums in the same
//    order and gives the same bits.
// 2. lapis_adamw_coef: one block.  It sums the partials in a fixed order
//    and writes the step's coefficients to a small device tensor: the
//    gradient norm, the clip scale, the learning rate of the warmup +
//    cosine schedule at step + 1, and the two bias corrections, each
//    computed by the f32 operations, in the order, that optim/optimizer.py's
//    plain branch runs on the card (a divide by a host scalar there is a
//    multiply by its f32 reciprocal; cosf and powf are the CUDA math
//    library's, as in torch's kernels); it also writes step + 1.
// 3. lapis_adamw_update_<g>_<p>_<mv>: one launch a leaf, grid-stride.  Each
//    thread reads 8 entries of g, p, m and v by 16-byte loads and writes
//    the new p, m and v once, into new tensors (the update stays
//    functional).  Every operation is an _rn intrinsic, in the plain
//    branch's order, so nvcc contracts nothing: without clipping the
//    result is the plain branch's bit for bit.  A bf16 moment (the first
//    step of a bf16 master) is scaled and rounded to bf16 before the add,
//    as torch's bf16 * scalar is; the new moments are f32, the new master
//    in the old one's type.
//
// Replaces no TPU kernel: the reference's optimizer is jnp code that XLA
// fuses.  Added because the port's per-operation update moved about 174
// bytes an entry (the f32 gradient copy, the norm, ten whole-leaf f32
// passes) where the step needs 28.
//
// Bound: bytes.  The gradient is read twice (norm, update), p, m and v are
// read once and written once: 2 + 2 + 3 x 4 + 3 x 4 = 28 B an entry with
// a bf16 gradient and f32 state, about 15 operations an entry.  Unaligned
// views and the tail past the last whole 8 entries take scalar loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "lapis_cuda.cuh"

// The schedule and the clip, as optim/optimizer.py states them; the f32
// constants are the ones torch's kernels receive (see lapis_adamw_coef).
struct AdamwSchedule {
  float lr, inv_warmup, warmup, inv_decay, pi, min_ratio, one_minus_min, b1, b2, clip;
  int clip_on;
};

// The per-entry constants, each the f32 a torch kernel takes for the
// Python float.
struct AdamwHyper {
  float b1, one_minus_b1, b2, one_minus_b2, eps, wd;
};

namespace {

constexpr int THREADS = 256;  // every launch but the coefficients'
constexpr int COEF_THREADS = 1024;

// Eight consecutive entries (chunk c) as f32: two 16-byte loads of f32,
// one of bf16 (exact widening); back with one rounding to bf16.
__device__ __forceinline__ void load8(const float* p, long c, float (&v)[8]) {
  const uint4* q = reinterpret_cast<const uint4*>(p) + 2 * c;
  const uint4 a = __ldg(q), b = __ldg(q + 1);
  v[0] = __uint_as_float(a.x), v[1] = __uint_as_float(a.y);
  v[2] = __uint_as_float(a.z), v[3] = __uint_as_float(a.w);
  v[4] = __uint_as_float(b.x), v[5] = __uint_as_float(b.y);
  v[6] = __uint_as_float(b.z), v[7] = __uint_as_float(b.w);
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, long c, float (&v)[8]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p) + c);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store8(float* p, long c, const float (&v)[8]) {
  uint4* q = reinterpret_cast<uint4*>(p) + 2 * c;
  q[0] = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
  q[1] = make_uint4(__float_as_uint(v[4]), __float_as_uint(v[5]), __float_as_uint(v[6]),
                    __float_as_uint(v[7]));
}
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, long c, const float (&v)[8]) {
  reinterpret_cast<uint4*>(p)[c] =
      make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
}

// x as a tensor of T holds it: f32 unchanged, bf16 rounded to nearest even.
template <typename T>
__device__ __forceinline__ float held(float x);
template <>
__device__ __forceinline__ float held<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float held<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The sum over the block in a fixed order: shuffles within each warp, then
// thread 0 adds the warps' sums in warp order.  Valid on thread 0.
__device__ __forceinline__ double block_sum(double v, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    v = red[0];
    for (int w = 1; w < (int)blockDim.x / 32; ++w) v += red[w];
  }
  return v;
}

template <typename TG>
__device__ __forceinline__ void norm_body(const TG* __restrict__ g, long n, float* __restrict__ partial,
                                          int vec) {
  __shared__ double red[THREADS / 32];
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long stride = (long)gridDim.x * blockDim.x;
  double acc = 0.0;
  long tail = 0;
  if (vec) {
    const long chunks = n / 8;
    for (long c = tid; c < chunks; c += stride) {
      float x[8];
      load8(g, c, x);
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += (double)__fmul_rn(x[k], x[k]);
    }
    tail = chunks * 8;
  }
  for (long i = tail + tid; i < n; i += stride) {
    const float x = lapis_load(g, i);
    acc += (double)__fmul_rn(x, x);
  }
  acc = block_sum(acc, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = (float)acc;
}

// One entry: optim/optimizer.py's plain update, operation by operation.
template <typename TM>
__device__ __forceinline__ void adamw1(float g, float p, float m, float v, const AdamwHyper& h,
                                       float lr, float scale, float bc1, float bc2, float& np,
                                       float& nm, float& nv) {
  g = __fmul_rn(g, scale);
  nm = __fadd_rn(held<TM>(__fmul_rn(m, h.b1)), __fmul_rn(g, h.one_minus_b1));
  nv = __fadd_rn(held<TM>(__fmul_rn(v, h.b2)), __fmul_rn(__fmul_rn(g, g), h.one_minus_b2));
  const float mh = __fdiv_rn(nm, bc1);
  const float vh = __fdiv_rn(nv, bc2);
  const float u = __fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), h.eps));
  np = __fsub_rn(p, __fmul_rn(lr, __fadd_rn(u, __fmul_rn(p, h.wd))));
}

template <typename TG, typename TP, typename TM>
__device__ __forceinline__ void update_body(const TG* __restrict__ g, const TP* __restrict__ p,
                                            const TM* __restrict__ m, const TM* __restrict__ v,
                                            TP* __restrict__ op, float* __restrict__ om,
                                            float* __restrict__ ov, long n,
                                            const float* __restrict__ coef, AdamwHyper h, int vec) {
  const float lr = coef[1], scale = coef[2], bc1 = coef[3], bc2 = coef[4];
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long stride = (long)gridDim.x * blockDim.x;
  long tail = 0;
  if (vec) {
    const long chunks = n / 8;
    for (long c = tid; c < chunks; c += stride) {
      float gx[8], px[8], mx[8], vx[8], np[8], nm[8], nv[8];
      load8(g, c, gx);
      load8(p, c, px);
      load8(m, c, mx);
      load8(v, c, vx);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        adamw1<TM>(gx[k], px[k], mx[k], vx[k], h, lr, scale, bc1, bc2, np[k], nm[k], nv[k]);
      store8(op, c, np);
      store8(om, c, nm);
      store8(ov, c, nv);
    }
    tail = chunks * 8;
  }
  for (long i = tail + tid; i < n; i += stride) {
    float np, nm, nv;
    adamw1<TM>(lapis_load(g, i), lapis_load(p, i), lapis_load(m, i), lapis_load(v, i), h, lr,
               scale, bc1, bc2, np, nm, nv);
    lapis_store(op, i, np);
    om[i] = nm;
    ov[i] = nv;
  }
}

inline bool aligned16(std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* q : ptrs) bits |= (uintptr_t)q;
  return (bits & 15u) == 0;
}

}  // namespace

// Plain (non-template) kernels, so that a trace names each lapis_adamw_*.
#define LAPIS_ADAMW_NORM(NAME, TG)                                                          \
  __global__ void __launch_bounds__(THREADS)                                                \
      lapis_adamw_norm_##NAME(const TG* __restrict__ g, long n, float* __restrict__ partial, \
                              int vec) {                                                    \
    norm_body<TG>(g, n, partial, vec);                                                      \
  }
LAPIS_ADAMW_NORM(f32, float)
LAPIS_ADAMW_NORM(bf16, __nv_bfloat16)

#define LAPIS_ADAMW_UPDATE(NAME, TG, TP, TM)                                                      \
  __global__ void __launch_bounds__(THREADS) lapis_adamw_update_##NAME(                           \
      const TG* __restrict__ g, const TP* __restrict__ p, const TM* __restrict__ m,               \
      const TM* __restrict__ v, TP* __restrict__ op, float* __restrict__ om,                      \
      float* __restrict__ ov, long n, const float* __restrict__ coef, AdamwHyper h, int vec) {         \
    update_body<TG, TP, TM>(g, p, m, v, op, om, ov, n, coef, h, vec);                             \
  }
LAPIS_ADAMW_UPDATE(f32_f32_f32, float, float, float)
LAPIS_ADAMW_UPDATE(f32_f32_bf16, float, float, __nv_bfloat16)
LAPIS_ADAMW_UPDATE(f32_bf16_f32, float, __nv_bfloat16, float)
LAPIS_ADAMW_UPDATE(f32_bf16_bf16, float, __nv_bfloat16, __nv_bfloat16)
LAPIS_ADAMW_UPDATE(bf16_f32_f32, __nv_bfloat16, float, float)
LAPIS_ADAMW_UPDATE(bf16_f32_bf16, __nv_bfloat16, float, __nv_bfloat16)
LAPIS_ADAMW_UPDATE(bf16_bf16_f32, __nv_bfloat16, __nv_bfloat16, float)
LAPIS_ADAMW_UPDATE(bf16_bf16_bf16, __nv_bfloat16, __nv_bfloat16, __nv_bfloat16)

// coef = [grad_norm, lr, scale, 1 - b1^t, 1 - b2^t] at t = step + 1, in the
// order of optim/optimizer.py's plain branch on the card:
//   scale = min(fl(1 / max(norm, 1e-12)) * clip, 1)      (clip / x is x.reciprocal() * clip)
//   warm  = min(t * fl(1 / warmup), 1)                    (a tensor / host scalar multiplies)
//   prog  = clamp((t - warmup) * fl(1 / decay), 0, 1)
//   lr    = (lr * warm) * (min_ratio + (1 - min_ratio) * 0.5 (1 + cos(pi prog)))
__global__ void __launch_bounds__(COEF_THREADS)
    lapis_adamw_coef(const float* __restrict__ partial, long n_partial, const int* __restrict__ step,
                     int* __restrict__ new_step, float* __restrict__ coef, AdamwSchedule s) {
  __shared__ double red[COEF_THREADS / 32];
  double acc = 0.0;
  for (long i = threadIdx.x; i < n_partial; i += blockDim.x) acc += (double)partial[i];
  acc = block_sum(acc, red);
  if (threadIdx.x != 0) return;
  const float norm = __fsqrt_rn((float)acc);
  const float scale =
      s.clip_on ? fminf(__fmul_rn(__frcp_rn(fmaxf(norm, 1e-12f)), s.clip), 1.0f) : 1.0f;
  const int t_int = *step + 1;
  const float t = (float)t_int;
  const float warm = fminf(__fmul_rn(t, s.inv_warmup), 1.0f);
  const float prog = fminf(fmaxf(__fmul_rn(__fsub_rn(t, s.warmup), s.inv_decay), 0.0f), 1.0f);
  const float cosv = __fmul_rn(__fadd_rn(cosf(__fmul_rn(prog, s.pi)), 1.0f), 0.5f);
  const float lr = __fmul_rn(__fmul_rn(warm, s.lr),
                             __fadd_rn(__fmul_rn(cosv, s.one_minus_min), s.min_ratio));
  coef[0] = norm;
  coef[1] = lr;
  coef[2] = scale;
  coef[3] = __fsub_rn(1.0f, powf(s.b1, t));
  coef[4] = __fsub_rn(1.0f, powf(s.b2, t));
  *new_step = t_int;
}

extern "C" int lapis_adamw_norm(const void* g, int g_bf16, long n, int blocks, void* partial,
                                void* stream) {
  if (n <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  const int vec = aligned16({g});
  const cudaStream_t st = (cudaStream_t)stream;
  if (g_bf16)
    lapis_adamw_norm_bf16<<<blocks, THREADS, 0, st>>>((const __nv_bfloat16*)g, n,
                                                     (float*)partial, vec);
  else
    lapis_adamw_norm_f32<<<blocks, THREADS, 0, st>>>((const float*)g, n, (float*)partial, vec);
  return (int)cudaGetLastError();
}

extern "C" int lapis_adamw_coef_launch(const void* partial, long n_partial, const void* step,
                                       void* new_step, void* coef, float lr, float inv_warmup,
                                       float warmup, float inv_decay, float pi, float min_ratio,
                                       float one_minus_min, float b1, float b2, float clip,
                                       int clip_on, void* stream) {
  if (n_partial < 0) return (int)cudaErrorInvalidValue;
  const AdamwSchedule s{lr, inv_warmup, warmup, inv_decay, pi, min_ratio, one_minus_min, b1, b2,
                   clip, clip_on};
  lapis_adamw_coef<<<1, COEF_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)partial, n_partial, (const int*)step, (int*)new_step, (float*)coef, s);
  return (int)cudaGetLastError();
}

#define LAPIS_ADAMW_LAUNCH(NAME, TG, TP, TM)                                                 \
  lapis_adamw_update_##NAME<<<blocks, THREADS, 0, st>>>(                                     \
      (const TG*)g, (const TP*)p, (const TM*)m, (const TM*)v, (TP*)op, (float*)om, (float*)ov, \
      n, (const float*)coef, h, vec)

// Types: g_bf16, p_bf16, mv_bf16 pick bf16 (else f32) for the gradient, the
// master (and the new master) and both moments; the new moments are f32.
extern "C" int lapis_adamw_update(const void* g, int g_bf16, const void* p, int p_bf16,
                                  const void* m, const void* v, int mv_bf16, void* op, void* om,
                                  void* ov, long n, int blocks, const void* coef, float b1,
                                  float one_minus_b1, float b2, float one_minus_b2, float eps,
                                  float wd, void* stream) {
  if (n <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  const AdamwHyper h{b1, one_minus_b1, b2, one_minus_b2, eps, wd};
  const int vec = aligned16({g, p, m, v, op, om, ov});
  const cudaStream_t st = (cudaStream_t)stream;
  switch ((g_bf16 ? 4 : 0) | (p_bf16 ? 2 : 0) | (mv_bf16 ? 1 : 0)) {
    case 0: LAPIS_ADAMW_LAUNCH(f32_f32_f32, float, float, float); break;
    case 1: LAPIS_ADAMW_LAUNCH(f32_f32_bf16, float, float, __nv_bfloat16); break;
    case 2: LAPIS_ADAMW_LAUNCH(f32_bf16_f32, float, __nv_bfloat16, float); break;
    case 3: LAPIS_ADAMW_LAUNCH(f32_bf16_bf16, float, __nv_bfloat16, __nv_bfloat16); break;
    case 4: LAPIS_ADAMW_LAUNCH(bf16_f32_f32, __nv_bfloat16, float, float); break;
    case 5: LAPIS_ADAMW_LAUNCH(bf16_f32_bf16, __nv_bfloat16, float, __nv_bfloat16); break;
    case 6: LAPIS_ADAMW_LAUNCH(bf16_bf16_f32, __nv_bfloat16, __nv_bfloat16, float); break;
    default: LAPIS_ADAMW_LAUNCH(bf16_bf16_bf16, __nv_bfloat16, __nv_bfloat16, __nv_bfloat16);
  }
  return (int)cudaGetLastError();
}
