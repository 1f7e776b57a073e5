// RG-LRU scan (recurrentgemma / Griffin) on Hopper, for every (batch b,
// channel d):
//   a_t = exp(-8 softplus(L[d]) sigmoid(r_t)),
//   h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) sigmoid(i_t) x_t,
// with a_t^2 taken as exp(2 (-8 softplus(L[d])) sigmoid(r_t)) and softplus
// passing its argument through above 20, in f32, from the given initial h
// (or zeros); y_t = h_t is written in x's type and the final h in f32.
//
// Replaces the TPU kernel src/repro/kernels/rglru.py:rglru_scan
// (_rglru_kernel, pallas_call at rglru.py:69).  There the grid is
// (B, D/d_block, T/chunk): channel blocks on the 128 lanes in parallel, time
// sequential with h in VMEM scratch, zero initial state, padded tails.
//
// Bound: bytes — x, r, i read and y written once (2 bytes each in bf16)
// against about 17 f32 operations per element (7 of them on the SFU):
// 2 operations per byte, under the 20 per byte at which the FP32 rate and
// HBM balance.  A thread that walks all T steps of its channels keeps too
// few loads in flight to reach HBM's rate (4 × 4096 channels are 16,384
// threads, 4 warps an SM), so time is split.  h -> a h + b composes
// associatively: (a2, b2) after (a1, b1) is (a2 a1, a2 b1 + b2).
//
// The segmented scan (plan: rglru_plan below, twin kernels/rglru.py::
// rglru_plan, held equal on the card):
//  1. A thread owns `steps` consecutive time steps (a segment, at most 4)
//     of `vec` consecutive channels: one 16-byte vector of x, r and i a step
//     (8 bf16 or 4 f32 values; lanes along D, so every load and store
//     coalesces), all in flight at once.  It computes each
//     step's a_t and b_t = sqrt(max(1 - a_t^2, 1e-12)) sigmoid(i_t) x_t
//     once, keeps both in registers, and scans its segment from h = 0:
//     (A, H), with A the running product of the a_t (not exp of the summed
//     exponents) and H the segment's h from zero.
//  2. The `segs` segments of a block are consecutive in time over the same
//     `lanes` x `vec` channels: shuffles combine the segments within a warp
//     (Kogge-Stone), then one shared-memory exchange combines the warps in
//     order.  Each thread holds its segment's exclusive prefix.
//  3. A chunk (a block's tile of segs x steps steps) takes its starting h
//     from the chunk before it: that tile's block publishes its end h to an
//     f32 scratch (B, chunks - 1, D) and raises a flag.  Tiles are tickets
//     taken from an atomic counter in chunk-major order, so a block only
//     ever waits on a ticket a running block holds (no deadlock however
//     many blocks the card holds at once), and the chain is a fixed order:
//     the same inputs give the same bits on every run.  The first chunk
//     starts from the given h.
//  4. Each segment re-runs its steps from its true starting h with the
//     coefficients still in registers (one FMA a step; x, r and i are read
//     once) and writes y by 16-byte stores; the thread that owns step T-1
//     writes the final h.
// The coefficients (dozens of instructions an element, 7 of them on the
// SFU) take about as long as the bytes, so the two must overlap: the grid
// is resident (two 256-thread blocks an SM) and walks the tickets, and a
// block copies its next ticket's x, r and i into a two-slot shared-memory
// ring by cp.async before it computes the current one, so the loads are
// in flight through the coefficients, the combine, the wait and the y
// stores.  (The scalar path loads into registers.)
// Any T of at most one segment runs as one segment a thread: no scratch,
// no flags.  T = 1, the serving decode step against the cached h, is
// latency, not bytes: it takes the scalar path (a channel a thread, 2- or
// 4-byte loads, coalesced along D), faster there on the H100 than 16-byte
// vectors (8x the threads for one round trip); so do widths off the
// 16-byte vector and unaligned bases.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "lapis_cuda.cuh"
#include "row_reduce.cuh"

namespace rglru {

constexpr int THREADS = 256;        // most threads a block
constexpr int BLOCKS_PER_SM = 2;    // resident blocks of THREADS an SM (registers, the ring)
constexpr int MAX_PAIRS = 512;      // warps x lanes x vec of the warp exchange
constexpr int MAX_CHAIN = 16;       // most chunks the fill rule makes along T
constexpr float C = 8.0f;
constexpr int SPIN_LIMIT = 1 << 26; // ~2 s of polling: a lost flag traps, never hangs

struct Plan {
  int vec, steps, lanes, segs, threads;
  long long chunks, colgroups, tickets, grid;
};

using row_reduce::cdiv;

// The launch of a (batch, t_len, d) scan of item-byte values (aligned: x,
// r, i and y 16-byte aligned): vec values a thread a step, `steps` steps a
// segment, `lanes` threads along D and `segs` segments (consecutive in
// time) a block, chunks of segs x steps steps along T, colgroups along D;
// tickets = batch x colgroups x chunks tiles, walked by `grid` resident
// blocks (BLOCKS_PER_SM blocks of THREADS threads an SM, or as many
// smaller ones as take their place).
inline Plan plan(long long batch, long long t_len, long long d, int item, bool aligned,
                 int sm_count) {
  const int v16 = 16 / item;
  // the decode step (T <= 1) is latency: a channel a thread, scalar loads
  const int vec = (aligned && d % v16 == 0 && t_len > 1) ? v16 : 1;
  const int smax = vec > 1 ? 4 : 8;            // 4 vectors (32 bf16 values) or 8 scalars
  const long long vcols = cdiv(d, vec);
  int steps = 1;
  while (steps < smax && steps < t_len) steps *= 2;
  int lanes = 32, segs = 1;
  if (t_len > steps) {
    lanes = vec > 1 ? 8 : 32;                   // 128 bytes of a row (64 in bf16 scalars)
    while (lanes > 1 && lanes / 2 >= vcols) lanes /= 2;
    const long long nseg = cdiv(t_len, steps);
    segs = 32 / lanes;
    while (segs < THREADS / lanes && segs < nseg) segs *= 2;
    // long T over few channels: shorter chunks, so the blocks fill the SMs,
    // while the chain of chunks stays at most MAX_CHAIN long
    while (segs > 32 / lanes &&
           batch * cdiv(vcols, lanes) * cdiv(t_len, (long long)segs * steps) < sm_count &&
           cdiv(t_len, (long long)segs / 2 * steps) <= MAX_CHAIN)
      segs /= 2;
  }
  const long long chunks = t_len > 0 ? cdiv(t_len, (long long)segs * steps) : 1;
  const long long colgroups = cdiv(vcols, lanes), tickets = batch * colgroups * chunks;
  const long long resident = (long long)sm_count * BLOCKS_PER_SM * (THREADS / (lanes * segs));
  return {vec,    steps,     lanes,   segs, lanes * segs, chunks,
          colgroups, tickets, tickets < resident ? tickets : resident};
}

// The sigmoids and the square root on the SFU without slow-path branches:
// 1 / (1 + e^-x) with e^-x as ex2.approx and the reciprocal as rcp.approx
// (2 ulp; 0 for a denominator above 2^126, where the sigmoid is 0 to f32
// anyway), and sqrt(s) as s rsqrt(s) (s >= 1e-12).  The precise forms
// call a slow path around every division and square root, whose branches
// keep the compiler from interleaving the elements.  a_t and a_t^2 stay
// precise expf: their error compounds over T where a_t is near 1.
__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.f, 1.f + __expf(-x)); }
__device__ __forceinline__ float root(float s) { return s * rsqrtf(s); }

// log(1 + exp(x)) as torch.nn.functional.softplus computes it (x above 20: x)
__device__ __forceinline__ float softplus(float x) { return x > 20.f ? x : log1pf(expf(x)); }

// A flag, read without ordering; a __threadfence after seeing it set makes
// the release store's data visible (the acquire pattern).
__device__ __forceinline__ int load_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// VEC consecutive values of T as f32: one 16-byte load (read-only path) when
// VEC is the 16-byte vector, one scalar load when VEC = 1.
template <typename T, int VEC>
struct Vals {
  static constexpr bool kVector = VEC > 1;
  using Raw = typename std::conditional<kVector, uint4, float>::type;
  static __device__ __forceinline__ Raw load(const T* p, long i, bool in) {
    if constexpr (kVector) {
      return in ? __ldg(reinterpret_cast<const uint4*>(p + i)) : make_uint4(0u, 0u, 0u, 0u);
    } else {
      return in ? lapis_load(p, i) : 0.f;
    }
  }
  static __device__ __forceinline__ void unpack(const Raw& u, float (&v)[VEC]) {
    if constexpr (kVector) {
      row_reduce::Vec16<T>::unpack(u, v);
    } else {
      v[0] = u;
    }
  }
  static __device__ __forceinline__ void store(T* p, long i, const float (&v)[VEC]) {
    if constexpr (kVector) {
      *reinterpret_cast<uint4*>(p + i) = row_reduce::Vec16<T>::pack(v);
    } else {
      lapis_store(p, i, v[0]);
    }
  }
};

// One ticket's place: its chunk along T, batch row and group of channels,
// and this thread's first channel and first step there.
struct Place {
  int chunk, b, cg, c0, t0;
  bool on;
};

__device__ __forceinline__ Place place(long long ticket, int batch, int colgroups, int lanes,
                                       int segs, int steps, int vec, int d) {
  const long long per_chunk = (long long)batch * colgroups;
  Place p;
  p.chunk = (int)(ticket / per_chunk);
  p.b = (int)(ticket % per_chunk / colgroups);
  p.cg = (int)(ticket % colgroups);
  p.c0 = (p.cg * lanes + (int)threadIdx.x % lanes) * vec;
  p.t0 = (p.chunk * segs + (int)threadIdx.x / lanes) * steps;
  p.on = p.c0 < d;
  return p;
}

// The next ticket: from the atomic counter in chunk-major order when chunks
// hand each other their end h (so a block only ever waits on a ticket a
// running block holds), else the block's static stride.
__device__ __forceinline__ long long next_ticket(long long cur, bool chained, int* counter,
                                                 long long* slot) {
  if (!chained) return cur + gridDim.x;
  if (threadIdx.x == 0) *slot = atomicAdd(counter, 1);
  __syncthreads();
  return *slot;
}

// 16 bytes global -> shared without registers (zero-filled where !in).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prior() {   // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Dynamic shared memory of the vector path: two tickets' x, r, i (a ring
// of 2 x 3 x steps x threads 16-byte vectors, each thread its own slots).
inline int ring_bytes(int vec, int steps, int threads) {
  return vec > 1 ? 2 * 3 * steps * threads * 16 : 0;
}

template <typename T, int VEC, int STEPS>
__global__ void __launch_bounds__(THREADS, 2)
lapis_rglru_kernel(const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ ig,
                   const T* __restrict__ log_a_param, const float* __restrict__ h_in,
                   T* __restrict__ y, float* __restrict__ h_out, float* __restrict__ carry,
                   int* __restrict__ flags, int batch, int t_len, int d, int lanes, int segs,
                   int chunks, int colgroups, long long tickets) {
  using V = Vals<T, VEC>;
  constexpr bool kRing = VEC > 1;
  extern __shared__ uint4 ring[];
  __shared__ float2 warp_agg[MAX_PAIRS];
  __shared__ float h_start[THREADS];
  __shared__ long long ticket_slot[2];
  const int tid = threadIdx.x, lane = tid % lanes, seg = tid / lanes, nthr = blockDim.x;
  const bool chained = chunks > 1;
  const long long row_len = (long long)t_len * d;
  const T* const src3[3] = {x, r, ig};
  // one ticket's x, r, i: into the ring by cp.async (the vector path) or
  // into registers (the scalar path), all issued at once
  typename V::Raw raw[3][STEPS];
  auto issue = [&](const Place& q, int buf) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int u = 0; u < STEPS; ++u) {
        const bool in = q.on && q.t0 + u < t_len;
        const long long at = in ? q.b * row_len + (long long)(q.t0 + u) * d + q.c0 : 0;
        if constexpr (kRing)
          cp_async16(&ring[((buf * 3 + k) * STEPS + u) * nthr + tid], src3[k] + at, in);
        else
          raw[k][u] = V::load(src3[k], at, in);
      }
    }
  };

  // the first two tickets; then each round takes the one after next, whose
  // atomic returns while the round computes
  long long cur = next_ticket((long long)blockIdx.x - gridDim.x, chained, flags, ticket_slot);
  long long nxt = next_ticket(cur, chained, flags, ticket_slot + 1);
  Place p = place(cur, batch, colgroups, lanes, segs, STEPS, VEC, d);
  if constexpr (kRing) {
    if (cur < tickets) issue(p, 0);
    cp_async_commit();
  }
  for (int it = 0; cur < tickets; ++it) {
    const long long after = chained && tid == 0 ? (long long)atomicAdd(flags, 1) : 0;
    float la_raw[VEC];           // log_a of this ticket's channels (L1 / L2 resident)
#pragma unroll
    for (int v = 0; v < VEC; ++v) la_raw[v] = p.on ? lapis_load(log_a_param, p.c0 + v) : 0.f;
    // the next ticket's loads go out first: in flight through all of this one
    const Place pn = place(nxt, batch, colgroups, lanes, segs, STEPS, VEC, d);
    if constexpr (kRing) {
      if (nxt < tickets) issue(pn, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait_prior();     // this ticket's vectors (this thread's own slots)
    } else {
      issue(p, 0);
    }
    // whether the chunk before has published its end h (read now, used after
    // the coefficients)
    const bool carrier = seg == segs - 1 && p.on;
    const int* flag = flags + 1 + ((long long)p.b * colgroups + p.cg) * (chunks - 1) + p.chunk - 1;
    const int ready = carrier && p.chunk > 0 ? load_relaxed(flag) : 0;

    // 1. the coefficients and the segment's scan from h = 0
    float a[STEPS][VEC], bb[STEPS][VEC], A[VEC], H[VEC], log_a[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) A[v] = 1.f, H[v] = 0.f, log_a[v] = -C * softplus(la_raw[v]);
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      float xv[VEC], rv[VEC], iv[VEC];
      if constexpr (kRing) {
        const uint4* slot = &ring[((it & 1) * 3 * STEPS + u) * nthr + tid];
        V::unpack(slot[0], xv);
        V::unpack(slot[STEPS * nthr], rv);
        V::unpack(slot[2 * STEPS * nthr], iv);
      } else {
        V::unpack(raw[0][u], xv);
        V::unpack(raw[1][u], rv);
        V::unpack(raw[2][u], iv);
      }
      const bool in = p.t0 + u < t_len;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float la_r = log_a[v] * sigmoid(rv[v]);
        const float scale = root(fmaxf(1.f - expf(2.f * la_r), 1e-12f));
        a[u][v] = in ? expf(la_r) : 1.f;
        bb[u][v] = in ? scale * (sigmoid(iv[v]) * xv[v]) : 0.f;
        H[v] = fmaf(a[u][v], H[v], bb[u][v]);
        A[v] *= a[u][v];
      }
    }

    // 2. each segment's exclusive prefix (ex_a, ex_h) over the block's
    //    earlier segments
    float ex_a[VEC], ex_h[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) ex_a[v] = 1.f, ex_h[v] = 0.f;
    if (segs > 1) {
      const int wl = tid & 31, warp = tid / 32, warps = (lanes * segs) / 32;
      if (lanes < 32) {          // segments within a warp: inclusive, then shifted
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          float in_a = A[v], in_h = H[v];
          for (int off = lanes; off < 32; off *= 2) {
            const float pa = __shfl_up_sync(0xffffffffu, in_a, off);
            const float ph = __shfl_up_sync(0xffffffffu, in_h, off);
            if (wl >= off) in_h = fmaf(in_a, ph, in_h), in_a *= pa;
          }
          const float pa = __shfl_up_sync(0xffffffffu, in_a, lanes);
          const float ph = __shfl_up_sync(0xffffffffu, in_h, lanes);
          if (wl >= lanes) ex_a[v] = pa, ex_h[v] = ph;
          if (warps > 1 && wl >= 32 - lanes)
            warp_agg[(warp * lanes + lane) * VEC + v] = make_float2(in_a, in_h);
        }
      } else if (warps > 1) {    // a warp a segment
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          warp_agg[(warp * lanes + lane) * VEC + v] = make_float2(A[v], H[v]);
      }
      if (warps > 1) {           // then the warps before this one, in order
        __syncthreads();
        const int cols = lanes * VEC;
        for (int c = tid; c < cols; c += nthr) {   // each column's exclusive scan, in place
          float2 run = make_float2(1.f, 0.f);
          for (int w = 0; w < warps; ++w) {
            const float2 q = warp_agg[w * cols + c];
            warp_agg[w * cols + c] = run;
            run = make_float2(q.x * run.x, fmaf(q.x, run.y, q.y));
          }
        }
        __syncthreads();
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float2 q = warp_agg[warp * cols + lane * VEC + v];
          ex_h[v] = fmaf(ex_a[v], q.y, ex_h[v]);
          ex_a[v] *= q.x;
        }
      }
    }

    // 3. the chunk's starting h: the given h, or the end h the chunk before
    //    published; the last segment composes the block's end h from its
    //    own (A, H) after its prefix and publishes it before any y is written
    const bool publish = p.chunk < chunks - 1;
    if (carrier) {
      float hin[VEC];
      if (p.chunk == 0) {
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          hin[v] = h_in != nullptr ? h_in[(long long)p.b * d + p.c0 + v] : 0.f;
      } else {
        if (!ready) {
          int spins = 0;
          while (load_relaxed(flag) == 0) {
            __nanosleep(32);
            if (++spins > SPIN_LIMIT) __trap();
          }
        }
        __threadfence();         // acquire: the flag was seen, then the end h is read
        const float* src = carry + ((long long)p.b * (chunks - 1) + p.chunk - 1) * d + p.c0;
#pragma unroll
        for (int v = 0; v < VEC; ++v) hin[v] = __ldcg(src + v);
      }
      if (publish) {
        float* dst = carry + ((long long)p.b * (chunks - 1) + p.chunk) * d + p.c0;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {   // (A, H) again from the registers: the same bits
          float sa = 1.f, sh = 0.f;
#pragma unroll
          for (int u = 0; u < STEPS; ++u) sh = fmaf(a[u][v], sh, bb[u][v]), sa *= a[u][v];
          __stcg(dst + v, fmaf(sa * ex_a[v], hin[v], fmaf(sa, ex_h[v], sh)));
        }
        __threadfence();
      }
      if (t_len == 0) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) h_out[(long long)p.b * d + p.c0 + v] = hin[v];
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) h_start[lane * VEC + v] = hin[v];
    }
    __syncthreads();
    if (publish && tid == 0)
      store_release(flags + 1 + ((long long)p.b * colgroups + p.cg) * (chunks - 1) + p.chunk, 1);

    // 4. the segment again from its true starting h, y by vector stores
    if (p.on) {
      float h[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) h[v] = fmaf(ex_a[v], h_start[lane * VEC + v], ex_h[v]);
#pragma unroll
      for (int u = 0; u < STEPS; ++u) {
        if (p.t0 + u < t_len) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) h[v] = fmaf(a[u][v], h[v], bb[u][v]);
          V::store(y, p.b * row_len + (long long)(p.t0 + u) * d + p.c0, h);
          if (p.t0 + u == t_len - 1) {
#pragma unroll
            for (int v = 0; v < VEC; ++v) h_out[(long long)p.b * d + p.c0 + v] = h[v];
          }
        }
      }
    }
    if (chained && tid == 0) ticket_slot[it & 1] = after;
    __syncthreads();             // h_start and warp_agg are free for the next ticket
    cur = nxt;
    nxt = chained ? ticket_slot[it & 1] : nxt + gridDim.x;
    p = pn;
  }
}

// Call f(std::integral_constant<int, S>{}) for the steps S of the plan:
// 2 or 4 vectors, or 1 ... 8 scalars, a thread.
template <int VEC, int S = (VEC > 1 ? 2 : 1), typename F>
inline void dispatch_steps(int steps, F&& f) {
  if constexpr (S < (VEC > 1 ? 4 : 8)) {
    if (steps != S) return dispatch_steps<VEC, S * 2>(steps, f);
  }
  f(std::integral_constant<int, S>{});
}

template <typename T>
static int launch(const void* x, const void* r, const void* ig, const void* log_a,
                  const void* h_in, void* y, void* h_out, void* carry, long long carry_len,
                  void* flags, long long flags_len, int batch, int t_len, int d, void* stream) {
  if (batch < 0 || batch > 65535 || t_len < 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const Plan p = plan(batch, t_len, d, (int)sizeof(T), row_reduce::aligned16(x, r, ig) &&
                      row_reduce::aligned16(y, y, y), lapis_sm_count());
  const long long warps = p.threads / 32 > 0 ? p.threads / 32 : 1;
  if (p.grid > 2147483647LL || p.threads > THREADS || p.lanes * p.vec > THREADS ||
      (p.segs > 1 && warps * p.lanes * p.vec > MAX_PAIRS))
    return (int)cudaErrorInvalidValue;
  if (p.chunks > 1 && (carry == nullptr || flags == nullptr ||
                       carry_len < (long long)batch * (p.chunks - 1) * d ||
                       flags_len < 1 + (long long)batch * p.colgroups * (p.chunks - 1)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  auto go = [&](auto vec_c) {
    constexpr int VEC = decltype(vec_c)::value;
    dispatch_steps<VEC>(p.steps, [&](auto steps_c) {
      constexpr int S = decltype(steps_c)::value;
      auto kernel = lapis_rglru_kernel<T, VEC, S>;
      const int smem = ring_bytes(VEC, S, p.threads);
      static int smem_set = 0;   // the opt-in (with the static arrays, above 48 KB)
      if (smem > smem_set) {
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        smem_set = smem;
      }
      kernel<<<(unsigned)p.grid, p.threads, smem, st>>>(
          (const T*)x, (const T*)r, (const T*)ig, (const T*)log_a, (const float*)h_in, (T*)y,
          (float*)h_out, (float*)carry, (int*)flags, batch, t_len, d, p.lanes, p.segs,
          (int)p.chunks, (int)p.colgroups, p.tickets);
    });
  };
  if (p.vec > 1)
    go(std::integral_constant<int, 16 / sizeof(T)>{});
  else
    go(std::integral_constant<int, 1>{});
  return (int)cudaGetLastError();
}

}  // namespace rglru

// x, r, i and y: (batch, t_len, d) contiguous; log_a: (d,) in x's type;
// h_in (may be null) and h_out: (batch, d) f32; carry: f32 scratch of
// carry_len values and flags: int32 of flags_len values, zeroed, both at
// least what lapis_rglru_plan's chunks ask (null when chunks is 1).
#define LAPIS_RG_EXPORT(NAME, T)                                                             \
  extern "C" int NAME(const void* x, const void* r, const void* ig, const void* log_a,          \
                      const void* h_in, void* y, void* h_out, void* carry, long long carry_len, \
                      void* flags, long long flags_len, int batch, int t_len, int d,            \
                      void* stream) {                                                           \
    return rglru::launch<T>(x, r, ig, log_a, h_in, y, h_out, carry, carry_len, flags,           \
                            flags_len, batch, t_len, d, stream);                                \
  }
LAPIS_RG_EXPORT(lapis_rglru_f32, float)
LAPIS_RG_EXPORT(lapis_rglru_bf16, __nv_bfloat16)

// The launch plan (the twin of kernels/rglru.py::rglru_plan): vec, steps,
// lanes, segs, threads, chunks, colgroups, tickets, grid.
extern "C" int lapis_rglru_plan(long long batch, long long t_len, long long d, int item,
                                int aligned, int sm_count, long long* out) {
  if (batch < 0 || t_len < 0 || d <= 0 || (item != 2 && item != 4) || sm_count < 1)
    return (int)cudaErrorInvalidValue;
  const rglru::Plan p = rglru::plan(batch, t_len, d, item, aligned != 0, sm_count);
  const long long v[9] = {p.vec,    p.steps,     p.lanes,   p.segs, p.threads,
                          p.chunks, p.colgroups, p.tickets, p.grid};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}
