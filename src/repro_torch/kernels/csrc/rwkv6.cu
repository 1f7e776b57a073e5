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
// zero and returns no state.
//
// Bound: operations, 5 f32 operations per (t, k, v) counted as the serial
// recurrence does them, against 2 bytes per (t, k) and (t, v) in bf16.  A
// block that walks all of T for one (b, h) runs a chain of T dependent steps
// with B*H blocks on the card (160 at rwkv6-3b's prefill): latency, not a
// rate.  So time is split.
//
// The chunked scan (plan: plan() below, twin kernels/rwkv6.py::wkv_plan,
// held equal on the card).  A work unit is (b, h, 64 state columns, chunk
// of L = 16 * nsub steps): B * H * ceil(V / 64) * ceil(T / L) units, one
// block each (1280 at the prefill's 4 x 512 x 40 x 64).  Inside a chunk,
// sub-chunks of 16 steps are anchors: every decay factor is a product of w
// over a range that ends at an anchor, never a quotient or an exp of a
// difference of logs, so any w in [0, 1] (0 and underflowed decays
// included) gives finite, exact-in-f32 factors.  With p_t the product of w
// from the sub-chunk's start to t - 1 and q_s from s + 1 to its end:
//   r^_t = r_t p_t,  k^_s = k_s q_s,  P_J = the sub-chunk's product,
//   A[t][s] = r_t . (prod_{s<i<t} w_i) k_s  (s < t, one sub-chunk: a
//             running product on FFMA, 16 steps deep), A[t][t] = r_t . u k_t,
//   A[t][s] = (r^_t M_IJ) . k^_s  (s in sub-chunk I < J = t's: a matrix
//             product; M_IJ the product of the P between them),
//   y_loc  = A V                                 (the chunk from zero),
//   dS     = sum_I diag(Q_I) k^_I^T V_I          (Q_I: the P after I),
//   P_c    = prod_J P_J,
//   S_c    = diag(P_c) S_{c-1} + dS              (the chain along T),
//   y      = y_loc + (r^_t Pi_J) . S_{c-1}       (Pi_J: the P before J).
// The three large products run on the tensor cores (mma.sync m16n8k8) in
// 3xTF32: each f32 operand split into a TF32 high part and a TF32
// remainder, D += lo.hi + hi.lo + hi.hi (lo.lo dropped), about 2^-21
// relative an operand product, inside the f32 bars: dS = k-bar^T V (k-bar =
// k^ Q_I), y_loc = A V over the blocks at or below the row's diagonal, and
// y += r~ . S_{c-1} (r~ = r^ Pi_J); each warp a 16-row m-tile.  The decayed
// r . k blocks stay on FFMA: the diagonal ones are running products, and
// the ones below the diagonal (r^ M . k^, 16 x 16 blocks, 10% of the
// multiply-adds) are one warp a block.  Row pitches of kmax + 4, kmax + 8
// and 72 floats keep the lanes of every fragment load on distinct banks.
//
// The chain: a unit publishes S_c to an f32 scratch and raises a flag; the
// unit of chunk c + 1 waits on it (after its own local work, so the wait
// overlaps the chunk's arithmetic).  Units are tickets taken from an atomic
// counter in chunk-major order, so a block only ever waits on a ticket a
// running block holds (no deadlock however many blocks the card holds at
// once), and every sum has a fixed order: the same inputs give the same
// bits on every run.  The last chunk writes the final state.
// Loads: each sub-chunk's r, k, w and v go into shared memory by 16-byte
// cp.async, one commit group a sub-chunk, all issued at the start: the
// later sub-chunks are in flight while the first ones' diagonal blocks are
// computed, and two units an SM overlap one's loads with the other's
// products.  (Inputs whose rows are not 16-byte aligned take plain loads.)
// Bound in practice: a unit's chain of dependent phases (loads, the
// diagonal blocks sub-chunk by sub-chunk, the products, the chain's L2
// round trip), not the multiply-add rate.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "lapis_cuda.cuh"

namespace wkv {

constexpr int SUB = 16;            // steps a sub-chunk (an anchor every 16 steps)
constexpr int VS = 64;             // state columns a unit
constexpr int NT = 256;            // threads a block
constexpr int MAX_NSUB = 4;        // sub-chunks a chunk: L = 64 steps at most
constexpr int SM_SMEM = 233472;    // shared memory an SM has (228 KB)
constexpr int BLOCK_RESERVED = 1024;
constexpr int SPIN_LIMIT = 1 << 26;   // ~4 s of polling: a lost flag traps, never hangs

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Shared memory of a unit, in bytes from the dynamic base: the raw inputs
// (f32: r, k, w rows of kmax + 4 floats, in which r^ and k^ are then
// computed in place; bf16: rows of kmax values, r^ and k^ apart), v (f32)
// and its raw bf16 copy, A (L x (L + 4)), the staged S_{c-1} (kmax x 64,
// over the raw inputs where they are large enough: dead by then), and the
// per-k vectors u, P_J, Pi_J, Q_J, the M pairs and P_c.
struct Layout {
  int raw_r, raw_k, raw_w, raw_v, rh, kh, vf, a, ss, u, p, pi, q, m, pc, bytes;
};

// f32 row pitches: r^ (and f32 r) kmax + 4 floats, k^ (and f32 k, w) kmax + 8,
// v and S_{c-1} 64 + 8, so that the lanes of an mma fragment load, and the
// FFMA loads, fall in distinct banks
__host__ __device__ constexpr int pitch_r(int kmax) { return kmax + 4; }
__host__ __device__ constexpr int pitch_k(int kmax) { return kmax + 8; }
constexpr int LV = VS + 8;

__host__ __device__ constexpr int up16(int bytes) { return (bytes + 15) / 16 * 16; }

__host__ __device__ constexpr Layout layout(int kmax, int nsub, int item) {
  const int L = SUB * nsub, pr = pitch_r(kmax), pk = pitch_k(kmax), la = L + 4;
  const int pairs = nsub * (nsub - 1) / 2;
  Layout s{};
  int at = 0;
  if (item == 4) {
    s.raw_r = s.rh = at, at += up16(L * pr * 4);
    s.raw_k = s.kh = at, at += up16(L * pk * 4);
    s.raw_w = at, at += up16(L * pk * 4);
    s.raw_v = s.vf = at, at += up16(L * LV * 4);
    s.ss = L * pk >= kmax * LV ? s.raw_w : -1;
  } else {
    s.raw_r = at, at += up16(L * kmax * item);
    s.raw_k = at, at += up16(L * kmax * item);
    s.raw_w = at, at += up16(L * kmax * item);
    s.raw_v = at, at += up16(L * VS * item);
    s.rh = at, at += up16(L * pr * 4);
    s.kh = at, at += up16(L * pk * 4);
    s.vf = at, at += up16(L * LV * 4);
    s.ss = 3 * L * kmax * item >= kmax * LV * 4 ? s.raw_r : -1;
  }
  s.a = at, at += up16(L * la * 4);
  if (s.ss < 0) s.ss = at, at += up16(kmax * LV * 4);
  s.u = at, at += up16(kmax * 4);
  s.p = at, at += up16(nsub * kmax * 4);
  s.pi = at, at += up16(nsub * kmax * 4);
  s.q = at, at += up16(nsub * kmax * 4);
  s.m = at, at += up16((pairs > 0 ? pairs : 1) * kmax * 4);
  s.pc = at, at += up16(kmax * 4);
  s.bytes = at;
  return s;
}

// The launch of a (batch, t_len, n_heads, kd / vd) scan of item-byte values:
// kmax state rows a block (kd rounded up to 16, 32, 64 or 128), nsub
// sub-chunks of 16 steps a chunk (4, or fewer when T is short), chunks
// along T, slices of 64 state columns, the tickets (units), the dynamic
// shared memory, and the blocks an SM's shared memory holds.
struct Plan {
  int kmax, nsub, chunk;
  long long chunks, vslices, tickets;
  int threads, smem_bytes, blocks_per_sm;
};

inline Plan plan(long long batch, long long t_len, long long n_heads, int kd, int vd, int item) {
  const int kmax = kd <= 16 ? 16 : kd <= 32 ? 32 : kd <= 64 ? 64 : 128;
  int nsub = MAX_NSUB;
  while (nsub > 1 && SUB * nsub / 2 >= t_len) nsub /= 2;
  const long long chunks = t_len > 0 ? cdiv(t_len, SUB * nsub) : 1;
  const long long vslices = cdiv(vd, VS);
  const int smem = layout(kmax, nsub, item).bytes;
  int fit = SM_SMEM / (smem + BLOCK_RESERVED);
  if (fit > 2048 / NT) fit = 2048 / NT;
  return {kmax, nsub, SUB * nsub, chunks, vslices, batch * n_heads * vslices * chunks,
          NT, smem, fit};
}

__device__ __forceinline__ int load_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most n (0 .. MAX_NSUB - 1) of this thread's groups are pending
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// N consecutive values as f32, by the widest aligned loads
template <int N>
__device__ __forceinline__ void ldv(const float* p, float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(p)[i];
      x[4 * i] = f.x, x[4 * i + 1] = f.y, x[4 * i + 2] = f.z, x[4 * i + 3] = f.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 f = reinterpret_cast<const float2*>(p)[i];
      x[2 * i] = f.x, x[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p[i];
  }
}
__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
template <int N>
__device__ __forceinline__ void ldv(const __nv_bfloat16* p, float (&x)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) x[8 * i + 2 * e] = bf_lo(w[e]), x[8 * i + 2 * e + 1] = bf_hi(w[e]);
    }
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint2 u = reinterpret_cast<const uint2*>(p)[i];
      x[4 * i] = bf_lo(u.x), x[4 * i + 1] = bf_hi(u.x);
      x[4 * i + 2] = bf_lo(u.y), x[4 * i + 3] = bf_hi(u.y);
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const uint32_t u = reinterpret_cast<const uint32_t*>(p)[i];
      x[2 * i] = bf_lo(u), x[2 * i + 1] = bf_hi(u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = __bfloat162float(p[i]);
  }
}

// A reduce-scatter over the G threads (consecutive lanes) that share a row
// of partial sums: rounds of halving, lane bit LB choosing the half a thread
// keeps and adds its partner's copy of; after log2 G rounds thread g holds
// the full sums of columns SUB / G * g + i (i < SUB / G) in part[i].
template <int HALF, int LB>
__device__ __forceinline__ void scatter_round(float (&part)[SUB], int g) {
  const bool hi = (g & LB) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = hi ? part[i] : part[i + HALF];
    const float keep = hi ? part[i + HALF] : part[i];
    part[i] = keep + __shfl_xor_sync(0xffffffffu, send, LB);
  }
}
template <int G, int HALF = SUB / 2>
__device__ __forceinline__ void reduce_scatter(float (&part)[SUB], int g) {
  if constexpr (G > 1) {
    scatter_round<HALF, G / 2>(part, g);
    reduce_scatter<G / 2, HALF / 2>(part, g);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// TF32 bits of x, rounded to nearest (cvt.rna)
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo in TF32, lo the remainder's TF32 bits (3xTF32)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One 8-deep step of D (16 x 8 n-tiles) += A (16 x 8) B (8 x 8 per n-tile) in
// 3xTF32: the two cross terms, then hi x hi; lo x lo dropped.  a: A's
// fragment (rows g, g + 8, columns t, t + 4 of lane (g, t)); b: B's (rows
// t, t + 4, column g), per n-tile.
template <int NTILE>
__device__ __forceinline__ void mma3_step(float (&d)[NTILE][4], const float (&a)[4],
                                          const float (&b)[NTILE][2]) {
  uint32_t ah[4], al[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], ah[i], al[i]);
#pragma unroll
  for (int j = 0; j < NTILE; ++j) {
    uint32_t bh[2], bl[2];
    split(b[j][0], bh[0], bl[0]);
    split(b[j][1], bh[1], bl[1]);
    mma_tf32(d[j], al[0], al[1], al[2], al[3], bh[0], bh[1]);
    mma_tf32(d[j], ah[0], ah[1], ah[2], ah[3], bl[0], bl[1]);
    mma_tf32(d[j], ah[0], ah[1], ah[2], ah[3], bh[0], bh[1]);
  }
}

// One unit: (b, h, 64 state columns, a chunk of 16 * NSUB steps).
// T: the inputs' type; KMAX: state rows (kd padded); NSUB: sub-chunks.
template <typename T, int KMAX, int NSUB>
__global__ void __launch_bounds__(NT, 2)
lapis_rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ w, const T* __restrict__ u,
                   const float* __restrict__ s_in, T* __restrict__ y, float* __restrict__ s_out,
                   float* __restrict__ carry, int* __restrict__ flags, int n_heads, int t_len,
                   int kd, int vd, long rs_b, long rs_t, long rs_h, long ks_b, long ks_t,
                   long ks_h, long vs_b, long vs_t, long vs_h, long ws_b, long ws_t, long ws_h,
                   int chunks, int vslices, int vec) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int L = SUB * NSUB, LA = L + 4;
  constexpr int PR = pitch_r(KMAX), PK = pitch_k(KMAX), PWF = F32 ? PK : PR;
  constexpr int KPG = KMAX / 16;     // k values a thread in a diagonal block
  constexpr int RP = KMAX * (int)sizeof(T) / 16;   // 16-byte pieces a row of r, k, w
  constexpr int VP = VS * (int)sizeof(T) / 16;     // ... of v
  // raw row pitches, in T: f32 in the f32 arrays' own pitches (r^ and k^ are
  // computed in place), bf16 packed
  constexpr int RR = F32 ? PR : KMAX, RKW = F32 ? PK : KMAX, RV = F32 ? LV : VS;
  // the products' warp tiles (m16n8k8): y (L x 64) in NSUB m-tiles, WY
  // warps across each, NSUB n-tiles a warp; dS (KMAX x 64) in MT m-tiles,
  // WS warps across each, MT n-tiles a warp
  constexpr int WY = 8 / NSUB, MT = KMAX / 16, WS = 8 / MT;
  static_assert(NT == 256 && MT <= 8, "eight warps");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long ticket_slot;
  constexpr Layout lay = layout(KMAX, NSUB, (int)sizeof(T));
  T* const raw_r = reinterpret_cast<T*>(smem + lay.raw_r);
  T* const raw_k = reinterpret_cast<T*>(smem + lay.raw_k);
  T* const raw_w = reinterpret_cast<T*>(smem + lay.raw_w);
  T* const raw_v = reinterpret_cast<T*>(smem + lay.raw_v);
  float* const rh = reinterpret_cast<float*>(smem + lay.rh);
  float* const kh = reinterpret_cast<float*>(smem + lay.kh);
  float* const vf = reinterpret_cast<float*>(smem + lay.vf);
  float* const As = reinterpret_cast<float*>(smem + lay.a);
  float* const Ss = reinterpret_cast<float*>(smem + lay.ss);
  float* const us = reinterpret_cast<float*>(smem + lay.u);
  float* const Pj = reinterpret_cast<float*>(smem + lay.p);
  float* const Pi = reinterpret_cast<float*>(smem + lay.pi);
  float* const Qj = reinterpret_cast<float*>(smem + lay.q);
  float* const Mp = reinterpret_cast<float*>(smem + lay.m);
  float* const Pc = reinterpret_cast<float*>(smem + lay.pc);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;   // the lane's (group, thread) in an mma fragment

  // the unit: tickets in chunk-major order
  if (tid == 0) ticket_slot = (long long)atomicAdd(flags, 1);
  __syncthreads();
  const long long ticket = ticket_slot;
  const long long per_chunk = (long long)gridDim.x / chunks;
  const int c = (int)(ticket / per_chunk);
  const long long unit = ticket % per_chunk;          // (b * n_heads + h) * vslices + vsl
  const int vsl = (int)(unit % vslices);
  const int bh = (int)(unit / vslices), b = bh / n_heads, h = bh % n_heads;
  const int c0 = c * L, v0 = vsl * VS;
  const T* const rb = r + (long)b * rs_b + (long)h * rs_h;
  const T* const kb = k + (long)b * ks_b + (long)h * ks_h;
  const T* const wb = w + (long)b * ws_b + (long)h * ws_h;
  const T* const vb = v + (long)b * vs_b + (long)h * vs_h + v0;

  // 1. every sub-chunk's r, k, w, v into shared memory, one group each (u's
  //    row read first, into a register)
  const float u_tid = tid < kd ? lapis_load(u, (long)h * kd + tid) : 0.f;
  for (int J = 0; J < NSUB; ++J) {
    if (vec) {
      for (int p = tid; p < 3 * SUB * RP; p += NT) {
        const int a = p / (SUB * RP), tt = p / RP % SUB, pc = p % RP;
        const int t = J * SUB + tt, e = pc * 16 / (int)sizeof(T);
        const bool in = c0 + t < t_len && e < kd;
        const T* base = a == 0 ? rb : a == 1 ? kb : wb;
        const long st = a == 0 ? rs_t : a == 1 ? ks_t : ws_t;
        T* dst = a == 0 ? raw_r + t * RR + e : (a == 1 ? raw_k : raw_w) + t * RKW + e;
        cp_async16(dst, in ? base + (long)(c0 + t) * st + e : base, in);
      }
      for (int p = tid; p < SUB * VP; p += NT) {
        const int tt = p / VP, t = J * SUB + tt, e = p % VP * 16 / (int)sizeof(T);
        const bool in = c0 + t < t_len && v0 + e < vd;
        cp_async16(raw_v + t * RV + e, in ? vb + (long)(c0 + t) * vs_t + e : vb, in);
      }
    } else {
      for (int i = tid; i < 3 * SUB * KMAX; i += NT) {
        const int a = i / (SUB * KMAX), tt = i / KMAX % SUB, e = i % KMAX;
        const int t = J * SUB + tt;
        const bool in = c0 + t < t_len && e < kd;
        const T* base = a == 0 ? rb : a == 1 ? kb : wb;
        const long st = a == 0 ? rs_t : a == 1 ? ks_t : ws_t;
        (a == 0 ? raw_r + t * RR : (a == 1 ? raw_k : raw_w) + t * RKW)[e] =
            in ? base[(long)(c0 + t) * st + e] : T(0.f);
      }
      for (int i = tid; i < SUB * VS; i += NT) {
        const int t = J * SUB + i / VS, e = i % VS;
        raw_v[t * RV + e] = c0 + t < t_len && v0 + e < vd ? vb[(long)(c0 + t) * vs_t + e] : T(0.f);
      }
    }
    cp_async_commit();
  }

  // 2. sub-chunk by sub-chunk, as each lands: the diagonal block of A by
  //    running products on FFMA, a thread a (row tt, group g of KMAX / 16
  //    k) through the steps below its row (a warp skips the steps below
  //    neither of its two rows), then a reduce-scatter over the row's 16
  //    threads.  k and w are read as f32: the raw rows in f32; in bf16,
  //    copies made as each sub-chunk lands in the k^ / r^ regions (free
  //    until the sweep).
  float* const kf = F32 ? reinterpret_cast<float*>(raw_k) : kh;
  float* const wf = F32 ? reinterpret_cast<float*>(raw_w) : rh;
  for (int J = 0; J < NSUB; ++J) {
    cp_async_wait_pending(NSUB - 1 - J);
    if (J == 0 && tid < KMAX) us[tid] = u_tid;
    __syncthreads();
    if constexpr (!F32) {
      for (int i = tid; i < 2 * SUB * KMAX / 4; i += NT) {
        const int a = i / (SUB * KMAX / 4), t = J * SUB + i / (KMAX / 4) % SUB;
        const int e = i % (KMAX / 4) * 4;
        float x[4];
        ldv((a == 0 ? raw_k : raw_w) + t * KMAX + e, x);
        *reinterpret_cast<float4*>(a == 0 ? kf + t * PK + e : wf + t * PWF + e) =
            make_float4(x[0], x[1], x[2], x[3]);
      }
      __syncthreads();
    }
    const int tt = tid / 16, g = tid % 16, t = J * SUB + tt;
    const int tt_warp = tid / 32 * 2 + 1;   // the larger of the warp's two rows
    // rd = r_t times the running product of w from s + 1 to t - 1
    float rd[KPG], uu[KPG], kt[KPG];
    ldv(raw_r + t * RR + g * KPG, rd);
    ldv(us + g * KPG, uu);
    ldv(kf + t * PK + g * KPG, kt);
    float part[SUB];
    float bonus = 0.f;
#pragma unroll
    for (int e = 0; e < KPG; ++e) bonus = fmaf(rd[e] * uu[e], kt[e], bonus);
#pragma unroll
    for (int s = SUB - 1; s >= 0; --s) {
      part[s] = s == tt ? bonus : 0.f;
      if (s < tt_warp) {
        float kv[KPG], wv[KPG];
        ldv(kf + (J * SUB + s) * PK + g * KPG, kv);
        ldv(wf + (J * SUB + s) * PWF + g * KPG, wv);
        const bool on = s < tt;
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < KPG; ++e) {
          acc = fmaf(rd[e], kv[e], acc);
          rd[e] = on ? rd[e] * wv[e] : rd[e];
        }
        part[s] = on ? acc : part[s];
      }
    }
    reduce_scatter<16>(part, g);   // thread g ends with column s = g
    As[t * LA + J * SUB + g] = part[0];
  }
  __syncthreads();   // f32: r^ and k^ overwrite the raw r and k

  // r^, k^ and P_J of every sub-chunk at once, a thread a (J, k): 16-step
  // running products, w = 1 past T
  for (int idx = tid; idx < NSUB * KMAX; idx += NT) {
    const int J = idx / KMAX, kk = idx % KMAX;
    float wv[SUB];
    float p = 1.f;
#pragma unroll
    for (int tt = 0; tt < SUB; ++tt) {   // bf16: w's copy is read before r^ replaces it
      const int t = J * SUB + tt;
      wv[tt] = c0 + t < t_len ? wf[t * PWF + kk] : 1.f;
      rh[t * PR + kk] = lapis_load(raw_r, t * RR + kk) * p;
      p *= wv[tt];
    }
    Pj[J * KMAX + kk] = p;
    float q = 1.f;
#pragma unroll
    for (int tt = SUB - 1; tt >= 0; --tt) {
      const int t = J * SUB + tt;
      kh[t * PK + kk] = kf[t * PK + kk] * q;
      q *= wv[tt];
    }
  }
  __syncthreads();

  // 3. the products across sub-chunks, each a running product over the P_J
  //    in a fixed order; bf16: v as f32
  if (tid < KMAX) {
    const int kk = tid;
    float run = 1.f;
#pragma unroll
    for (int J = 0; J < NSUB; ++J) Pi[J * KMAX + kk] = run, run *= Pj[J * KMAX + kk];
    Pc[kk] = run;
    run = 1.f;
#pragma unroll
    for (int J = NSUB - 1; J >= 0; --J) Qj[J * KMAX + kk] = run, run *= Pj[J * KMAX + kk];
#pragma unroll
    for (int J = 1; J < NSUB; ++J) {
      run = 1.f;
#pragma unroll
      for (int I = J - 1; I >= 0; --I)
        Mp[(J * (J - 1) / 2 + I) * KMAX + kk] = run, run *= Pj[I * KMAX + kk];
    }
  }
  if constexpr (!F32) {
    for (int i = tid; i < L * VS; i += NT) vf[i / VS * LV + i % VS] = __bfloat162float(raw_v[i]);
  }
  __syncthreads();

  // 4. A's blocks below the diagonal on FFMA, a warp a block pair (I < J):
  //    (r^_J M_IJ) . k^_I^T, a lane 2 rows x 4 columns
  if constexpr (NSUB > 1) {
    if (warp < NSUB * (NSUB - 1) / 2) {
      int J = 1;
      while (J * (J + 1) / 2 <= warp) ++J;
      const int I = warp - J * (J - 1) / 2;
      const int r0 = J * SUB + lane / 4 * 2, s0 = I * SUB + lane % 4;
      const float* const mv = Mp + warp * KMAX;
      float acc[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int k4 = 0; k4 < KMAX / 4; ++k4) {
        const float4 m4 = ld4(mv + 4 * k4);
        float4 a[2], bv[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float4 x = ld4(rh + (r0 + i) * PR + 4 * k4);
          a[i] = make_float4(x.x * m4.x, x.y * m4.y, x.z * m4.z, x.w * m4.w);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = ld4(kh + (s0 + 4 * j) * PK + 4 * k4);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(a[i].x, bv[j].x, acc[i][j]);
            acc[i][j] = fmaf(a[i].y, bv[j].y, acc[i][j]);
            acc[i][j] = fmaf(a[i].z, bv[j].z, acc[i][j]);
            acc[i][j] = fmaf(a[i].w, bv[j].w, acc[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) As[(r0 + i) * LA + s0 + 4 * j] = acc[i][j];
    }
    __syncthreads();
  }
  // r~ = r^ Pi_J and k-bar = k^ Q_J, in place
  for (int i = tid; i < L * KMAX; i += NT) {
    const int t = i / KMAX, kk = i % KMAX, J = t / SUB;
    rh[t * PR + kk] *= Pi[J * KMAX + kk];
    kh[t * PK + kk] *= Qj[J * KMAX + kk];
  }
  __syncthreads();

  // 5. on the tensor cores in 3xTF32: dS = k-bar^T V (a warp MT n-tiles of
  //    m-tile warp / WS), y_loc = A V over the blocks at or below the row's
  //    diagonal (a warp NSUB n-tiles of m-tile J = warp / WY)
  float ds[MT][4], yacc[NSUB][4];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ds[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < NSUB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[j][e] = 0.f;
  const int ms = warp / WS, ns0 = warp % WS * MT * 8;         // dS: m-tile, first column
  const int Jy = warp / WY, ny0 = warp % WY * NSUB * 8;       // y: m-tile (= J), first column
#pragma unroll 2
  for (int s0 = 0; s0 < L; s0 += 8) {
    float a[4], bb[MT][2];
    a[0] = kh[(s0 + tq) * PK + 16 * ms + gq];
    a[1] = kh[(s0 + tq) * PK + 16 * ms + gq + 8];
    a[2] = kh[(s0 + tq + 4) * PK + 16 * ms + gq];
    a[3] = kh[(s0 + tq + 4) * PK + 16 * ms + gq + 8];
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      bb[j][0] = vf[(s0 + tq) * LV + ns0 + 8 * j + gq];
      bb[j][1] = vf[(s0 + tq + 4) * LV + ns0 + 8 * j + gq];
    }
    mma3_step<MT>(ds, a, bb);
  }
  for (int s0 = 0; s0 < (Jy + 1) * SUB; s0 += 8) {
    float a[4], bb[NSUB][2];
    a[0] = As[(16 * Jy + gq) * LA + s0 + tq];
    a[1] = As[(16 * Jy + gq + 8) * LA + s0 + tq];
    a[2] = As[(16 * Jy + gq) * LA + s0 + tq + 4];
    a[3] = As[(16 * Jy + gq + 8) * LA + s0 + tq + 4];
#pragma unroll
    for (int j = 0; j < NSUB; ++j) {
      bb[j][0] = vf[(s0 + tq) * LV + ny0 + 8 * j + gq];
      bb[j][1] = vf[(s0 + tq + 4) * LV + ny0 + 8 * j + gq];
    }
    mma3_step<NSUB>(yacc, a, bb);
  }

  // 6. the chain: S_{c-1} (the given state, zeros, or the chunk before's),
  //    then S_c = diag(P_c) S_{c-1} + dS, published (or the final state)
  const long long unit_cells = (long long)KMAX * VS;
  const bool has_prev = c > 0 || s_in != nullptr;
  if (c > 0) {
    if (tid == 0) {
      const int* flag = flags + 1 + unit * (chunks - 1) + (c - 1);
      int spins = 0;
      while (load_relaxed(flag) == 0) {
        __nanosleep(64);
        if (++spins > SPIN_LIMIT) __trap();
      }
      __threadfence();   // acquire: the flag was seen, then S_{c-1} is read
    }
  }
  __syncthreads();       // every thread is past step 5: Ss may overwrite dead inputs
  if (c > 0) {
    const float* src = carry + (unit * (chunks - 1) + (c - 1)) * unit_cells;
    for (int i = tid; i < KMAX * VS / 4; i += NT)
      *reinterpret_cast<float4*>(Ss + i / (VS / 4) * LV + i % (VS / 4) * 4) =
          __ldcg(reinterpret_cast<const float4*>(src) + i);
  } else if (s_in != nullptr) {
    for (int i = tid; i < KMAX * VS; i += NT) {
      const int kk = i / VS, e = i % VS;
      Ss[kk * LV + e] = kk < kd && v0 + e < vd ? s_in[((long)bh * kd + kk) * vd + v0 + e] : 0.f;
    }
  }
  __syncthreads();
  {
    const bool last = c == chunks - 1;
    float* const dst = last ? nullptr : carry + (unit * (chunks - 1) + c) * unit_cells;
#pragma unroll
    for (int j = 0; j < MT; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {   // rows gq and gq + 8 of the m-tile
        const int kk = 16 * ms + gq + 8 * hh, col = ns0 + 8 * j + 2 * tq;
        const float pc = Pc[kk];
        float sc[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          sc[e] = has_prev ? fmaf(pc, Ss[kk * LV + col + e], ds[j][2 * hh + e]) : ds[j][2 * hh + e];
        if (!last) {
          __stcg(reinterpret_cast<float2*>(dst + kk * VS + col), make_float2(sc[0], sc[1]));
        } else if (kk < kd) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (v0 + col + e < vd) s_out[((long)bh * kd + kk) * vd + v0 + col + e] = sc[e];
        }
      }
    }
    if (!last) {
      __threadfence();
      __syncthreads();
      if (tid == 0) store_release(flags + 1 + unit * (chunks - 1) + c, 1);
    }
  }

  // 7. y = y_loc + r~ . S_{c-1} (3xTF32), stored in T
  if (has_prev) {
#pragma unroll 2
    for (int k0 = 0; k0 < KMAX; k0 += 8) {
      float a[4], bb[NSUB][2];
      a[0] = rh[(16 * Jy + gq) * PR + k0 + tq];
      a[1] = rh[(16 * Jy + gq + 8) * PR + k0 + tq];
      a[2] = rh[(16 * Jy + gq) * PR + k0 + tq + 4];
      a[3] = rh[(16 * Jy + gq + 8) * PR + k0 + tq + 4];
#pragma unroll
      for (int j = 0; j < NSUB; ++j) {
        bb[j][0] = Ss[(k0 + tq) * LV + ny0 + 8 * j + gq];
        bb[j][1] = Ss[(k0 + tq + 4) * LV + ny0 + 8 * j + gq];
      }
      mma3_step<NSUB>(yacc, a, bb);
    }
  }
  const long ys_t = (long)n_heads * vd;
#pragma unroll
  for (int j = 0; j < NSUB; ++j) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = c0 + 16 * Jy + gq + 8 * hh, col = v0 + ny0 + 8 * j + 2 * tq;
      if (t >= t_len) continue;
      T* const dst = y + ((long)b * t_len + t) * ys_t + (long)h * vd + col;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (col + e < vd) lapis_store(dst, e, yacc[j][2 * hh + e]);
    }
  }
}

// call f(std::integral_constant<int, N>{}) for the plan's nsub (1, 2, 4)
template <int N = 1, typename F>
inline int dispatch_nsub(int nsub, F&& f) {
  if constexpr (N < MAX_NSUB) {
    if (nsub != N) return dispatch_nsub<N * 2>(nsub, f);
  }
  return f(std::integral_constant<int, N>{});
}

template <typename T, int KMAX>
static int launch_k(const void* r, const void* k, const void* v, const void* w, const void* u,
                    const void* s_in, void* y, void* s_out, void* carry, void* flags,
                    const Plan& p, int n_heads, int t_len, int kd, int vd, const long* st,
                    int vec, cudaStream_t stream) {
  return dispatch_nsub(p.nsub, [&](auto n_c) {
    constexpr int NSUB = decltype(n_c)::value;
    auto kern = lapis_rwkv6_kernel<T, KMAX, NSUB>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    kern<<<(unsigned)p.tickets, NT, p.smem_bytes, stream>>>(
        (const T*)r, (const T*)k, (const T*)v, (const T*)w, (const T*)u, (const float*)s_in,
        (T*)y, (float*)s_out, (float*)carry, (int*)flags, n_heads, t_len, kd, vd, st[0], st[1],
        st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
        (int)p.chunks, (int)p.vslices, vec);
    return (int)cudaGetLastError();
  });
}

// Are r, k, w and v readable by 16-byte copies: bases 16-byte aligned, the
// (batch, time, head) strides whole 16-byte multiples, and rows of kd (v: vd)
// values whole 16-byte pieces?
inline bool vec_ok(const void* const* ptrs, const long* st, int kd, int vd, int item) {
  for (int a = 0; a < 4; ++a) {
    if (reinterpret_cast<uintptr_t>(ptrs[a]) % 16) return false;
    for (int i = 0; i < 3; ++i)
      if (st[3 * a + i] * item % 16) return false;
  }
  return kd * item % 16 == 0 && vd * item % 16 == 0;
}

// strides: r, k, v, w, each (batch, time, head), in elements; the last dim
// is contiguous in all four; u (heads, kd), the states (batch, heads, kd, vd)
// and y (batch, time, heads, vd) are contiguous; carry: f32 scratch of
// carry_len values and flags: int32 of flags_len values, zeroed, both at
// least what the plan asks (1 + tickets' flags; carry may be null when
// chunks is 1).
template <typename T>
static int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                  const void* s_in, void* y, void* s_out, void* carry, long long carry_len,
                  void* flags, long long flags_len, int batch, int n_heads, int t_len, int kd,
                  int vd, const long* strides, void* stream) {
  if (batch < 0 || n_heads <= 0 || t_len < 0 || kd <= 0 || kd > 128 || vd <= 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const Plan p = plan(batch, t_len, n_heads, kd, vd, (int)sizeof(T));
  const long long units = (long long)batch * n_heads * p.vslices;
  if (p.tickets > 2147483647LL || flags == nullptr || flags_len < 1 + units * (p.chunks - 1) ||
      (p.chunks > 1 && (carry == nullptr ||
                        carry_len < units * (p.chunks - 1) * (long long)p.kmax * VS)))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {r, k, v, w};
  const int vec = vec_ok(ptrs, strides, kd, vd, (int)sizeof(T));
  const cudaStream_t st = (cudaStream_t)stream;
#define LAPIS_WKV_K(KM)                                                                      \
  return launch_k<T, KM>(r, k, v, w, u, s_in, y, s_out, carry, flags, p, n_heads, t_len, kd, \
                         vd, strides, vec, st)
  if (p.kmax == 16) LAPIS_WKV_K(16);
  if (p.kmax == 32) LAPIS_WKV_K(32);
  if (p.kmax == 64) LAPIS_WKV_K(64);
  LAPIS_WKV_K(128);
#undef LAPIS_WKV_K
}

}  // namespace wkv

#define LAPIS_WKV_EXPORT(NAME, T)                                                             \
  extern "C" int NAME(const void* r, const void* k, const void* v, const void* w,             \
                      const void* u, const void* s_in, void* y, void* s_out, void* carry,     \
                      long long carry_len, void* flags, long long flags_len, int batch,       \
                      int n_heads, int t_len, int kd, int vd, const long* strides,            \
                      void* stream) {                                                         \
    return wkv::launch<T>(r, k, v, w, u, s_in, y, s_out, carry, carry_len, flags, flags_len,  \
                          batch, n_heads, t_len, kd, vd, strides, stream);                    \
  }
LAPIS_WKV_EXPORT(lapis_rwkv6_f32, float)
LAPIS_WKV_EXPORT(lapis_rwkv6_bf16, __nv_bfloat16)

// The launch plan (the twin of kernels/rwkv6.py::wkv_plan): kmax, nsub,
// chunk, chunks, vslices, tickets, threads, smem_bytes, blocks_per_sm.
extern "C" int lapis_rwkv6_plan(long long batch, long long t_len, long long n_heads, int kd,
                                int vd, int item, long long* out) {
  if (batch < 0 || t_len < 0 || n_heads <= 0 || kd <= 0 || kd > 128 || vd <= 0 ||
      (item != 2 && item != 4))
    return (int)cudaErrorInvalidValue;
  const wkv::Plan p = wkv::plan(batch, t_len, n_heads, kd, vd, item);
  const long long v[9] = {p.kmax,    p.nsub,    p.chunk,      p.chunks,       p.vslices,
                          p.tickets, p.threads, p.smem_bytes, p.blocks_per_sm};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}
