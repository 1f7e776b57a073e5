// One-token GQA decode attention on Hopper:
//   out[b, h*rep + g, :] = softmax_s(q[b, h*rep + g] . K[b, h, s] * scale) V[b, h, s]
// over the valid positions s of row b: s < lengths[b], and, with a sliding
// window, s >= lengths[b] - window.  f32 accumulation, output in q's type.
// With a logit cap (grok-1's attention), each scaled score x becomes
// cap * tanh(x / cap) before the softmax, as in the flash kernels; a cap of 0
// is none, and then no score passes through tanh.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:decode_attention
// (_decode_kernel, pallas_call at decode_attention.py:100).  There the grid is
// (B*Hkv, S/bs) with the S axis sequential: each step multiplies the rep query
// heads of one KV head by a (bs, D) block on the MXU and carries the online
// softmax state (m, l, acc) in VMEM across steps.  Hopper runs blocks in
// parallel and in no order, and B*Hkv is small at decode (16 at 8 slots and 2
// KV heads, 4 for recurrentgemma-9b's ring, for 132 SMs), so the S axis is
// split instead: block (b*Hkv + h, split, group) sweeps one chunk of 64-position
// tiles of the row for the query heads of one KV head (every one of them up to
// 64 heads in bf16, so K and V are read from HBM once), and a second kernel
// merges the splits of each query head.  Decode moves few flops per byte: the
// bound is HBM's, the valid positions' K and V read once.  Measured on the
// H100, what costs the time beside the bytes is latency: one block per SM at
// recurrentgemma-9b's ring, so Q arrives with the first tile by cp.async, the
// ring's slots are all in flight before the first wait, staging walks its
// pieces without a division each, and the epilogue and the merge read and
// write 16 bytes a lane.
//
// Both types stage K and V through the same ring: 64-position tiles of K and
// V copied by cp.async.cg in 16-byte pieces (LDGSTS) into up to three stages
// of shared memory, the next tiles in flight while this one is computed.
// Positions outside [lo, hi) and head-dim columns past D are zero-filled, not
// read; a tile wholly outside is never loaded, so a short row costs only its
// own length.  K and V are read through their batch, head and position strides
// (D contiguous), so a cache broadcast over the batch with stride 0 (the
// chunked prefill's one gathered row for C query rows) is read in place;
// operands whose rows do not start 16-byte aligned are staged with element
// loads by the same kernel.
//
// bf16: the tensor cores, at the decode step's size.  The block's query heads
// are m16 tiles (MT of them, padded with zero rows).  Per 16-position unit, a
// warp computes S = Q.K^T with mma.sync m16n8k16 (bf16 in, f32 out, two
// chains of k16 steps; Q and K fed by ldmatrix from shared rows padded by 16
// bytes, so no bank is hit twice), masks and scales it (log2 domain), runs
// the online softmax on the accumulator fragments (a row's max and sum over
// the four lanes of a quad: two shuffles), packs P to bf16 in registers as
// the A operand of O += P.V (mma.sync, V by ldmatrix.trans).  The four warps
// split a tile's units (WK ways) and, where O would not fit a thread's
// registers, the head dim of O (WD ways, WK * WD = 4): at one m16 tile a warp
// keeps all of D <= 256 (128 f32 registers), above it 64; warps that share a
// unit compute its S twice rather than pass P through shared memory.  At the
// end the WK groups' states meet in shared memory: each scales its O slice by
// its weight for the row (2^(m_group - m), times 1 / l where it is the
// output), and the block adds the slices with 16-byte reads and writes.  wgmma
// is not used: its M of 64 would pad rep = 6 or 16 query heads 4-10 times.
//
// f32: the CUDA cores (no TF32: f32 greedy tokens are held exactly).  Per tile,
// each thread scores one position for half the block's heads from shared
// memory (q broadcast, no shuffle per score), a warp per head takes the tile's
// max and sum (one shuffle reduction per head per 64 positions), and each
// thread accumulates four head-dim columns of one head's P.V.
//
// A row with no valid position writes 0 (the reference kernel's l == 0 guard).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "lapis_cuda.cuh"

namespace {

constexpr int kThreads = 128;      // four warps
constexpr int kWarps = 4;
constexpr int kTile = 64;          // positions a ring stage holds
constexpr int kMaxStages = 3;
constexpr int kSmemLimit = 232448; // a block's opt-in maximum
constexpr int kMergeThreads = 512;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int rup(int a, int b) { return cdiv(a, b) * b; }
// 16-column units of O a warp holds at most, at MT m16 tiles and padded D
__host__ __device__ constexpr int ou_of(int mt, int dp) {
  return mt == 1 ? (dp > 128 ? 16 : 8) : 8 / mt;
}

// The launch of one call; kernels/decode_attention.py's launch_plan computes
// the same numbers (held to this one on the card).
struct Plan {
  int heads;    // query heads a block takes
  int groups;   // blocks over one KV head's query heads (grid z)
  int mt;       // bf16: m16 tiles of query heads
  int wd;       // bf16: warps splitting the head dim of O (4 / wd split the units)
  int dp;       // head dim padded in shared memory (bf16: to 16; f32: to 8)
  int row;      // bytes of a staged K / V row (padded: no bank conflicts)
  int stages;   // ring depth
  int smem;     // dynamic shared memory, bytes
};

Plan da_plan(int d, int rep, int chunk, bool bf16) {
  Plan p{};
  const int tiles = std::max(1, cdiv(chunk, kTile));
  if (bf16) {
    p.dp = rup(d, 16);
    p.row = 2 * p.dp + 16;
    const int mt_all = cdiv(rep, 16);
    p.mt = mt_all == 1 ? 1 : (mt_all == 2 || p.dp > 128) ? 2 : 4;
    p.heads = std::min(rep, 16 * p.mt);
    p.groups = cdiv(rep, p.heads);
    // a warp keeps 16 * OU columns of O (128 f32 registers at MT = 1 and
    // D > 128, 64 otherwise): wd warps cover D, the other 4 / wd split units
    p.wd = 1;
    while (p.wd * 16 * ou_of(p.mt, p.dp) < p.dp) p.wd *= 2;
    // Q, then the ring; after the last tile the ring holds the warp groups'
    // O slices (rows padded by 4 floats) and their (m, l) for the merge
    const int q = 16 * p.mt * p.row, wk = kWarps / p.wd;
    const int merge = 4 * (wk * 16 * p.mt * (p.dp + 4) + 2 * wk * 16 * p.mt + 2 * 16 * p.mt);
    p.stages = std::min(kMaxStages, tiles);
    while (p.stages > 1 && q + std::max(p.stages * 2 * kTile * p.row, merge) > kSmemLimit)
      --p.stages;
    p.smem = q + std::max(p.stages * 2 * kTile * p.row, merge);
  } else {
    p.dp = rup(d, 8);
    p.row = 4 * (p.dp + 4);
    p.heads = std::min(rep, std::min(32, 4096 / p.dp));
    p.groups = cdiv(rep, p.heads);
    // Q, the tile's scores, and (m, l, alpha) per head
    const int fixed = 4 * (p.heads * p.dp + p.heads * kTile + 3 * p.heads);
    p.stages = std::min(kMaxStages, tiles);
    while (p.stages > 1 && fixed + p.stages * 2 * kTile * p.row > kSmemLimit) --p.stages;
    p.smem = fixed + p.stages * 2 * kTile * p.row;
  }
  return p;
}

// what every block needs to find its work
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* out;
  float* part_ml;    // per (row, KV head, split, query head): (m, l), log2 domain
  float* part_acc;   // and the unnormalised output
  long q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int hkv, rep, s_len, d, window, chunk, n_splits;
  int vec;           // every K / V row starts 16-byte aligned: cp.async pieces
  int vec_q;         // and every q row
  float scale_log2;  // scale * log2(e), or 1 where the cap has already scaled
  float cap_in;      // scale / cap (capped), else 0
  float cap_log2;    // cap * log2(e) (capped), else 0: no cap
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most n groups are pending (n < kMaxStages)
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
// c += a . b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col), c f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}

// four consecutive outputs (16-byte aligned in f32, 8 in bf16)
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The block's positions: [lo, hi) of the row, within this split's chunk.
struct Span {
  int b, h, g0, nh, lo, hi;
};

__device__ __forceinline__ Span block_span(const Args& a, int heads) {
  Span s;
  s.b = blockIdx.x / a.hkv;
  s.h = blockIdx.x - s.b * a.hkv;
  s.g0 = blockIdx.z * heads;
  s.nh = min(heads, a.rep - s.g0);
  const int length = a.lengths[s.b];
  s.hi = min(min(length, a.s_len), (int)(blockIdx.y + 1) * a.chunk);
  s.lo = max(a.window >= 0 ? max(0, length - a.window) : 0, (int)blockIdx.y * a.chunk);
  return s;
}

// where this block's split keeps the partial state of query head g0 + g
__device__ __forceinline__ long part_index(const Args& a, const Span& s, int g) {
  return ((long)blockIdx.x * a.n_splits + blockIdx.y) * a.rep + s.g0 + g;
}

// one query head's result for this block: the output (one split) or the
// split's partial state
template <typename T>
__device__ __forceinline__ void put_result(const Args& a, const Span& s, int g, int c, float acc,
                                           float m, float l) {
  if (a.n_splits == 1) {
    lapis_store(static_cast<T*>(a.out),
                ((long)s.b * a.hkv * a.rep + s.h * a.rep + s.g0 + g) * a.d + c,
                l == 0.f ? 0.f : acc / l);
  } else {
    const long part = part_index(a, s, g);
    a.part_acc[part * a.d + c] = acc;
    if (c == 0) {
      a.part_ml[2 * part] = m;
      a.part_ml[2 * part + 1] = l;
    }
  }
}

// a block with no valid position: 0, or a partial state that saw nothing
// (m = -inf, l = 0; the merge gives it no weight and never uses its acc)
template <typename T>
__device__ __forceinline__ void write_empty(const Args& a, const Span& s) {
  if (a.n_splits == 1) {
    T* out = static_cast<T*>(a.out) + ((long)s.b * a.hkv * a.rep + s.h * a.rep + s.g0) * a.d;
    for (int i = threadIdx.x; i < s.nh * a.d; i += kThreads) lapis_store(out, i, 0.f);
  } else {
    for (int g = threadIdx.x; g < s.nh; g += kThreads) {
      const long part = part_index(a, s, g);
      a.part_ml[2 * part] = -INFINITY;
      a.part_ml[2 * part + 1] = 0.f;
    }
  }
}

// Stage the tile of positions [ts, ts + kTile) of K and V into one ring slot:
// rows of `row` bytes, the first dp columns used; invalid rows and the
// columns past d are zeros.
template <typename T>
__device__ __forceinline__ void stage_tile(const Args& a, const T* kb, const T* vb, int ts, int lo,
                                           int hi, int dp, int row, unsigned char* kd) {
  unsigned char* vd = kd + kTile * row;
  constexpr int kVec = 16 / sizeof(T);
  if (a.vec) {
    // piece (r, pc) of the tile's rows of dp / kVec 16-byte pieces, walked
    // kThreads at a time without a division per piece
    const int pieces = dp / kVec, dr = kThreads / pieces, dc = kThreads - dr * pieces;
    int r = threadIdx.x / pieces, pc = threadIdx.x - r * pieces;
    for (; r < kTile; r += dr, pc += dc) {
      if (pc >= pieces) {
        pc -= pieces;
        ++r;
        if (r >= kTile) break;
      }
      const int c = pc * kVec;
      const int pos = ts + r;
      const int bytes =
          (pos >= lo && pos < hi) ? max(0, min(kVec, a.d - c)) * (int)sizeof(T) : 0;
      cp_async16(kd + r * row + c * (int)sizeof(T), bytes ? kb + (long)pos * a.k_ss + c : kb,
                 bytes);
      cp_async16(vd + r * row + c * (int)sizeof(T), bytes ? vb + (long)pos * a.v_ss + c : vb,
                 bytes);
    }
  } else {
    for (int e = threadIdx.x; e < kTile * dp; e += kThreads) {
      const int r = e / dp, c = e - r * dp;
      const int pos = ts + r;
      const bool ok = pos >= lo && pos < hi && c < a.d;
      T* kr = reinterpret_cast<T*>(kd + r * row);
      T* vr = reinterpret_cast<T*>(vd + r * row);
      if (ok) {
        kr[c] = kb[(long)pos * a.k_ss + c];
        vr[c] = vb[(long)pos * a.v_ss + c];
      } else {
        lapis_store(kr, c, 0.f);
        lapis_store(vr, c, 0.f);
      }
    }
  }
}

// --------------------------------------------------------------------- bf16

template <int MT, int OU>
__global__ void __launch_bounds__(kThreads)
decode_attention_bf16_kernel(const Args a, const Plan p) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  const Span s = block_span(a, p.heads);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (s.lo >= s.hi) {   // nothing to attend to
    write_empty<T>(a, s);
    return;
  }
  const int dp = p.dp, row = p.row;
  const T* kb = static_cast<const T*>(a.k) + (long)s.b * a.k_sb + (long)s.h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + (long)s.b * a.v_sb + (long)s.h * a.v_sh;
  unsigned char* qs = smem;
  unsigned char* ring = smem + 16 * MT * row;
  const int first = s.lo / kTile * kTile;
  const int n_tiles = cdiv(s.hi - first, kTile);

  {   // the block's query heads (zero rows past nh, columns past d), landing
      // with the first tile
    const T* qb = static_cast<const T*>(a.q) + (long)s.b * a.q_sb +
                  (long)(s.h * a.rep + s.g0) * a.q_sh;
    if (a.vec_q) {
      const int pieces = dp / 8;
      for (int i = tid; i < 16 * MT * pieces; i += kThreads) {
        const int r = i / pieces, c = (i - r * pieces) * 8;
        const int bytes = r < s.nh ? max(0, min(8, a.d - c)) * 2 : 0;
        cp_async16(qs + r * row + c * 2, bytes ? qb + (long)r * a.q_sh + c : qb, bytes);
      }
    } else {
      for (int i = tid; i < 16 * MT * dp; i += kThreads) {
        const int r = i / dp, c = i - r * dp;
        T* qr = reinterpret_cast<T*>(qs + r * row);
        if (r < s.nh && c < a.d)
          qr[c] = qb[(long)r * a.q_sh + c];
        else
          lapis_store(qr, c, 0.f);
      }
    }
  }
  for (int st = 0; st < p.stages; ++st) {   // every slot in flight first
    if (st < n_tiles)
      stage_tile<T>(a, kb, vb, first + st * kTile, s.lo, s.hi, dp, row,
                    ring + st * 2 * kTile * row);
    cp_async_commit();
  }

  const int wd = p.wd, wk = kWarps / wd;
  const int wd_i = warp % wd, wk_i = warp / wd;
  const int units = dp / 16;                 // 16-column units of D
  const int per = cdiv(units, wd);
  const int cu0 = wd_i * per, cu_n = min(per, units - cu0);
  const int g = lane >> 2, t4 = lane & 3;    // mma fragment row and column pair
  const uint32_t q_addr = smem_u32(qs) + (lane & 15) * row + (lane >> 4) * 16;
  const int k_lrow = (lane & 7) + ((lane >> 4) << 3), k_lcol = ((lane >> 3) & 1) * 16;
  const int v_lrow = (lane & 7) + (((lane >> 3) & 1) << 3), v_lcol = (lane >> 4) * 16;

  float o[MT][OU][2][4];
  float m_run[MT][2], l_run[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_run[mt][r] = -INFINITY;
      l_run[mt][r] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < OU; ++j)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[mt][j][n][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait(p.stages - 1);   // tile t has landed
    __syncthreads();
    const int ts = first + t * kTile;
    const uint32_t k_base = smem_u32(ring + (t % p.stages) * 2 * kTile * row);
    const uint32_t v_base = k_base + kTile * row;
    for (int u = wk_i; u < kTile / 16; u += wk) {
      const int p0 = ts + 16 * u;
      if (p0 + 16 <= s.lo || p0 >= s.hi) continue;   // the whole unit is masked
      // S over the head dim in two chains of mma (even and odd k16 steps),
      // so one mma's latency does not wait on the last
      float sc[MT][2][4], sc2[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[mt][n][c] = sc2[mt][n][c] = 0.f;
      const uint32_t k_addr = k_base + (16 * u + k_lrow) * row + k_lcol;
#pragma unroll 2
      for (int ks = 0; ks < units; ks += 2) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(k_addr + ks * 32, b0, b1, b2, b3);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t qa[4];
          ldsm_x4(q_addr + mt * 16 * row + ks * 32, qa[0], qa[1], qa[2], qa[3]);
          mma_bf16(sc[mt][0], qa, b0, b1);
          mma_bf16(sc[mt][1], qa, b2, b3);
        }
        if (ks + 1 < units) {
          ldsm_x4(k_addr + ks * 32 + 32, b0, b1, b2, b3);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t qa[4];
            ldsm_x4(q_addr + mt * 16 * row + ks * 32 + 32, qa[0], qa[1], qa[2], qa[3]);
            mma_bf16(sc2[mt][0], qa, b0, b1);
            mma_bf16(sc2[mt][1], qa, b2, b3);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[mt][n][c] += sc2[mt][n][c];
      if (a.cap_log2 > 0.f) {   // the cap, in the log2 domain: cap * tanh(s * scale / cap)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int c = 0; c < 4; ++c) sc[mt][n][c] = a.cap_log2 * tanhf(sc[mt][n][c] * a.cap_in);
      }
      // scale into the log2 domain and mask positions outside [lo, hi)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int pos = p0 + 8 * n + 2 * t4 + (c & 1);
          const bool ok = pos >= s.lo && pos < s.hi;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            sc[mt][n][c] = ok ? sc[mt][n][c] * a.scale_log2 : -INFINITY;
        }
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {   // rows g and g + 8 of the m16 tile
          float mx = fmaxf(fmaxf(sc[mt][0][2 * r], sc[mt][0][2 * r + 1]),
                           fmaxf(sc[mt][1][2 * r], sc[mt][1][2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m_run[mt][r], mx);
          const float m_use = m_new == -INFINITY ? 0.f : m_new;
          const float alpha = exp2f(m_run[mt][r] - m_use);
          m_run[mt][r] = m_new;
          float sum = 0.f;
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int c = 2 * r; c < 2 * r + 2; ++c) {
              sc[mt][n][c] = exp2f(sc[mt][n][c] - m_use);
              sum += sc[mt][n][c];
            }
          l_run[mt][r] = l_run[mt][r] * alpha + sum;
#pragma unroll
          for (int j = 0; j < OU; ++j)
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              o[mt][j][n][2 * r] *= alpha;
              o[mt][j][n][2 * r + 1] *= alpha;
            }
        }
        // the S accumulators of 16 keys are the A fragment of one k16 step
        pa[mt][0] = pack_bf16(sc[mt][0][0], sc[mt][0][1]);
        pa[mt][1] = pack_bf16(sc[mt][0][2], sc[mt][0][3]);
        pa[mt][2] = pack_bf16(sc[mt][1][0], sc[mt][1][1]);
        pa[mt][3] = pack_bf16(sc[mt][1][2], sc[mt][1][3]);
      }
      const uint32_t v_addr = v_base + (16 * u + v_lrow) * row + v_lcol;
#pragma unroll
      for (int j = 0; j < OU; ++j) {
        if (j < cu_n) {
          uint32_t r0, r1, r2, r3;
          ldsm_x4_trans(v_addr + (cu0 + j) * 32, r0, r1, r2, r3);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(o[mt][j][0], pa[mt], r0, r1);
            mma_bf16(o[mt][j][1], pa[mt], r2, r3);
          }
        }
      }
    }
    __syncthreads();   // every warp is done with the slot: refill it
    if (t + p.stages < n_tiles)
      stage_tile<T>(a, kb, vb, first + (t + p.stages) * kTile, s.lo, s.hi, dp, row,
                    ring + (t % p.stages) * 2 * kTile * row);
    cp_async_commit();
  }
  cp_async_wait(0);

  // merge the wk warp groups' states in shared memory (the ring is free):
  // each group's (m, l) per row, then every thread scales its O fragment by
  // its group's weight for the row (and by 1 / l where this is the output),
  // stores it as the group's slice, and the block sums the slices
  float* const om = reinterpret_cast<float*>(ring);   // [wk][16 MT][dp + 4]
  float* const ms = om + wk * 16 * MT * (dp + 4);      // [wk][16 MT]
  float* const ls = ms + wk * 16 * MT;
  float* const row_m = ls + wk * 16 * MT;              // [16 MT]: the merged m, l
  float* const row_l = row_m + 16 * MT;
  const int ld = dp + 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[mt][r] += __shfl_xor_sync(0xffffffffu, l_run[mt][r], 1);
      l_run[mt][r] += __shfl_xor_sync(0xffffffffu, l_run[mt][r], 2);
      if (wd_i == 0 && t4 == 0) {
        ms[wk_i * 16 * MT + mt * 16 + g + 8 * r] = m_run[mt][r];
        ls[wk_i * 16 * MT + mt * 16 + g + 8 * r] = l_run[mt][r];
      }
    }
  __syncthreads();
  const bool direct = a.n_splits == 1;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float fac[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int hrow = mt * 16 + g + 8 * r;
      float mx = -INFINITY;
      for (int w = 0; w < wk; ++w) mx = fmaxf(mx, ms[w * 16 * MT + hrow]);
      float l = 0.f;
      if (mx != -INFINITY)
        for (int w = 0; w < wk; ++w)
          l += ls[w * 16 * MT + hrow] * exp2f(ms[w * 16 * MT + hrow] - mx);
      const float f = mx == -INFINITY ? 0.f : exp2f(m_run[mt][r] - mx);
      fac[r] = direct ? (l == 0.f ? 0.f : f / l) : f;
      if (warp == 0 && t4 == 0) {
        row_m[hrow] = mx;
        row_l[hrow] = l;
      }
    }
#pragma unroll
    for (int j = 0; j < OU; ++j) {
      if (j < cu_n) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            om[(wk_i * 16 * MT + mt * 16 + g + 8 * (c >> 1)) * ld + (cu0 + j) * 16 + 8 * n +
               2 * t4 + (c & 1)] = o[mt][j][n][c] * fac[c >> 1];
      }
    }
  }
  __syncthreads();
  T* const out = static_cast<T*>(a.out) + ((long)s.b * a.hkv * a.rep + s.h * a.rep + s.g0) * a.d;
  for (int r = warp; r < s.nh; r += kWarps) {
    const long part = part_index(a, s, r);
    if ((a.d & 3) == 0) {   // four columns a lane: 16-byte reads and stores
      for (int c = 4 * lane; c < a.d; c += 128) {
        float4 v = *reinterpret_cast<const float4*>(om + r * ld + c);
        for (int w = 1; w < wk; ++w)
          v = add4(v, *reinterpret_cast<const float4*>(om + (w * 16 * MT + r) * ld + c));
        if (direct)
          store4(out + (long)r * a.d + c, v);
        else
          store4(a.part_acc + part * a.d + c, v);
      }
    } else {
      for (int c = lane; c < a.d; c += 32) {
        float v = 0.f;
        for (int w = 0; w < wk; ++w) v += om[(w * 16 * MT + r) * ld + c];
        if (direct)
          lapis_store(out, (long)r * a.d + c, v);
        else
          a.part_acc[part * a.d + c] = v;
      }
    }
    if (!direct && lane == 0) {
      a.part_ml[2 * part] = row_m[r];
      a.part_ml[2 * part + 1] = row_l[r];
    }
  }
}

// ---------------------------------------------------------------------- f32

constexpr int kF32Scores = 16;   // heads a thread scores (half the block's 32)
constexpr int kF32Outs = 8;      // 4-column output units a thread holds

__global__ void __launch_bounds__(kThreads)
decode_attention_f32_kernel(const Args a, const Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Span s = block_span(a, p.heads);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (s.lo >= s.hi) {
    write_empty<float>(a, s);
    return;
  }
  const int dp = p.dp, ld = dp + 4;   // ld: the ring's row stride in floats
  const float* kb = static_cast<const float*>(a.k) + (long)s.b * a.k_sb + (long)s.h * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + (long)s.b * a.v_sb + (long)s.h * a.v_sh;
  unsigned char* ring = smem;                           // 16-byte aligned rows
  float* qs = reinterpret_cast<float*>(ring + p.stages * 2 * kTile * p.row);   // [heads][dp]
  float* sc = qs + p.heads * dp;                        // [heads][kTile]
  float* m_st = sc + p.heads * kTile;                   // [heads]
  float* l_st = m_st + p.heads;
  float* alpha_st = l_st + p.heads;
  const int first = s.lo / kTile * kTile;
  const int n_tiles = cdiv(s.hi - first, kTile);

  {
    const float* qb = static_cast<const float*>(a.q) + (long)s.b * a.q_sb +
                      (long)(s.h * a.rep + s.g0) * a.q_sh;
    if (a.vec_q) {
      const int pieces = dp / 4;
      for (int i = tid; i < s.nh * pieces; i += kThreads) {
        const int r = i / pieces, c = (i - r * pieces) * 4;
        const int bytes = max(0, min(4, a.d - c)) * 4;
        cp_async16(qs + r * dp + c, bytes ? qb + (long)r * a.q_sh + c : qb, bytes);
      }
    } else {
      for (int i = tid; i < s.nh * dp; i += kThreads) {
        const int r = i / dp, c = i - r * dp;
        qs[i] = c < a.d ? qb[(long)r * a.q_sh + c] : 0.f;
      }
    }
    for (int i = tid; i < s.nh; i += kThreads) {
      m_st[i] = -INFINITY;
      l_st[i] = 0.f;
    }
  }
  for (int st = 0; st < p.stages; ++st) {
    if (st < n_tiles)
      stage_tile<float>(a, kb, vb, first + st * kTile, s.lo, s.hi, dp, p.row,
                        ring + st * 2 * kTile * p.row);
    cp_async_commit();
  }
  // this thread's output units: head oh[j], columns oc[j] .. oc[j] + 3
  const int col4 = dp / 4, n_out = s.nh * col4;
  int oh[kF32Outs], oc[kF32Outs];
  float4 o[kF32Outs];
#pragma unroll
  for (int j = 0; j < kF32Outs; ++j) {
    const int i = tid + j * kThreads;
    oh[j] = i / col4;
    oc[j] = (i - oh[j] * col4) * 4;
    o[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int pos_i = tid & (kTile - 1), half = tid / kTile;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait(p.stages - 1);
    __syncthreads();
    const int ts = first + t * kTile;
    const float* ks = reinterpret_cast<const float*>(ring + (t % p.stages) * 2 * kTile * p.row);
    const float* vs = ks + kTile * ld;
    {   // scores: position pos_i for the heads half, half + 2, ...
      float acc[kF32Scores];
#pragma unroll
      for (int i = 0; i < kF32Scores; ++i) acc[i] = 0.f;
      const float* kr = ks + pos_i * ld;
      for (int c = 0; c < dp; c += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
        for (int i = 0; i < kF32Scores; ++i) {
          const int hh = half + 2 * i;
          if (hh < s.nh) {
            const float4 q4 = *reinterpret_cast<const float4*>(qs + hh * dp + c);
            acc[i] = fmaf(k4.x, q4.x, fmaf(k4.y, q4.y, fmaf(k4.z, q4.z, fmaf(k4.w, q4.w, acc[i]))));
          }
        }
      }
      const int pos = ts + pos_i;
      const bool ok = pos >= s.lo && pos < s.hi;
      if (a.cap_log2 > 0.f) {   // the cap, as in the bf16 kernel
#pragma unroll
        for (int i = 0; i < kF32Scores; ++i) acc[i] = a.cap_log2 * tanhf(acc[i] * a.cap_in);
      }
#pragma unroll
      for (int i = 0; i < kF32Scores; ++i) {
        const int hh = half + 2 * i;
        if (hh < s.nh) sc[hh * kTile + pos_i] = ok ? acc[i] * a.scale_log2 : -INFINITY;
      }
    }
    __syncthreads();
    for (int hh = warp; hh < s.nh; hh += kWarps) {   // the tile's max and sum per head
      const float x0 = sc[hh * kTile + lane], x1 = sc[hh * kTile + lane + 32];
      const float m_old = m_st[hh];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m_old - m_use);
      const float p0 = exp2f(x0 - m_use), p1 = exp2f(x1 - m_use);
      sc[hh * kTile + lane] = p0;
      sc[hh * kTile + lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        l_st[hh] = l_st[hh] * alpha + sum;
        m_st[hh] = m_new;
        alpha_st[hh] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kF32Outs; ++j) {   // O += P . V on this thread's columns
      if (tid + j * kThreads < n_out) {
        const float al = alpha_st[oh[j]];
        float4 acc = make_float4(o[j].x * al, o[j].y * al, o[j].z * al, o[j].w * al);
        const float* pr = sc + oh[j] * kTile;
        const float* vc = vs + oc[j];
#pragma unroll 8
        for (int r = 0; r < kTile; ++r) {
          const float w = pr[r];
          const float4 v4 = *reinterpret_cast<const float4*>(vc + r * ld);
          acc.x = fmaf(w, v4.x, acc.x);
          acc.y = fmaf(w, v4.y, acc.y);
          acc.z = fmaf(w, v4.z, acc.z);
          acc.w = fmaf(w, v4.w, acc.w);
        }
        o[j] = acc;
      }
    }
    __syncthreads();
    if (t + p.stages < n_tiles)
      stage_tile<float>(a, kb, vb, first + (t + p.stages) * kTile, s.lo, s.hi, dp, p.row,
                        ring + (t % p.stages) * 2 * kTile * p.row);
    cp_async_commit();
  }
  cp_async_wait(0);
#pragma unroll
  for (int j = 0; j < kF32Outs; ++j) {
    if (tid + j * kThreads < n_out) {
      const float vals[4] = {o[j].x, o[j].y, o[j].z, o[j].w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (oc[j] + c < a.d)
          put_result<float>(a, s, oh[j], oc[j] + c, vals[c], m_st[oh[j]], l_st[oh[j]]);
    }
  }
}

// merges the splits of one (row, KV head, query head g = blockIdx.y):
// out = sum_s e_s acc_s / sum_s e_s l_s with e_s = 2^(m_s - max_s m_s).
// Every split's (m, l) is read once into shared memory; the threads make
// groups of d / VW lanes, VW columns a lane (16-byte loads where VW = 4),
// each group sums its share of the splits (independent loads), and the
// groups' sums are added in shared memory.  A split that saw no position
// (e_s = 0, its acc never written) is selected away.
template <typename T, int VW>
__global__ void __launch_bounds__(kMergeThreads)
decode_attention_merge_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                T* __restrict__ out, int hkv, int rep, int d, int n_splits) {
  extern __shared__ float sm[];   // m[n_splits], l[n_splits], sums[groups][d]
  float* const ms = sm;
  float* const ls = sm + n_splits;
  float* const sums = ls + n_splits;
  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv, hq = hkv * rep;
  const int g = blockIdx.y, tid = threadIdx.x, lane = tid & 31;
  const long first = (long)blockIdx.x * n_splits * rep + g;
  for (int sp = tid; sp < n_splits; sp += kMergeThreads) {
    const float2 ml = reinterpret_cast<const float2*>(part_ml)[first + (long)sp * rep];
    ms[sp] = ml.x;
    ls[sp] = ml.y;
  }
  __syncthreads();
  float mx = -INFINITY;   // every warp finds the max and the sum itself
  for (int sp = lane; sp < n_splits; sp += 32) mx = fmaxf(mx, ms[sp]);
  mx = warp_max(mx);
  float lsum = 0.f;
  if (mx != -INFINITY)
    for (int sp = lane; sp < n_splits; sp += 32) lsum += ls[sp] * exp2f(ms[sp] - mx);
  lsum = warp_sum(lsum);
  const int cols = d / VW, groups = kMergeThreads / cols, grp = tid / cols;
  const int dd = (tid - grp * cols) * VW;
  if (grp < groups) {
    float acc[VW] = {};
    if (mx != -INFINITY) {
#pragma unroll 4
      for (int sp = grp; sp < n_splits; sp += groups) {
        const float* src = part_acc + (first + (long)sp * rep) * d + dd;
        float v[VW];
        if constexpr (VW == 4) {
          const float4 x = *reinterpret_cast<const float4*>(src);
          v[0] = x.x;
          v[1] = x.y;
          v[2] = x.z;
          v[3] = x.w;
        } else {
          v[0] = src[0];
        }
        const float e = exp2f(ms[sp] - mx);
#pragma unroll
        for (int i = 0; i < VW; ++i) acc[i] = e != 0.f ? fmaf(v[i], e, acc[i]) : acc[i];
      }
    }
#pragma unroll
    for (int i = 0; i < VW; ++i) sums[grp * d + dd + i] = acc[i];
  }
  __syncthreads();
  if (tid < d) {
    float asum = 0.f;
    for (int k = 0; k < groups; ++k) asum += sums[k * d + tid];
    lapis_store(out, ((long)b * hq + h * rep + g) * d + tid, lsum == 0.f ? 0.f : asum / lsum);
  }
}

bool aligned16(const void* ptr, long stride_bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && stride_bytes % 16 == 0;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* out,
           void* part_ml, void* part_acc, int batch, int hkv, int rep, int s_len, int d,
           long q_sb, long q_sh, long k_sb, long k_sh, long k_ss, long v_sb, long v_sh,
           long v_ss, int window, float scale, float softcap, int n_splits, int chunk,
           void* stream) {
  if (batch < 0 || hkv <= 0 || rep <= 0 || s_len < 0 || d <= 0 || d > 256 || !(softcap >= 0.f) ||
      (long)batch * hkv > 2147483647L || n_splits < 1 || n_splits > 4096 || chunk <= 0 ||
      (long)n_splits * chunk < s_len)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const Plan p = da_plan(d, rep, chunk, kBf16);
  if (p.groups > 65535 || (n_splits > 1 && (part_ml == nullptr || part_acc == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long item = sizeof(T);
  Args a{q, k, v, static_cast<const int*>(lengths), out, static_cast<float*>(part_ml),
         static_cast<float*>(part_acc), q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, hkv,
         rep, s_len, d, window, chunk, n_splits, 0, 0, scale * 1.4426950408889634f, 0.f, 0.f};
  if (softcap > 0.f) {
    a.scale_log2 = 1.f;
    a.cap_in = scale / softcap;
    a.cap_log2 = softcap * 1.4426950408889634f;
  }
  a.vec = aligned16(k, item * k_sb) && aligned16(k, item * k_sh) && aligned16(k, item * k_ss) &&
          aligned16(v, item * v_sb) && aligned16(v, item * v_sh) && aligned16(v, item * v_ss);
  a.vec_q = aligned16(q, item * q_sb) && aligned16(q, item * q_sh);
  const dim3 grid(batch * hkv, n_splits, p.groups);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  void (*kernel)(const Args, const Plan);
  if constexpr (kBf16)
    kernel = p.mt == 1 ? (p.dp > 128 ? decode_attention_bf16_kernel<1, 16>
                                     : decode_attention_bf16_kernel<1, 8>)
             : p.mt == 2 ? decode_attention_bf16_kernel<2, 4>
                         : decode_attention_bf16_kernel<4, 2>;
  else
    kernel = decode_attention_f32_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, p.smem, st>>>(a, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return (int)err;
  if (rep > 65535) return (int)cudaErrorInvalidValue;
  const int vw = d % 4 == 0 ? 4 : 1;
  const size_t merge_smem = sizeof(float) * (2 * n_splits + kMergeThreads / (d / vw) * d);
  auto merge =
      vw == 4 ? decode_attention_merge_kernel<T, 4> : decode_attention_merge_kernel<T, 1>;
  merge<<<dim3(batch * hkv, rep), kMergeThreads, merge_smem, st>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<T*>(out), hkv, rep, d, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace

#define LAPIS_DA_EXPORT(NAME, T)                                                             \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* lengths,       \
                      void* out, void* part_ml, void* part_acc, int batch, int hkv, int rep,  \
                      int s_len, int d, long q_sb, long q_sh, long k_sb, long k_sh,           \
                      long k_ss, long v_sb, long v_sh, long v_ss, int window, float scale,    \
                      float softcap, int n_splits, int chunk, void* stream) {                 \
    return launch<T>(q, k, v, lengths, out, part_ml, part_acc, batch, hkv, rep, s_len, d,     \
                     q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, window, scale, softcap,  \
                     n_splits, chunk, stream);                                                \
  }
LAPIS_DA_EXPORT(lapis_decode_attention_f32, float)
LAPIS_DA_EXPORT(lapis_decode_attention_bf16, __nv_bfloat16)

// The launch plan at head dim d, rep query heads per KV head and chunk
// positions per split (bf16 != 0: the tensor-core kernel), for tests that
// hold the Python twin to it: heads, groups, mt, wd, dp, stages, smem bytes.
extern "C" int lapis_decode_attention_plan(int d, int rep, int chunk, int bf16, int* out) {
  if (d <= 0 || d > 256 || rep <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  const Plan p = da_plan(d, rep, chunk, bf16 != 0);
  const int v[7] = {p.heads, p.groups, p.mt, p.wd, p.dp, p.stages, p.smem};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}
