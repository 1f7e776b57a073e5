// Flash-attention forward for bf16 on Hopper (GQA, causal / sliding-window
// masks, optional tanh logit softcap, Sq != Skv with ragged tails):
//   out[b, h, i] = softmax_j(mask(cap(q[b, h, i] . k[b, h / group, j] * scale))) v[b, h / group, j]
// bf16 operands on the tensor cores, f32 accumulation and online softmax,
// bf16 output.  The f32 path keeps the FFMA kernel of flash_attention.cu.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention
// (_attn_kernel, pallas_call at flash_attention.py:120).  There the grid is
// (B*Hq, Sq/bq, Skv/bkv) with the KV axis sequential, carrying (m, l, acc) in
// VMEM.  Here one block of 384 threads takes one (b*Hq + h, 128-query tile)
// and walks its KV tiles itself:
//
// * warpgroup 0 is the producer: after `setmaxnreg` gives its registers
//   away, one thread issues TMA loads (cp.async.bulk.tensor, 4-D tensor maps
//   over (D, S, H, B) with the caller's strides, so the model's transposed
//   views are read in place) of the Q tile once and of K and V tiles into a
//   ring of two or three stages, with full / empty mbarriers per stage;
// * warpgroups 1 and 2 are consumers of 64 query rows each:
//   S = Q.K^T by wgmma m64nBKVk16 with both operands in shared memory (bf16,
//   128-byte swizzled rows as TMA writes them, K-major), an online softmax
//   on the f32 accumulator fragments (row max over a quad by two shuffles,
//   exp2f with scale * log2(e) folded in, masks only on the tiles that
//   cross the diagonal, the window's edge or Skv), then P converted to
//   bf16 in registers as the A operand of O += P.V by wgmma m64nDk16, V read
//   MN-major from shared memory (the transpose bit).  O stays in f32
//   registers, rescaled by alpha each tile; the epilogue divides by l.
//
// A KV tile wholly above the causal diagonal or wholly before the window is
// never loaded (the reference's pl.when); causal blocks launch the heaviest
// query tiles first.  TMA zero-fills rows past S and head-dim columns past D
// (D is padded to a multiple of 64 in shared memory: one 128-byte swizzle
// atom per 64 columns), and the scores of key rows past Skv are masked.  A
// row with no valid key writes 0.
//
// Tiles: BQ = 128 (two consumer warpgroups); BKV = 128 and three stages
// for D <= 128 (D = 128: Q 32 KB + 3 x (K + V) 192 KB), BKV = 64 and two
// stages above (D = 256: Q 64 KB + 2 x (K + V) 128 KB); O takes D / 2 f32
// registers a consumer thread, 128 at D = 256, of the 240 that setmaxnreg
// gives them.
//
// Bound: the bf16 tensor-core rate for the unmasked (q, k) pairs (4 * D
// operations each); bytes at HBM bandwidth only for short sequences.
#include <math.h>

#include "sm90.cuh"  // mbarriers, TMA, the swizzle descriptor, wgmma, the encoder

namespace {

constexpr int kBQ = 128;         // query rows a block owns
constexpr int kThreads = 384;    // a producer warpgroup and two consumers
constexpr int kConsumers = 256;  // consumer threads: each arrives on `empty`
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int padded_dim(int d) { return (d + 63) / 64 * 64; }
__host__ __device__ constexpr int kv_tile(int dp) { return dp <= 128 ? 128 : 64; }
// K / V ring depth: three stages where they fit in shared memory
__host__ __device__ constexpr int stages(int dp) { return dp <= 128 ? 3 : 2; }
// 1024 bytes of slack align the tiles to the 128-byte swizzle's 1 KB
// period; the mbarriers (q, then k_full, v_full and empty per stage) last
__host__ __device__ constexpr int smem_bytes(int dp) {
  return 1024 + kBQ * dp * 2 + stages(dp) * 2 * kv_tile(dp) * dp * 2 +
         8 * (1 + 3 * stages(dp));
}

// DP: the head dim padded to a multiple of 64 (the shared-memory width)
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    lapis_flash_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                            int hq, int group, int sq, int skv, int d, int causal, int window,
                            float scale, float softcap) {
  constexpr int BKV = kv_tile(DP), CHUNKS = DP / 64, STAGES = stages(DP);
  constexpr uint32_t Q_BYTES = kBQ * DP * 2, KV_BYTES = BKV * DP * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  // Q: CHUNKS column chunks of kBQ rows x 128 B; K and V: STAGES stages of
  // CHUNKS chunks of BKV rows x 128 B each; then the barriers
  const uint32_t s_q = base, s_k = base + Q_BYTES, s_v = s_k + STAGES * KV_BYTES;
  const uint32_t bar_q = s_v + STAGES * KV_BYTES;
  auto k_full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto v_full = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + 2 * STAGES + s); };

  const int bh = blockIdx.x, b = bh / hq, h = bh % hq, hk = h / group;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // heaviest first
  const int q0 = qt * kBQ;
  const int kv_end = causal ? min(skv, q0 + kBQ) : skv;
  const int kv_lo = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_lo / BKV;
  const int n_tiles = max(0, (kv_end + BKV - 1) / BKV - t_begin);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, Q_BYTES);
      for (int c = 0; c < CHUNKS; ++c)
        tma_load(s_q + c * kBQ * 128, &tq, bar_q, 64 * c, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const int k0 = (t_begin + i) * BKV;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(k_full(s), KV_BYTES);
        for (int c = 0; c < CHUNKS; ++c)
          tma_load(s_k + s * KV_BYTES + c * BKV * 128, &tk, k_full(s), 64 * c, k0, hk, b);
        mbar_expect_tx(v_full(s), KV_BYTES);
        for (int c = 0; c < CHUNKS; ++c)
          tma_load(s_v + s * KV_BYTES + c * BKV * 128, &tv, v_full(s), 64 * c, k0, hk, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;  // consumer warpgroup: query rows q0 + 64 cw ...
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int r_lo = q0 + 64 * cw;                  // this warpgroup's first row
    const int row0 = r_lo + 16 * (tid / 32) + lane / 4;  // this thread's rows: row0, row0 + 8
    const float scale_log2 = scale * kLog2e;
    float o[DP / 2];
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) o[e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const uint32_t q_wg = s_q + cw * 64 * 128;
    mbar_wait(bar_q, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      const uint32_t parity = (i / STAGES) & 1;
      const int k0 = (t_begin + i) * BKV;
      float sc[BKV / 2];
#pragma unroll
      for (int e = 0; e < BKV / 2; ++e) sc[e] = 0.f;

      // S = Q . K^T over D in steps of 16 (columns past D are zero in both)
      mbar_wait(k_full(s), parity);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        if (ks * 16 < d) {
          // 64-column chunk ks / 4, 32-byte step ks % 4 inside its rows
          const uint32_t off = (ks % 4) * 32;
          wgmma_ss<BKV>(sc, sw128_desc(q_wg + (ks / 4) * kBQ * 128 + off, 16, 1024),
                        sw128_desc(s_k + s * KV_BYTES + (ks / 4) * BKV * 128 + off, 16, 1024),
                        ks > 0);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // logits in log2 units; masks only where the tile needs them.
      // Fragment e of a thread: row row0 + 8 ((e / 2) % 2), column
      // k0 + 8 (e / 4) + 2 (lane % 4) + e % 2.
      if (softcap > 0.f) {
#pragma unroll
        for (int e = 0; e < BKV / 2; ++e) sc[e] = softcap * tanhf(sc[e] * scale / softcap) * kLog2e;
      } else {
#pragma unroll
        for (int e = 0; e < BKV / 2; ++e) sc[e] *= scale_log2;
      }
      const bool masked = k0 + BKV > skv || (causal && k0 + BKV - 1 > r_lo) ||
                          (window >= 0 && k0 <= r_lo + 63 - window);
      if (masked) {
#pragma unroll
        for (int e = 0; e < BKV / 2; ++e) {
          const int row = row0 + 8 * ((e / 2) % 2);
          const int col = k0 + 8 * (e / 4) + 2 * (lane % 4) + e % 2;
          const bool ok =
              col < skv && (!causal || col <= row) && (window < 0 || col > row - window);
          if (!ok) sc[e] = -INFINITY;
        }
      }

      // online softmax: the row max over the quad that shares the row
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int e = 0; e < BKV / 2; ++e) mx[(e / 2) % 2] = fmaxf(mx[(e / 2) % 2], sc[e]);
      float alpha[2], shift[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        shift[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // no valid key yet
        alpha[r] = exp2f(m[r] - shift[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];  // this thread's share of the row sum
      }
#pragma unroll
      for (int e = 0; e < BKV / 2; ++e) {
        sc[e] = exp2f(sc[e] - shift[(e / 2) % 2]);
        l[(e / 2) % 2] += sc[e];
      }
#pragma unroll
      for (int e = 0; e < DP / 2; ++e) o[e] *= alpha[(e / 2) % 2];
      // P as bf16 A fragments: the accumulator layout of 16 key columns is
      // the register-A layout of one k16 step
      uint32_t pa[BKV / 16][4];
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kc][r] = pack_bf16(sc[8 * kc + 2 * r], sc[8 * kc + 2 * r + 1]);

      // O += P . V; V is MN-major: 64-column chunks BKV * 128 B apart (LBO),
      // 8-row groups 1 KB apart (SBO)
      mbar_wait(v_full(s), parity);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc)
        wgmma_rs<DP>(o, pa[kc], sw128_desc(s_v + s * KV_BYTES + kc * 16 * 128, BKV * 128, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      mbar_arrive(empty(s));
    }

    // epilogue: the full row sums, O / l, bf16 pairs
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= sq) continue;
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
      __nv_bfloat16* dst = out + (static_cast<long>(bh) * sq + row) * d + 2 * (lane % 4);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        if (8 * n < d)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
              __floats2bfloat162_rn(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
      }
    }
  }
}

// a (B, H, S, D) bf16 operand as a 4-D map over (D, S, H, B): boxes of 64
// columns x `rows` positions, 128-byte swizzle, zeros outside
bool tensor_map(CUtensorMap* map, const void* ptr, int d, int s, int h, int b, const long* st,
                int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)h, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  return encode_bf16_sw128(map, ptr, 4, dims, strides, box);
}

template <int DP>
int launch_dp(const void* q, const void* k, const void* v, void* out, int batch, int hq, int hkv,
              int sq, int skv, int d, const long* st, int causal, int window, float scale,
              float softcap, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  // an empty Skv loads no tile: its maps only need to be valid, so they
  // describe one row of q
  const bool none = skv == 0;
  if (!tensor_map(&tq, q, d, sq, hq, batch, st, kBQ) ||
      !tensor_map(&tk, none ? q : k, d, none ? 1 : skv, hkv, batch, none ? st : st + 3,
                  kv_tile(DP)) ||
      !tensor_map(&tv, none ? q : v, d, none ? 1 : skv, hkv, batch, none ? st : st + 6,
                  kv_tile(DP)))
    return (int)cudaErrorInvalidValue;
  constexpr int bytes = smem_bytes(DP);
  auto kern = lapis_flash_sm90_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * hq, (sq + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, bytes, stream>>>(tq, tk, tv, (__nv_bfloat16*)out, hq, hq / hkv, sq, skv,
                                          d, causal, window, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: bf16 (B, H, S, D) with D contiguous; strides (batch, head,
// position) of q, k, v in elements, each a multiple of 8 with the base
// 16-byte aligned (what TMA reads); out: contiguous (B, Hq, Sq, D)
extern "C" int lapis_flash_attention_sm90(const void* q, const void* k, const void* v,
                                          void* out, int batch, int hq, int hkv, int sq,
                                          int skv, int d, const long* strides, int causal,
                                          int window, float scale, float softcap,
                                          void* stream) {
  if (batch < 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq < 0 || skv < 0 || d <= 0 ||
      d % 16 != 0 || d > 256 || (long)batch * hq > 0x7fffffffL || (sq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || sq == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (padded_dim(d)) {
    case 64:
      return launch_dp<64>(q, k, v, out, batch, hq, hkv, sq, skv, d, strides, causal, window,
                           scale, softcap, st);
    case 128:
      return launch_dp<128>(q, k, v, out, batch, hq, hkv, sq, skv, d, strides, causal, window,
                            scale, softcap, st);
    case 192:
      return launch_dp<192>(q, k, v, out, batch, hq, hkv, sq, skv, d, strides, causal, window,
                            scale, softcap, st);
    case 256:
      return launch_dp<256>(q, k, v, out, batch, hq, hkv, sq, skv, d, strides, causal, window,
                            scale, softcap, st);
  }
  return (int)cudaErrorInvalidValue;
}

// the launch plan for head dim d: {query rows, KV rows, stages, padded D,
// dynamic shared-memory bytes}, for the wrapper's checks
extern "C" void lapis_flash_sm90_plan(int d, int* plan) {
  const int dp = padded_dim(d);
  plan[0] = kBQ;
  plan[1] = kv_tile(dp);
  plan[2] = stages(dp);
  plan[3] = dp;
  plan[4] = smem_bytes(dp);
}
