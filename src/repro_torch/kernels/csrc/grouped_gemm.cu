// The MoE's expert products over the routed rows alone, on Hopper: two
// grouped products over a compact (R, ·) buffer whose rows are sorted by
// expert, expert e owning rows offsets[e] .. offsets[e + 1] (read on the
// card, so the host never learns the loads):
//
//   gate_up:  h[r] = act(x[r] · Wg[e]) * (x[r] · Wu[e])   x (R, M), W (E, M, F)
//   down:     y[r] = h[r] · Wd[e]                          h (R, F), Wd (E, F, M)
//
// bf16 or f16 operands, f32 accumulators, the activation and the product
// applied in f32 before h is stored once.
//
// Replaces no TPU kernel: the reference leaves the expert FFNs to XLA, as
// three einsums over the padded (G, E, C, M) capacity buffers
// (src/repro/models/moe.py::expert_ffn), and the port ran them as three
// torch.einsum over the same padding.  At grok-1's decode (1,024 routed
// rows a layer over 8 experts) those ran 32,768 slot rows a layer.  Here
// only routed rows are computed.  What bounds the products:
//
// * at decode, HBM: every expert's three 6144 × 32768 matrices are read
//   for ~128 rows each, 128 FLOP a byte, under the card's ~295 ridge.
//   Each weight tile comes from HBM once per call for any load up to 192
//   rows: a block takes 192 rows of one expert (three consumer
//   warpgroups), so one expert's rows at decode are one row block.  A
//   larger load takes more row blocks, and those that share a weight tile
//   are neighbours in the walk, so neighbouring blocks load it at about
//   the same time and the later loads mostly hit L2 (any load is right;
//   its speed is free).  A 64-row stripe that holds no row of the expert
//   skips its tensor-core work.  What is left above the bytes bound is
//   mostly L2-to-SM traffic: the activations are read once a column
//   block, and the partial row blocks read whole tiles.
// * at large prefill loads, the bf16 tensor-core rate: a tile is 192 rows
//   × 256 f32 accumulators, as large as the registers of three consumer
//   warpgroups hold.
//
// Shape (from gemm_sm90.cuh): one persistent block an SM of 512 threads.
// Warpgroup 0 produces: after `setmaxnreg` gives its registers away, one
// thread issues TMA loads of the row block's 192 × 64 activation tile (a
// 3-D map (K, R, 1)) and four 64 × 64 weight chunks (a 3-D map (N, K, E),
// the expert as its third coordinate) into a ring of three 56 KB stages,
// full / empty mbarriers per stage.  Warpgroups 1-3 consume 64 rows each:
// per k16 step two wgmma m64n128k16, one per accumulator, A K-major and B
// (K × N row-major) MN-major through the transpose bit.  gate_up's two
// accumulators are the gate's and the up's 128 columns; down's are 256
// consecutive columns of Wd.  The epilogue writes each thread's column
// pairs straight from the registers (h and y are ~1% of the bytes),
// masked past the expert's rows and past N.
//
// The walk: an item is (expert, column block, K range, row block), the
// row block fastest; each block reads the offsets into shared memory and
// numbers the items from them.  down splits K where the row blocks the
// host can count on (R / 192) give too few items for the card: each K
// range writes f32 partial products to a workspace that a second kernel
// sums in a fixed order.
#include <cuda_fp16.h>

#include <type_traits>

#include "sm90.cuh"

namespace grouped {

constexpr int CWG = 3;                       // consumer warpgroups, 64 rows each
constexpr int BM = 64 * CWG, BN = 128, BK = 64;  // BN: one accumulator's columns
constexpr int STAGES = 3;
constexpr int THREADS = 128 * (CWG + 1);     // a producer warpgroup and the consumers
constexpr int CONSUMERS = 128 * CWG;         // each consumer thread arrives on `empty`
// registers a thread after setmaxnreg: the producer gives its own away to
// the consumers' 128 accumulators (65,536 an SM)
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 160;
constexpr int MAX_EXPERTS = 1024;
constexpr uint32_t A_BYTES = BM * BK * 2;        // 24 KB
constexpr uint32_t CHUNK_BYTES = BK * 64 * 2;    // 64 K rows of 64 columns: 8 KB
constexpr uint32_t B_BYTES = 4 * CHUNK_BYTES;    // two accumulators' 128 columns
constexpr uint32_t STAGE_BYTES = A_BYTES + B_BYTES;
// 1 KB of slack aligns the ring to the swizzle's 1 KB period; then the
// ring, the mbarriers (full and empty per stage), the offsets and the
// first item of each expert
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 8 * 2 * STAGES + 2 * 4 * (MAX_EXPERTS + 1);
constexpr int ACT_SILU = 0, ACT_GELU = 1;

// D(64 × 128, f32) += A(64 × 16) · B(16 × 128), both in shared memory, A
// K-major, B MN-major (the transpose bit), in TY = "bf16" or "f16"
#define LAPIS_WGMMA_N128(TY)                                                              \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                            \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"                \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"       \
  " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"       \
  " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"      \
  " %64, %65, p, 1, 1, 0, 1;\n}\n"
#define LAPIS_ACC64(d)                                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),     \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),       \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),       \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),       \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),       \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),       \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

template <typename T>
__device__ __forceinline__ void mma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(LAPIS_WGMMA_N128("f16") : LAPIS_ACC64(d) : "l"(da), "l"(db), "r"(1));
  else
    asm volatile(LAPIS_WGMMA_N128("bf16") : LAPIS_ACC64(d) : "l"(da), "l"(db), "r"(1));
}

template <int ACT>
__device__ __forceinline__ float act(float g) {
  if constexpr (ACT == ACT_SILU) return g / (1.f + expf(-g));
  else  // gelu, the tanh form (models/layers.py::activation)
    return 0.5f * g * (1.f + tanhf(0.7978845608028654f * (g + 0.044715f * g * g * g)));
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store_pair(__half* p, float x, float y) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
}

struct Item {
  int e, row0, rows, n0, ks, k_lo, k_hi;
};

// GATE_UP: h = act(x Wg) * (x Wu) (tb1 = Wu, n_tile = BN); else y = h Wd
// (n_tile = 2 BN), to `out` where split == 1, else to the workspace
// ws[ks] (split × R × N f32).  N: the output's columns; K: the depth.
template <typename T, bool GATE_UP, int ACT>
__global__ void __launch_bounds__(THREADS, 1)
    lapis_grouped_kernel(const __grid_constant__ CUtensorMap ta,
                         const __grid_constant__ CUtensorMap tb0,
                         const __grid_constant__ CUtensorMap tb1, const int* __restrict__ offsets,
                         T* __restrict__ out, float* __restrict__ ws, int R, int E, int N, int K,
                         int split, int k_chunk) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + STAGES * STAGE_BYTES;
  int* const off = reinterpret_cast<int*>(smem_raw + (base - raw) + STAGES * STAGE_BYTES +
                                          8 * 2 * STAGES);
  int* const first = off + MAX_EXPERTS + 1;  // first[e]: expert e's first item
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };
  auto s_a = [&](int s) { return base + s * STAGE_BYTES; };
  auto s_b = [&](int s) { return base + s * STAGE_BYTES + A_BYTES; };

  constexpr int N_TILE = GATE_UP ? BN : 2 * BN;
  const int n_blocks = (N + N_TILE - 1) / N_TILE;
  for (int i = threadIdx.x; i <= E; i += THREADS) off[i] = offsets[i];
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int e = 0; e < E; ++e) {
      first[e] = t;
      t += (off[e + 1] - off[e] + BM - 1) / BM * n_blocks * split;
    }
    first[E] = t;
  }
  __syncthreads();
  const int n_items = first[E];

  // item t: the expert whose items hold it (the last e with first[e] <
  // = t has items: an empty expert's first equals the next one's), then
  // its row block (fastest), K range and column block
  auto item = [&](int t) {
    int lo = 0, hi = E - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (first[mid] <= t) lo = mid;
      else hi = mid - 1;
    }
    Item it;
    it.e = lo;
    const int load = off[lo + 1] - off[lo];
    const int blocks_m = (load + BM - 1) / BM;
    const int local = t - first[lo];
    const int mb = local % blocks_m, rest = local / blocks_m;
    it.ks = rest % split;
    it.n0 = rest / split * N_TILE;
    it.row0 = off[lo] + mb * BM;
    it.rows = min(BM, load - mb * BM);
    it.k_lo = it.ks * k_chunk;
    it.k_hi = min(K, it.k_lo + k_chunk);
    return it;
  };

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full across the block's items
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    if (threadIdx.x == 0) {
      int g = 0;  // K steps issued so far: ring slot g % STAGES
      for (int t = blockIdx.x; t < n_items; t += gridDim.x) {
        const Item it = item(t);
        for (int k0 = it.k_lo; k0 < it.k_hi; k0 += BK, ++g) {
          const int s = g % STAGES;
          mbar_wait(empty(s), ((g / STAGES) & 1) ^ 1);
          mbar_expect_tx(full(s), STAGE_BYTES);
          tma_load(s_a(s), &ta, full(s), k0, it.row0, 0);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            // chunks 0-1: the first accumulator's 128 columns; 2-3: the
            // second's (Wu's same columns, or Wd's next 128)
            const CUtensorMap* map = GATE_UP && c >= 2 ? &tb1 : &tb0;
            const int col = it.n0 + 64 * (GATE_UP ? c % 2 : c);
            tma_load(s_b(s) + c * CHUNK_BYTES, map, full(s), col, k0, it.e);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
    const int cw = wg - 1;  // consumer warpgroup: rows row0 + 64 cw ...
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int r0 = 16 * (tid / 32) + lane / 4;  // this thread's rows: r0, r0 + 8
    int g = 0;
    for (int t = blockIdx.x; t < n_items; t += gridDim.x) {
      const Item it = item(t);
      const bool active = 64 * cw < it.rows;  // the stripe holds rows of the expert
      float acc0[64], acc1[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
      int prev = -1;  // the slot whose group is still in flight
      for (int k0 = it.k_lo; k0 < it.k_hi; k0 += BK, ++g) {
        const int s = g % STAGES;
        mbar_wait(full(s), (g / STAGES) & 1);
        if (active) {
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < BK / 16; ++ks) {
            // A: this warpgroup's 64 rows, 32 bytes a k16 step inside the
            // swizzled rows; B: 16 K rows (2 KB) a step, 64-column chunks
            // CHUNK_BYTES apart (LBO), 8-row groups 1 KB apart (SBO)
            const uint64_t da = sw128_desc(s_a(s) + cw * 64 * 128 + ks * 32, 16, 1024);
            mma_n128<T>(acc0, da, sw128_desc(s_b(s) + ks * 16 * 128, CHUNK_BYTES, 1024));
            mma_n128<T>(acc1, da,
                        sw128_desc(s_b(s) + 2 * CHUNK_BYTES + ks * 16 * 128, CHUNK_BYTES, 1024));
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous step's group is done: free its slot
        }
        if (prev >= 0) mbar_arrive(empty(prev));
        prev = s;
      }
      if (active) {
        wgmma_wait_all();
        fence_regs(acc0);
        fence_regs(acc1);
      }
      if (prev >= 0) mbar_arrive(empty(prev));
      if (!active) continue;

      // epilogue: fragment i of an accumulator is row r0 + 8 ((i / 2) %
      // 2), column 8 (i / 4) + 2 (lane % 4) + i % 2 of the warpgroup's
      // 64 × 128 tile; each thread stores its column pairs
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 64 * cw + r0 + 8 * h;
        if (r >= it.rows) continue;
        const long long row = it.row0 + r;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int i = 4 * j + 2 * h;
          const int col = it.n0 + 8 * j + 2 * (lane % 4);
          if constexpr (GATE_UP) {
            if (col < N)
              store_pair(out + row * N + col, act<ACT>(acc0[i]) * acc1[i],
                         act<ACT>(acc0[i + 1]) * acc1[i + 1]);
          } else if (split == 1) {
            if (col < N) store_pair(out + row * N + col, acc0[i], acc0[i + 1]);
            if (col + BN < N) store_pair(out + row * N + col + BN, acc1[i], acc1[i + 1]);
          } else {
            float* const w = ws + ((long long)it.ks * R + row) * N;
            if (col < N) store_pair(w + col, acc0[i], acc0[i + 1]);
            if (col + BN < N) store_pair(w + col + BN, acc1[i], acc1[i + 1]);
          }
        }
      }
    }
  }
}

// y[r] = the sum of the split workspaces' rows in order, for the rows the
// products filled (offsets[E] of them), four columns a thread
template <typename T>
__global__ void lapis_grouped_reduce(const float* __restrict__ ws, T* __restrict__ y,
                                     const int* __restrict__ offsets, int R, int E, int N,
                                     int split) {
  const long long total = (long long)offsets[E] * N / 4;
  const long long plane = (long long)R * N / 4;
  const float4* const w = reinterpret_cast<const float4*>(ws);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float4 s = w[i];
    for (int k = 1; k < split; ++k) {
      const float4 v = w[k * plane + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    store_pair(y + 4 * i, s.x, s.y);
    store_pair(y + 4 * i + 2, s.z, s.w);
  }
}

// A 3-D map (inner, rows, matrices) of a 2-byte operand, 128-byte-swizzled
// boxes of 64 inner elements × box_rows × 1
static bool map3(CUtensorMap* map, const void* ptr, int inner, int rows, int mats,
                 int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)mats};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2, (cuuint64_t)inner * rows * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return encode_bf16_sw128(map, ptr, 3, dims, strides, box);
}

template <typename T, bool GATE_UP, int ACT>
static int launch(const void* a, const void* b0, const void* b1, const int* offsets, T* out,
                  float* ws, int R, int E, int N, int K, int split, int k_chunk, int blocks,
                  cudaStream_t stream) {
  CUtensorMap ta, tb0, tb1;
  if (!map3(&ta, a, K, R, 1, BM) || !map3(&tb0, b0, N, K, E, BK) ||
      !map3(&tb1, b1, N, K, E, BK))
    return (int)cudaErrorInvalidValue;
  auto kern = lapis_grouped_kernel<T, GATE_UP, ACT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  kern<<<blocks, THREADS, SMEM_BYTES, stream>>>(ta, tb0, tb1, offsets, out, ws, R, E, N, K,
                                                split, k_chunk);
  return (int)cudaGetLastError();
}

// what TMA and the walk need of the extents; the wrapper checks the rest
static bool extents_ok(int R, int E, int M, int F, int blocks) {
  return R > 0 && E > 0 && E <= MAX_EXPERTS && M > 0 && F > 0 && M % 8 == 0 && F % 8 == 0 &&
         blocks > 0;
}

template <typename T>
static int gate_up(int act_kind, const void* x, const void* wg, const void* wu,
                   const int* offsets, void* h, int R, int E, int M, int F, int blocks,
                   cudaStream_t st) {
  T* const o = static_cast<T*>(h);
  if (act_kind == ACT_SILU)
    return launch<T, true, ACT_SILU>(x, wg, wu, offsets, o, nullptr, R, E, F, M, 1, M, blocks,
                                     st);
  return launch<T, true, ACT_GELU>(x, wg, wu, offsets, o, nullptr, R, E, F, M, 1, M, blocks,
                                   st);
}

template <typename T>
static int down(const void* h, const void* wd, const int* offsets, void* y, float* ws, int R,
                int E, int F, int M, int split, int k_chunk, int blocks, int reduce_blocks,
                cudaStream_t st) {
  T* const o = static_cast<T*>(y);
  int err = launch<T, false, ACT_SILU>(h, wd, wd, offsets, o, ws, R, E, M, F, split, k_chunk,
                                       blocks, st);
  if (err != 0 || split == 1) return err;
  lapis_grouped_reduce<T><<<reduce_blocks, 256, 0, st>>>(ws, o, offsets, R, E, M, split);
  return (int)cudaGetLastError();
}

}  // namespace grouped

// dtype: 0 bf16, 1 f16; act: 0 silu, 1 gelu (tanh form).  x (R,
// M), wg / wu (E, M, F), h (R, F), contiguous; offsets (E + 1) int32 on
// the card.  blocks: the persistent grid.  Returns the cudaError_t.
extern "C" int lapis_grouped_gate_up(int dtype, int act, const void* x, const void* wg,
                                     const void* wu, const int* offsets, void* h, int R, int E,
                                     int M, int F, int blocks, void* stream) {
  if (!grouped::extents_ok(R, E, M, F, blocks) || act < 0 || act > 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return grouped::gate_up<__half>(act, x, wg, wu, offsets, h, R, E, M, F, blocks, st);
  return grouped::gate_up<__nv_bfloat16>(act, x, wg, wu, offsets, h, R, E, M, F, blocks, st);
}

// h (R, F), wd (E, F, M), y (R, M), contiguous; ws: split × R × M f32
// where split > 1 (K = F cut into ranges of k_chunk, a multiple of 64),
// summed into y by reduce_blocks blocks of 256 threads.
extern "C" int lapis_grouped_down(int dtype, const void* h, const void* wd, const int* offsets,
                                  void* y, void* ws, int R, int E, int F, int M, int split,
                                  int k_chunk, int blocks, int reduce_blocks, void* stream) {
  if (!grouped::extents_ok(R, E, M, F, blocks) || split < 1 || k_chunk < 1 ||
      k_chunk % grouped::BK != 0 || (split > 1 && (ws == nullptr || reduce_blocks < 1)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* const w = static_cast<float*>(ws);
  if (dtype == 1)
    return grouped::down<__half>(h, wd, offsets, y, w, R, E, F, M, split, k_chunk, blocks,
                                 reduce_blocks, st);
  return grouped::down<__nv_bfloat16>(h, wd, offsets, y, w, R, E, F, M, split, k_chunk, blocks,
                                      reduce_blocks, st);
}
