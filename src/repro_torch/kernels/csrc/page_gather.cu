// Paged KV gather on Hopper: out[s, h, b·bs:(b+1)·bs, :] = pool[table[s, b], h]
// for a block pool (n_blocks, heads, bs, hd) and a page table
// (n_slots, blocks_per_slot) of int32 block ids.
//
// Replaces the TPU kernel src/repro/kernels/paged_kv.py:page_gather_pallas
// (_gather_kernel, pallas_call at paged_kv.py:139).  There the page table
// is a scalar-prefetch operand read by the input index map, so grid step
// (s, b) is handed pool block table[s, b] in VMEM and copies it out.  Here
// one thread block per (slot, page) loads its own table[s, b] from device
// memory and, for each KV head, copies the contiguous bs × hd slab into
// the slot's contiguous view.  The copy is of bytes, so every pool dtype
// (f32, bf16, int8) takes the same path: 16-byte vector loads and stores
// when the slab's size and both base addresses allow, single bytes
// otherwise.  Positions past a slot's length are copied as they are (the
// consumer masks them, as in the reference).  A block id outside the
// pool is never read: its slab is written as zeros.
//
// Bound: one read of the gathered pool blocks and one write of the view
// over HBM bandwidth (2 × n_slots × blocks_per_slot × heads × slab bytes).
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void lapis_page_gather_kernel(const unsigned char* __restrict__ pool,
                                         const int* __restrict__ table,
                                         unsigned char* __restrict__ out,
                                         int blocks_per_slot, int heads,
                                         int n_blocks, long slab_bytes,
                                         int vec16) {
  const int b = blockIdx.x, s = blockIdx.y;
  const int blk = table[(long)s * blocks_per_slot + b];
  const bool in_pool = blk >= 0 && blk < n_blocks;
  for (int h = 0; h < heads; ++h) {
    const unsigned char* src =
        pool + (in_pool ? ((long)blk * heads + h) * slab_bytes : 0);
    unsigned char* dst =
        out + (((long)s * heads + h) * blocks_per_slot + b) * slab_bytes;
    if (vec16) {
      const uint4* s4 = reinterpret_cast<const uint4*>(src);
      uint4* d4 = reinterpret_cast<uint4*>(dst);
      for (long i = threadIdx.x; i < slab_bytes / 16; i += blockDim.x)
        d4[i] = in_pool ? s4[i] : make_uint4(0u, 0u, 0u, 0u);
    } else {
      for (long i = threadIdx.x; i < slab_bytes; i += blockDim.x)
        dst[i] = in_pool ? src[i] : (unsigned char)0;
    }
  }
}

extern "C" int lapis_page_gather(const void* pool, const void* table, void* out,
                                 int n_slots, int blocks_per_slot, int heads,
                                 int n_blocks, long slab_bytes, int vec16,
                                 void* stream) {
  if (n_slots < 0 || n_slots > 65535 || blocks_per_slot < 0 || heads < 0 ||
      slab_bytes < 0 || (vec16 && slab_bytes % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if (n_slots == 0 || blocks_per_slot == 0 || heads == 0 || slab_bytes == 0)
    return 0;
  const dim3 grid(blocks_per_slot, n_slots);
  lapis_page_gather_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)pool, (const int*)table, (unsigned char*)out,
      blocks_per_slot, heads, n_blocks, slab_bytes, vec16);
  return (int)cudaGetLastError();
}
