// Elementwise skeleton for mapped kokkos.* nests, written by hand; the
// region code generator (kernels/codegen.py) supplies only the per-element
// body and an extern "C" launcher.
//
// Replaces the TPU kernel src/repro/kernels/generic.py:block_map /
// block_map_region (pallas_call at generic.py:50).  There each grid step
// copies one tiling["block"] block of every operand into VMEM, runs the
// nest body on it and writes the result block back, with the operands
// padded to whole blocks.  Here one thread block walks one tile of the
// iteration space with a block-stride loop and masks the ragged tail in
// place; the grid walks the tiles with a grid-stride loop, so a grid
// clamped to the hardware's limits still covers every tile.  The body of
// a fused region keeps its intermediates in registers, so a chain of N
// elementwise ops is one launch that reads each operand once and writes
// the result once — the bound is those bytes over HBM bandwidth.
//
// The iteration space is viewed as (L, R, C): C the last axis, R the one
// before it, L every leading axis flattened.  The tile is (bl, br, bc),
// from tiling["block"] the same way; map_parallelism collapses leading
// block dims from the outside in, so a tile's leading part is always a
// contiguous run of the flattened L axis.
#pragma once
#include <cuda_runtime.h>

#include "lapis_cuda.cuh"
#include "lapis_scalar.h"

struct LapisTile {
  long L, R, C;    // iteration space
  int bl, br, bc;  // tile extents
};

// Body: a functor with `void operator()(long flat_index) const` that
// loads its operands at the index, computes, and stores the result.
template <class Body>
__global__ void lapis_block_map_kernel(Body body, LapisTile t) {
  const long tiles_c = (t.C + t.bc - 1) / t.bc;
  const long tiles_r = (t.R + t.br - 1) / t.br;
  const long tiles_l = (t.L + t.bl - 1) / t.bl;
  const int tile_elems = t.bl * t.br * t.bc;
  const int plane = t.br * t.bc;
  for (long tz = blockIdx.z; tz < tiles_l; tz += gridDim.z)
    for (long ty = blockIdx.y; ty < tiles_r; ty += gridDim.y)
      for (long tx = blockIdx.x; tx < tiles_c; tx += gridDim.x) {
        const long l0 = tz * t.bl, r0 = ty * t.br, c0 = tx * t.bc;
        for (int e = threadIdx.x; e < tile_elems; e += blockDim.x) {
          const long c = c0 + e % t.bc;
          const long r = r0 + (e % plane) / t.bc;
          const long l = l0 + e / plane;
          if (l < t.L && r < t.R && c < t.C) body((l * t.R + r) * t.C + c);
        }
      }
}

template <class Body>
inline int lapis_launch_block_map(const Body& body, LapisTile t,
                                  cudaStream_t stream) {
  const long tiles_c = (t.C + t.bc - 1) / t.bc;
  const long tiles_r = (t.R + t.br - 1) / t.br;
  const long tiles_l = (t.L + t.bl - 1) / t.bl;
  if (tiles_c == 0 || tiles_r == 0 || tiles_l == 0) return 0;  // empty
  const long tile_elems = (long)t.bl * t.br * t.bc;
  const int threads = tile_elems >= 256 ? 256 : (int)((tile_elems + 31) / 32 * 32);
  const dim3 grid((unsigned)(tiles_c < 2147483647L ? tiles_c : 2147483647L),
                  (unsigned)(tiles_r < 65535L ? tiles_r : 65535L),
                  (unsigned)(tiles_l < 65535L ? tiles_l : 65535L));
  lapis_block_map_kernel<Body><<<grid, threads, 0, stream>>>(body, t);
  return (int)cudaGetLastError();
}
