"""``loops`` reference backend — an eager-torch loop-nest interpreter.

This is the repro analogue of the paper's generated-Kokkos-loops path: no
library matmul interception, no hand kernels — every op executes as an
explicit loop nest over tiles of its iteration space, with only
elementwise arithmetic and reductions inside each tile (what
dense-linalg-to-parallel-loops + kokkos-loop-mapping would emit as
``Kokkos::parallel_for`` nests).  It exists to (a) prove the plugin API —
it registers entirely through ``repro_torch.core.backend`` with zero edits
to core files — and (b) serve as the slow-but-obviously-correct baseline.
"""
from __future__ import annotations

import torch

from repro_torch.core.backend import (Backend, LevelSpec, ParallelHierarchy,
                                      register_backend, register_kernel)
from repro_torch.kernels import paged_kv as _pk

# The declared hierarchy: sequential host loops around a torch-vectorized
# innermost level.  It is the reference's serial hierarchy, level names
# included, so the IR this backend produces is the reference's, text for
# text.  launch_overhead_s=0.0 keeps the cost model's fusion gate closed
# here: the loops are one host program with no dispatch boundary to save.
SERIAL_HIERARCHY = ParallelHierarchy(
    exec_space="host",
    levels=(LevelSpec("serial"),
            LevelSpec("serial-block", width=8, max_extent=512),
            LevelSpec("jnp-vector", width=128, max_extent=1024)),
    scratch_bytes=96 * 2**20,
    compute_unit=128,
    launch_overhead_s=0.0)

# Cap on a single tile's broadcast working set (bm × k × n elements).  The
# loop nest materializes the elementwise product before reducing, so the
# row-block size is shrunk until a tile fits.
_TILE_BUDGET_ELEMS = 2 ** 24


def _row_block(bm: int, k: int, n: int) -> int:
    bm = max(int(bm), 1)
    while bm > 1 and bm * k * n > _TILE_BUDGET_ELEMS:
        bm //= 2
    return bm


def _gemm_tile(a_blk, b):
    # thread × vector loops: broadcast-multiply then reduce over k — the
    # textbook triple loop, vectorized per tile (no library call)
    return torch.sum(a_blk[:, :, None] * b[None, :, :], dim=1)


def gemm_loops(a, b, *, tiling=None):
    t = tiling or {}
    m, k = a.shape
    n = b.shape[1]
    bm = _row_block(t.get("bm", 8), k, n)
    rows = [_gemm_tile(a[i0:i0 + bm], b)        # team loop over row blocks
            for i0 in range(0, m, bm)]
    return torch.cat(rows, dim=0).to(a.dtype)


def gemv_loops(a, x, *, tiling=None):
    t = tiling or {}
    m, k = a.shape
    bm = _row_block(t.get("bm", 64), k, 1)
    rows = [torch.sum(a[i0:i0 + bm] * x[None, :], dim=1)
            for i0 in range(0, m, bm)]
    return torch.cat(rows, dim=0).to(a.dtype)


def batched_gemm_loops(a, b, *, tiling=None):
    t = tiling or {}
    *batch, m, k = a.shape
    n = b.shape[-1]
    a2 = a.reshape((-1, m, k))
    b2 = b.reshape((-1,) + tuple(b.shape[-2:])) if b.ndim > 2 else b
    bb = max(int(t.get("batch_block", 1) or 1), 1)
    while bb > 1 and bb * m * k * n > _TILE_BUDGET_ELEMS:
        bb //= 2
    blocks = []
    for i0 in range(0, a2.shape[0], bb):        # grid loop over the batch
        a_blk = a2[i0:i0 + bb]
        b_blk = b2[i0:i0 + bb] if b2.ndim == 3 else b2[None]
        blocks.append(torch.sum(a_blk[:, :, :, None] * b_blk[:, None, :, :],
                                dim=2))
    out = blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=0)
    return out.reshape(tuple(batch) + (m, n)).to(a.dtype)


def _parallel_nest_loops(op, options):
    """Interpret a mapped ``kokkos.range_parallel``/``kokkos.team_parallel``
    nest as a Python serial loop over row blocks with the op's torch body
    applied per tile.  A nest lowered from a ``kokkos.fused`` region runs
    the whole recorded sub-op chain inside each tile — the serial-nest
    equivalent of the single-kernel fused launch."""
    from repro_torch.core import refs
    fn = (refs.region_ref(op.regions[0]) if op.regions
          else op.attrs["fn"])
    kind = op.attrs["kind"]
    shape = op.results[0].type.shape
    block = (op.attrs.get("tiling") or {}).get("block", shape)
    if kind == "reduce":
        # tiling splits axis 0, so the reduced axis must not be axis 0
        axis = op.attrs.get("axis", -1)
        ndim = len(shape)
        if ndim < 2 or axis % ndim == 0:
            return lambda *args: fn(*args)   # single tile, no split

    def run(*args):
        if not shape:
            return fn(*args)
        b0 = min(block[0] if block else shape[0], shape[0]) or shape[0]
        tiles = [fn(*(a[i0:i0 + b0] for a in args))
                 for i0 in range(0, shape[0], b0)]
        return torch.cat(tiles, dim=0)

    return run


def loops_executor(op, options):
    """Claim mapped ``kokkos.*`` nests for serial-tile interpretation."""
    if op.opname in ("kokkos.range_parallel", "kokkos.team_parallel"):
        return _parallel_nest_loops(op, options)
    if op.opname == "kokkos.fused":
        # an unlowered fused region (mixed operand shapes): one composed
        # serial evaluation of the recorded chain
        from repro_torch.core import refs
        return refs.region_ref(op.regions[0])
    return None


def _sparse_row_blocks(a, dense, reference, tiling, max_nnz_row):
    """Shared generated-loops harness for the sparse ops: the §4.2 team
    loop over ELL row blocks, with the *reference contraction* applied
    per tile (one implementation of the math, blocked here).  Without a
    static ELL width the sparsify pass inserts no conversion, and the
    CSR operand runs the plain reference."""
    from repro_torch.kernels.spmv import CsrMatrix, EllMatrix, as_ell
    if isinstance(a, CsrMatrix) and max_nnz_row is None:
        return reference(a, dense)
    ell = as_ell(a, max_nnz_row=max_nnz_row)
    rb = max(int((tiling or {}).get("row_block", 256)), 1)
    n_rows = ell.values.shape[0]
    # team loop over row blocks; a zero-row matrix is one empty block
    return torch.cat([
        reference(EllMatrix(ell.values[i0:i0 + rb], ell.indices[i0:i0 + rb],
                            ell.valid[i0:i0 + rb], min(rb, n_rows - i0),
                            ell.n_cols, ell.nnz_mean), dense)
        for i0 in range(0, max(n_rows, 1), rb)])


def spmv_loops(a, x, *, tiling=None, max_nnz_row=None):
    """Generated-loops SpMV (the paper's TeamPolicy row loop)."""
    from repro_torch.kernels.spmv import spmv_reference
    return _sparse_row_blocks(a, x, spmv_reference, tiling, max_nnz_row)


def spmm_loops(a, b, *, tiling=None, max_nnz_row=None):
    """Generated-loops SpMM (row-block loop, reference tile contraction)."""
    from repro_torch.kernels.spmv import spmm_reference
    return _sparse_row_blocks(a, b, spmm_reference, tiling, max_nnz_row)


register_backend(Backend(
    name="loops",
    description="eager-torch loop-nest interpreter (the paper's "
                "generated-Kokkos-loops path; reference/baseline)",
    capabilities=frozenset({"loop-nests", "reference", "sparse",
                            "ell-layout"}),
    hierarchy=SERIAL_HIERARCHY,
    fallbacks=("torch",),
    op_executor=loops_executor,
))

register_kernel("kk.gemm", "loops", gemm_loops)
register_kernel("kk.gemv", "loops", gemv_loops)
register_kernel("kk.batched_gemm", "loops", batched_gemm_loops)
register_kernel("kk.spmv", "loops", spmv_loops)
register_kernel("kk.spmm", "loops", spmm_loops)
# registered here, with the backend, rather than by kernels/paged_kv.py:
# a compile for `loops` must find them before any other backend's loader
# has imported that module
register_kernel("kokkos.page_gather", "loops", _pk.page_gather_loops)
register_kernel("kokkos.page_append", "loops", _pk.page_append_loops)
register_kernel("kokkos.page_copy", "loops", _pk.page_copy_loops)
