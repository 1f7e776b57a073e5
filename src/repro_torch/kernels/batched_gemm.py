"""kk.batched_gemm on the card — the port of the reference's
``kernels/batched_gemm.py`` (paper §6.4, Fig 6.3).

C[..., M, N] = A[..., M, K] · B[..., K, N] over the leading batch dims,
f32 accumulation, output in A's dtype.  B (or A) broadcasts where it is
2-D or has fewer or size-1 batch dims; the kernels read a broadcast
operand through a batch stride of 0 instead of copying it per matrix.

The map_parallelism pass picks one of two kernels of
``csrc/batched_gemm.cu`` (``tiling["vectorize_batch"]``):

* :func:`batched_gemm_small` — ``m·n <= compute_unit²/4`` (1024 on the
  H100): a block owns ``batch_block`` whole matrices and contracts them
  from shared memory in groups that fit (the reference's
  ``_small_kernel``);
* :func:`batched_gemm_tiled` — larger matrices: the (bm, bn, bk) tile
  loop of ``kk.gemm`` with the matrix on the grid's third axis (the
  reference's ``_tiled_kernel``).

Each library is compiled once per tiling (``-DLAPIS_SMALL``/``-DLAPIS_BK``
or ``-DLAPIS_BM/BN/BK``); a tiling the kernel cannot run raises.  On CPU
tensors the wrappers run the plain version (``ref.batched_gemm``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import matmul as _mm

SMALL_THREADS = 256     # threads of a small-kernel block (batched_gemm.cu)
SMALL_OUT = 8           # outputs each of them accumulates
_FNS = {(torch.float32, torch.float32): "lapis_batched_gemm_f32",
        (torch.bfloat16, torch.bfloat16): "lapis_batched_gemm_bf16",
        (torch.bfloat16, torch.float32): "lapis_batched_gemm_bf16_f32out"}
_LAUNCHERS: dict = {}   # ((small, bm, bn, bk), in dtype, out dtype) -> fn


def _is_small(tiling: dict, m: int, n: int) -> bool:
    """The tiling's kernel: the pass always states it; an eager tiling
    without ``vectorize_batch`` takes the H100 hierarchy's rule."""
    v = tiling.get("vectorize_batch")
    if v is None:
        from repro_torch.core.backend import H100_HIERARCHY
        return m * n <= H100_HIERARCHY.compute_unit ** 2 // 4
    return bool(v)


def default_tiling(a_shape, b_shape, itemsize: int) -> dict:
    """The tiling map_parallelism chooses for ``kk.batched_gemm`` on the
    H100 hierarchy (its heuristic candidate), for eager calls that carry
    none."""
    from repro_torch.core.backend import H100_HIERARCHY as hier
    from repro_torch.core.passes import choose_matmul_blocks
    *batch, m, k = a_shape
    n = b_shape[-1]
    small = m * n <= hier.compute_unit ** 2 // 4
    batch_block = (min(math.prod(batch), hier.team_width * 4)
                   if small else 1)
    return dict(choose_matmul_blocks(m, n, k, itemsize, hier),
                batch_block=batch_block, vectorize_batch=small)


def _small_bytes(m: int, n: int, bk: int) -> int:
    """Shared memory one matrix's staged A and B chunks take."""
    return 4 * (m * (bk + 1) + bk * n)


def check_tiling(tiling: dict, m: int, n: int) -> tuple:
    """(small, bm, bn, bk, batch_block) the kernel runs for this tiling
    on m×n outputs, else ValueError.  The tiled kernel takes what
    ``kk.gemm``'s tile loop takes.  The small kernel stages K in chunks
    of ``bk`` (the reference's small kernel holds whole matrices), halved
    until one matrix's chunks fit a block's shared memory, and needs one
    matrix's outputs within its threads' registers."""
    if not _is_small(tiling, m, n):
        bm, bn, bk = _mm.check_tiling(tiling)
        return False, bm, bn, bk, 1
    bk = int(tiling["bk"])
    bb = int(tiling.get("batch_block") or 1)
    if bk < 1 or bb < 1 or m * n > SMALL_THREADS * SMALL_OUT:
        raise ValueError(
            f"small batched kernel cannot run bk={bk} batch_block={bb} on "
            f"{m}x{n} matrices: needs bk, batch_block >= 1 and m*n <= "
            f"{SMALL_THREADS * SMALL_OUT}")
    while bk > 1 and _small_bytes(m, n, bk) > _mm.MAX_SMEM_BYTES:
        bk //= 2
    return True, 0, 0, bk, bb


def batched_gemm_kernel(small: bool, bm: int, bn: int,
                        bk: int) -> _build.KernelSource:
    """The build record of ``csrc/batched_gemm.cu`` for one kernel at one
    tiling."""
    defines = ((("LAPIS_SMALL", 1), ("LAPIS_BK", bk)) if small else
               (("LAPIS_BM", bm), ("LAPIS_BN", bn), ("LAPIS_BK", bk)))
    return _build.KernelSource("batched_gemm", _build.csrc("batched_gemm.cu"),
                               defines)


def _launcher(key: tuple, in_dtype, out_dtype):
    """The ctypes entry of the library ``batched_gemm_kernel(*key)``;
    the record is made (its source read and hashed) only on first use."""
    fn = _LAUNCHERS.get((key, in_dtype, out_dtype))
    if fn is None:
        name = _FNS.get((in_dtype, out_dtype))
        if name is None:
            raise TypeError(f"batched gemm kernel takes float32 → float32, "
                            f"bfloat16 → bfloat16 or bfloat16 → float32, "
                            f"not {in_dtype} → {out_dtype}")
        fn = getattr(_build.load(batched_gemm_kernel(*key)), name)
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LAUNCHERS[(key, in_dtype, out_dtype)] = fn
    return fn


def _batched(x: torch.Tensor, batch: tuple, rows: int, cols: int) -> tuple:
    """(x as (B, rows, cols) with contiguous rows, its batch stride): a
    view where the batch dims collapse to one stride (0 for a broadcast
    operand), a copy only where they do not or a matrix is not
    row-major."""
    x3 = x.expand(*batch, rows, cols).reshape(-1, rows, cols)
    if (cols > 1 and x3.stride(2) != 1) or (rows > 1 and x3.stride(1) != cols):
        x3 = x3.contiguous()
    return x3, (x3.stride(0) if x3.shape[0] > 1 else 0)


def _run(wrapper, small: bool, a: torch.Tensor, b: torch.Tensor,
         tiling: dict, out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    out_dtype = out_dtype or a.dtype
    if _build.on_cpu([a, b], "batched_gemm"):
        wrapper.plain_calls += 1
        return ref.batched_gemm(a, b).to(out_dtype)
    if a.ndim < 2 or b.ndim < 2 or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"batched_gemm: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise TypeError(f"batched_gemm: operand dtypes differ ({a.dtype}, "
                        f"{b.dtype})")
    m, k = a.shape[-2:]
    n = b.shape[-1]
    batch = tuple(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]))
    nb = math.prod(batch)
    if max(m, n, k, nb) >= 2**31:
        raise ValueError("batched_gemm: extents must fit 32-bit ints")
    is_small, bm, bn, bk, bb = check_tiling(tiling, m, n)
    if is_small != small:
        raise ValueError(f"batched_gemm: tiling {tiling} is for the "
                         f"{'small' if is_small else 'tiled'} kernel")
    fn = _launcher((small, bm, bn, bk), a.dtype, out_dtype)
    c = torch.empty(batch + (m, n), dtype=out_dtype, device=a.device)
    if c.numel() == 0:
        return c
    group = 0
    if small:
        group = min(bb, nb, SMALL_THREADS * SMALL_OUT // (m * n),
                    _mm.MAX_SMEM_BYTES // _small_bytes(m, n, bk))
    elif -(-m // bm) > 65535:
        raise ValueError(f"batched_gemm: {m} rows need more than 65535 row "
                         f"blocks of {bm}")
    a3, sa = _batched(a, batch, m, k)
    b3, sb = _batched(b, batch, k, n)
    _build.check(fn(a3.data_ptr(), b3.data_ptr(), c.data_ptr(), nb, m, n, k,
                    sa, sb, bb, group,
                    torch.cuda.current_stream(a.device).cuda_stream),
                 "batched_gemm")
    wrapper.launches += 1
    return c


def batched_gemm_small(a: torch.Tensor, b: torch.Tensor, *, tiling: dict,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """The small-matrix kernel (the reference's ``_small_kernel``)."""
    return _run(batched_gemm_small, True, a, b, tiling, out_dtype)


def batched_gemm_tiled(a: torch.Tensor, b: torch.Tensor, *, tiling: dict,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """The tiled kernel (the reference's ``_tiled_kernel``)."""
    return _run(batched_gemm_tiled, False, a, b, tiling, out_dtype)


def batched_gemm(a: torch.Tensor, b: torch.Tensor, *,
                 tiling: Optional[dict] = None,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C = A·B over the batch with the kernel ``tiling`` names (default:
    the pass's choice for these shapes)."""
    tiling = tiling or default_tiling(a.shape, b.shape, a.element_size())
    m, n = a.shape[-2], b.shape[-1]
    kernel = (batched_gemm_small if _is_small(tiling, m, n)
              else batched_gemm_tiled)
    return kernel(a, b, tiling=tiling, out_dtype=out_dtype)


for _w in (batched_gemm_small, batched_gemm_tiled):
    _w.launches = 0
    _w.plain_calls = 0
