"""kk.batched_gemm on the card — the port of the reference's
``kernels/batched_gemm.py`` (paper §6.4, Fig 6.3).

C[..., M, N] = A[..., M, K] · B[..., K, N] over the leading batch dims,
f32 accumulation, output in A's dtype.  B (or A) broadcasts where it is
2-D or has fewer or size-1 batch dims; the kernels read a broadcast
operand through a batch stride of 0 instead of copying it per matrix.

The map_parallelism pass picks one of two kernels of
``csrc/batched_gemm.cu`` (``tiling["vectorize_batch"]``):

* :func:`batched_gemm_small` — ``m·n <= compute_unit²/4`` (1024 on the
  H100): a block owns at most ``batch_block`` whole matrices, as many as
  bring the grid to two blocks per SM (:func:`small_plan`), computes a
  few at once from a two-stage ``cp.async`` ring in shared memory, each
  thread a 4 × 4 register micro-tile (the reference's ``_small_kernel``);
* :func:`batched_gemm_tiled` — larger matrices: the products of
  ``kk.gemm`` (``csrc/gemm.cuh``: bf16 that TMA can address on ``wgmma``,
  the rest on FFMA, a launch count per route as :func:`matmul.matmul`
  has), the matrix on the grid (FFMA) or in the walked tile index
  (``wgmma``); a B shared by a packed batch of A folds into one product
  of batch · M rows (the reference's ``_tiled_kernel``).

The small library is compiled once per K chunk (``-DLAPIS_SMALL``/
``-DLAPIS_BK``), the tiled one once with every tile: its launch plan
(``matmul.gemm_plan``) picks the tile from the extents, and the IR's
(bm, bn, bk) is only checked, as for ``kk.gemm``.  A tiling the kernels
cannot run raises.  On CPU tensors the wrappers run the plain version
(``ref.batched_gemm``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import matmul as _mm

# the small kernel's launch plan (csrc/batched_gemm.cu, -DLAPIS_SMALL)
SMALL_TN = 4                # output columns a thread owns
SMALL_MAX_OUTPUTS = 2048    # m·n it takes
SMALL_TM4_THREADS = 256     # most threads a matrix at tm >= 4
SMALL_BLOCK_THREADS = 128   # threads a block aims for
SMALL_TARGET_BLOCKS = 2 * 132   # two blocks per H100 SM
_FNS = {(torch.float32, torch.float32): "lapis_batched_gemm_f32",
        (torch.bfloat16, torch.bfloat16): "lapis_batched_gemm_bf16",
        (torch.bfloat16, torch.float32): "lapis_batched_gemm_bf16_f32out"}
_LAUNCHERS: dict = {}   # ((small, bk), in dtype, out dtype) -> fn


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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _rup(a: int, b: int) -> int:
    return _cdiv(a, b) * b


def _small_tm(m: int, n: int) -> int:
    """Output rows a thread owns: 4, m below 3, and 8 only where 4 would
    need more than 256 threads a matrix (m > 1024 at n = 1)."""
    if m <= 2:
        return m
    return 4 if _cdiv(m, 4) * _cdiv(n, SMALL_TN) <= SMALL_TM4_THREADS \
        else 8


def _small_tile(m: int, n: int, bk: int, itemsize: int) -> int:
    """Shared memory one matrix's staged A and B chunks take: A's rows
    ``bk`` plus 16 bytes of padding, padded to whole micro-tile rows; B's
    ``bk`` rows padded to whole 16-byte pieces and micro-tile columns."""
    vec = 16 // itemsize
    ldb = _rup(_rup(n, SMALL_TN), vec)
    return itemsize * (_rup(m, _small_tm(m, n)) * (bk + vec) + bk * ldb)


def small_plan(m: int, n: int, k: int, batch: int, batch_block: int,
               itemsize: int, bk: int) -> dict:
    """The small kernel's launch for ``batch`` products m×k · k×n of
    ``itemsize``-byte inputs, built with chunk ``bk`` (the twin of
    ``small_plan`` in ``csrc/batched_gemm.cu``, held to it on the card):

    * ``tm`` × 4 outputs a thread (:func:`_small_tm`), so ``tpm``
      threads a matrix (at most 256 for ``tm`` >= 4, 512 otherwise);
    * ``per_block`` matrices a block: at most ``batch_block``, and no
      more than keeps the grid at two blocks per SM;
    * ``teams`` of them computed at once (a block of about 128 threads);
    * ``bk``: the K chunk of one stage, the library's at most (a multiple
      of 8), halved until two stages of one matrix fit shared memory;
    * ``stages``: two when a block has more than one (round, chunk)
      stage, so the next one's loads overlap this one's FMAs."""
    tm = _small_tm(m, n)
    tpm = _cdiv(m, tm) * _cdiv(n, SMALL_TN)
    chunk = max(8, min(_rup(max(bk, 8), 8), _rup(k, 8)))
    while chunk > 8 and 2 * _small_tile(m, n, chunk, itemsize) > \
            _mm.MAX_SMEM_BYTES:
        chunk = max(8, _rup(chunk // 2, 8))
    tile = _small_tile(m, n, chunk, itemsize)
    per_block = max(1, min(batch_block, batch // SMALL_TARGET_BLOCKS))
    teams = max(1, min(per_block, SMALL_BLOCK_THREADS // tpm))
    while teams > 1 and 2 * teams * tile > _mm.MAX_SMEM_BYTES:
        teams -= 1
    stages = 2 if _cdiv(per_block, teams) * max(1, _cdiv(k, chunk)) > 1 \
        else 1
    return {"tm": tm, "tpm": tpm, "teams": teams, "per_block": per_block,
            "grid": _cdiv(batch, per_block), "threads": teams * tpm,
            "bk": chunk, "stages": stages,
            "smem_bytes": stages * teams * tile}


def check_tiling(tiling: dict, m: int, n: int) -> tuple:
    """(small, bm, bn, bk, batch_block) the kernel runs for this tiling
    on m×n outputs, else ValueError.  The tiled kernel takes what
    ``kk.gemm``'s tile loop takes.  The small kernel is built to stage K
    in chunks of at most ``bk`` (the reference's small kernel holds whole
    matrices), halved until one matrix's f32 chunks fit a block's shared
    memory, and takes up to ``SMALL_MAX_OUTPUTS`` outputs a matrix (512
    threads of 4 × 1 micro-tiles at m = 1)."""
    if not _is_small(tiling, m, n):
        bm, bn, bk = _mm.check_tiling(tiling)
        return False, bm, bn, bk, 1
    bk = int(tiling["bk"])
    bb = int(tiling.get("batch_block") or 1)
    if bk < 1 or bb < 1 or m * n > SMALL_MAX_OUTPUTS:
        raise ValueError(
            f"small batched kernel cannot run bk={bk} batch_block={bb} on "
            f"{m}x{n} matrices: needs bk, batch_block >= 1 and m*n <= "
            f"{SMALL_MAX_OUTPUTS}")
    while bk > 1 and _small_tile(m, n, bk, 4) > _mm.MAX_SMEM_BYTES:
        bk //= 2
    return True, 0, 0, bk, bb


def batched_gemm_kernel(small: bool, bk: int = 0) -> _build.KernelSource:
    """The build record of ``csrc/batched_gemm.cu``: the small kernel at K
    chunk ``bk``, or the tiled products (every tile, no defines)."""
    defines = (("LAPIS_SMALL", 1), ("LAPIS_BK", bk)) if small else ()
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
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] + [ctypes.c_void_p])
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


def _plan(a3: torch.Tensor, b3: torch.Tensor, sa: int, sb: int, m: int,
          n: int, k: int, nb: int) -> dict:
    return _mm.gemm_plan(m, n, k, nb, a3.dtype, _mm.aligned(a3, b3, sa, sb),
                         fold=nb > 1 and sb == 0 and sa == m * k)


def plan_for(a: torch.Tensor, b: torch.Tensor) -> dict:
    """The plan :func:`batched_gemm_tiled` launches for these operands."""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    batch = tuple(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]))
    a3, sa = _batched(a, batch, m, k)
    b3, sb = _batched(b, batch, k, n)
    return _plan(a3, b3, sa, sb, m, n, k, math.prod(batch))


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
    is_small, _, _, bk, bb = check_tiling(tiling, m, n)
    if is_small != small:
        raise ValueError(f"batched_gemm: tiling {tiling} is for the "
                         f"{'small' if is_small else 'tiled'} kernel")
    fn = _launcher((small, bk if small else 0), a.dtype, out_dtype)
    c = torch.empty(batch + (m, n), dtype=out_dtype, device=a.device)
    if c.numel() == 0:
        return c
    a3, sa = _batched(a, batch, m, k)
    b3, sb = _batched(b, batch, k, n)
    plan, ws, ws_ptr, ws_bytes = None, None, None, 0
    if not small:
        plan = _plan(a3, b3, sa, sb, m, n, k, nb)
        ws, ws_ptr, ws_bytes = _mm.workspace(plan, a.device)
    _build.check(fn(a3.data_ptr(), b3.data_ptr(), c.data_ptr(), ws_ptr,
                    ws_bytes, nb, m, n, k, sa, sb, bb,
                    torch.cuda.current_stream(a.device).cuda_stream),
                 "batched_gemm")
    if small:
        wrapper.launches += 1
    else:
        _mm.count_launch(wrapper, plan)
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
batched_gemm_tiled.launches_wgmma = 0   # bf16 on the tensor cores
batched_gemm_tiled.launches_ffma = 0    # f32 and unaligned bf16
