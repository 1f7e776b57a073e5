"""kk.gemm on the card — the port of the reference's ``kernels/matmul.py``
(the tiled MXU matmul, the "pure Kokkos lowering" of paper §6.4).

:func:`matmul` launches ``csrc/matmul.cu``, which routes each product by
its launch plan (:func:`gemm_plan`, the twin of ``gemm_plan`` in
``csrc/gemm.cuh``), with a launch count per route beside the total:

* **wgmma** (``launches_wgmma``) — bf16 operands TMA can address (16-byte
  aligned bases and batch strides, K and N multiples of 8):
  ``csrc/gemm_sm90.cuh``, 128 × 128 tiles on the tensor cores fed by a
  four-stage TMA ring, f32 accumulators, one block an SM walking the
  tiles;
* **FFMA** (``launches_ffma``) — f32 (held to 1e-5 in full f32, which
  rules out TF32) and the bf16 products TMA cannot address (K = 91,
  N = 201, a base off alignment, ``kk.gemv``'s one column):
  ``csrc/gemm_tile.cuh``, 8 × 8 register micro-tiles behind a
  three-stage ``cp.async`` ring.

Where the output tiles fill at most a quarter of the card and K is long
(ResNet18's fc), the plan splits K: the wrapper allocates an f32
workspace for the partial products, which a second kernel sums in a
fixed order.  Ragged edges are masked in the kernels.

The IR's ``tiling`` (the map_parallelism pass's (bm, bn, bk) over the
H100 hierarchy) no longer instantiates the kernel: one library holds
every tile, and the plan picks the one that runs from the extents and
the card's 132 SMs.  :func:`check_tiling` still refuses the tilings the
old tile loop could not run, so the pass's contract is unchanged.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

MICRO_TILE = 8                 # TM = TN of the FFMA micro-tile
MAX_THREADS = 1024
MAX_SMEM_BYTES = 232_448       # sm_90 opt-in shared memory per block
SMS = 132                      # H100 SXM
MAX_GRID_Z = 65_535
SPLIT_MIN_K = 256              # K at least this deep to split
# the wgmma route's launch (csrc/gemm_sm90.cuh)
WGMMA_TILE = (128, 128, 64)    # bm, bn, bk
WGMMA_THREADS, WGMMA_STAGES = 384, 4
WGMMA_SMEM_BYTES = 1024 + 4 * 32768 + 2 * 64 * (128 * 4 + 16) + 8 * 2 * 4
# the FFMA route's tiles and their weight (eighths) per output
# (csrc/gemm.cuh), its K step and ring depth (csrc/gemm_tile.cuh)
FFMA_TILES = ((128, 128, 8), (128, 64, 9), (64, 64, 10))
FFMA_BK, FFMA_STAGES = 16, 3
# a balancing split on FFMA: ranges at least this deep, at most this many,
# and the reduce's cost in the plan's unit (per f32 word, and its launch)
BALANCE_MIN_K, BALANCE_MAX_SPLIT = 1024, 4
REDUCE_PER_WORD, REDUCE_LAUNCH = 2, 6_000_000
_FNS = {(torch.float32, torch.float32): "lapis_matmul_f32",
        (torch.bfloat16, torch.bfloat16): "lapis_matmul_bf16",
        (torch.bfloat16, torch.float32): "lapis_matmul_bf16_f32out"}
_LAUNCHERS: dict = {}          # (in dtype, out dtype) -> fn


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gemm_plan(m: int, n: int, k: int, batch: int, dtype: torch.dtype,
              aligned: bool, fold: bool = False) -> dict:
    """The launch of ``batch`` products m×k · k×n of ``dtype`` inputs, as
    ``gemm_plan`` in ``csrc/gemm.cuh`` computes it (held to it on the
    card).  ``aligned``: both bases 16-byte aligned and both batch strides
    multiples of 16 bytes; ``fold``: B is shared by the batch and A's
    matrices are packed, so the batch folds into the rows.

    * ``route``: ``"wgmma"`` for aligned bf16 with K and N multiples of 8
      (K > 0), else ``"ffma"``;
    * ``bm``, ``bn``, ``bk``, ``threads``, ``stages``: the route's tile —
      on FFMA, with the split, the one whose busiest SM has the least
      weighted work;
    * ``m``, ``batch``: the rows and matrices after the fold;
    * ``split``, ``k_chunk``: K ranges of whole K steps — on FFMA two to
      four ranges at least ``BALANCE_MIN_K`` deep where that evens out
      the SMs' work by more than the reduce costs; on either route, where
      the tiles fill at most a quarter of the SMs and K is at least
      ``SPLIT_MIN_K`` deep, about two blocks an SM;
    * ``tiles``: (M tiles, N tiles, batch · split);
    * ``grid``: on wgmma one block an SM (at most one a tile) walking the
      tiles; on FFMA the tiles, batch · split capped at 65,535;
    * ``smem_bytes``; ``workspace_bytes``: the f32 partial products a
      split launch needs (0 otherwise)."""
    return dict(_plan(m, n, k, batch, dtype.itemsize, bool(aligned),
                      bool(fold)))


@functools.lru_cache(maxsize=4096)
def _plan(m, n, k, batch, itemsize, aligned, fold) -> tuple:
    fold = fold and batch > 1 and m * batch < 2 ** 31
    m_eff, b_eff = (m * batch, 1) if fold else (m, batch)
    wgmma = itemsize == 2 and aligned and k > 0 and k % 8 == 0 and n % 8 == 0
    if wgmma:
        bm, bn, bk = WGMMA_TILE
        threads, stages, smem = WGMMA_THREADS, WGMMA_STAGES, WGMMA_SMEM_BYTES
    else:
        bm, bn, split = _ffma_tile(m_eff, n, k, b_eff)
        bk, threads, stages = FFMA_BK, bm * bn // 64, FFMA_STAGES
        smem = stages * (bk * (bm + 4) + bk * bn) * 4
    gx, gy = _cdiv(m_eff, bm), _cdiv(n, bn)
    tiles = gx * gy * b_eff
    if wgmma:
        split = 1
    if 4 * tiles <= SMS and k >= SPLIT_MIN_K:
        split = min(_cdiv(2 * SMS, tiles), _cdiv(k, 2 * bk))
    k_chunk = _cdiv(_cdiv(k, split), bk) * bk or bk
    split = _cdiv(k, k_chunk) if k > 0 else 1
    grid = ((min(tiles * split, SMS), 1, 1) if wgmma
            else (gx, gy, min(b_eff * split, MAX_GRID_Z)))
    return (("route", "wgmma" if wgmma else "ffma"), ("bm", bm), ("bn", bn),
            ("bk", bk), ("threads", threads), ("stages", stages),
            ("m", m_eff), ("batch", b_eff), ("split", split),
            ("k_chunk", k_chunk), ("tiles", (gx, gy, b_eff * split)),
            ("grid", grid), ("smem_bytes", smem),
            ("workspace_bytes",
             4 * split * b_eff * m_eff * n if split > 1 else 0))


def _ffma_tile(m: int, n: int, k: int, batch: int) -> tuple:
    """(bm, bn, split) of the FFMA route: the tile and the balancing split
    whose busiest SM has the least weighted multiply-adds, the reduce's
    traffic and launch priced in the same unit."""
    best = None
    for bm, bn, w in FFMA_TILES:
        tiles = _cdiv(m, bm) * _cdiv(n, bn) * batch
        for s in range(1, BALANCE_MAX_SPLIT + 1):
            if s > 1 and _cdiv(k, s) < BALANCE_MIN_K:
                break
            kc = _cdiv(_cdiv(k, s), FFMA_BK) * FFMA_BK if k > 0 else FFMA_BK
            if k > 0 and _cdiv(k, kc) != s:
                continue
            cost = _cdiv(tiles * s, SMS) * bm * bn * kc * w
            if s > 1:
                cost += REDUCE_PER_WORD * (2 * s + 1) * batch * m * n \
                    + REDUCE_LAUNCH
            if best is None or cost < best[0]:
                best = (cost, bm, bn, s)
    return best[1:]


def aligned(a: torch.Tensor, b: torch.Tensor, sa: int = 0,
            sb: int = 0) -> bool:
    """The plan's ``aligned``: both bases 16-byte aligned and both batch
    strides (elements) multiples of 16 bytes."""
    item = a.element_size()
    return (a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
            and sa * item % 16 == 0 and sb * item % 16 == 0)


def plan_for(a: torch.Tensor, b: torch.Tensor) -> dict:
    """The plan :func:`matmul` launches for these operands."""
    a, b = a.contiguous(), b.contiguous()
    return gemm_plan(a.shape[0], b.shape[1], a.shape[1], 1, a.dtype,
                     aligned(a, b))


def workspace(plan: dict, device) -> tuple:
    """(tensor, pointer, bytes) of the plan's split-K workspace: an f32
    buffer from ``torch.empty``, or nothing where K is not split."""
    if not plan["workspace_bytes"]:
        return None, None, 0
    ws = torch.empty(plan["workspace_bytes"] // 4, dtype=torch.float32,
                     device=device)
    return ws, ws.data_ptr(), plan["workspace_bytes"]


def count_launch(wrapper, plan: dict) -> None:
    """One launch of ``wrapper``'s kernel, on the route the plan names."""
    wrapper.launches += 1
    if plan["route"] == "wgmma":
        wrapper.launches_wgmma += 1
    else:
        wrapper.launches_ffma += 1


def check_tiling(tiling: dict) -> tuple:
    """(bm, bn, bk) of an IR tiling the kernels accept, else ValueError:
    whole 8 × 8 micro-tiles, at most 1024 threads, and staged tiles within
    the 227 KiB of shared memory a block may use.  The tile that runs is
    the plan's (:func:`gemm_plan`); this keeps the pass's contract."""
    bm, bn, bk = (int(tiling[x]) for x in ("bm", "bn", "bk"))
    threads = (bm // MICRO_TILE) * (bn // MICRO_TILE)
    smem = 4 * (bm * (bk + 1) + bk * bn)
    if bm % MICRO_TILE or bn % MICRO_TILE or bk < 1 or \
            not 1 <= threads <= MAX_THREADS or smem > MAX_SMEM_BYTES:
        raise ValueError(f"matmul kernel cannot run tiling bm={bm} bn={bn} "
                         f"bk={bk}: needs bm, bn multiples of {MICRO_TILE}, "
                         f"at most {MAX_THREADS} threads ({threads}) and "
                         f"{MAX_SMEM_BYTES} B of shared memory ({smem})")
    return bm, bn, bk


def matmul_kernel() -> _build.KernelSource:
    """The build record of ``csrc/matmul.cu`` (every tile of both
    routes)."""
    return _build.KernelSource("matmul", _build.csrc("matmul.cu"))


def _launcher(in_dtype, out_dtype):
    key = (in_dtype, out_dtype)
    fn = _LAUNCHERS.get(key)
    if fn is None:
        name = _FNS.get(key)
        if name is None:
            raise TypeError(f"matmul kernel takes float32 → float32, "
                            f"bfloat16 → bfloat16 or bfloat16 → float32, "
                            f"not {in_dtype} → {out_dtype}")
        fn = getattr(_build.load(matmul_kernel()), name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + \
            [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCHERS[key] = fn
    return fn


def matmul(a: torch.Tensor, b: torch.Tensor, *, tiling: Optional[dict] = None,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C[M,N] = A[M,K] @ B[K,N] with f32 accumulation; output in
    ``out_dtype`` (default: the inputs' dtype).  ``tiling``, where given,
    is checked (:func:`check_tiling`); the plan picks the tile."""
    out_dtype = out_dtype or a.dtype
    if _build.on_cpu([a, b], "matmul"):
        matmul.plain_calls += 1
        return ref.matmul(a, b).to(out_dtype)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise TypeError(f"matmul: operand dtypes differ ({a.dtype}, "
                        f"{b.dtype})")
    m, k = a.shape
    n = b.shape[1]
    if max(m, n, k) >= 2**31:
        raise ValueError("matmul: extents must fit 32-bit ints")
    if tiling is not None:
        check_tiling(tiling)
    fn = _launcher(a.dtype, out_dtype)
    a, b = a.contiguous(), b.contiguous()
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return c
    plan = plan_for(a, b)
    ws, ws_ptr, ws_bytes = workspace(plan, a.device)
    _build.check(fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), ws_ptr,
                    ws_bytes, m, n, k,
                    torch.cuda.current_stream(a.device).cuda_stream),
                 "matmul")
    count_launch(matmul, plan)
    return c


matmul.launches = 0          # both routes
matmul.launches_wgmma = 0    # bf16 on the tensor cores: csrc/gemm_sm90.cuh
matmul.launches_ffma = 0     # f32 and unaligned bf16: csrc/gemm_tile.cuh
matmul.plain_calls = 0
