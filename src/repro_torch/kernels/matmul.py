"""kk.gemm on the card — the port of the reference's ``kernels/matmul.py``
(the tiled MXU matmul, the "pure Kokkos lowering" of paper §6.4).

:func:`matmul` launches ``csrc/matmul.cu``: a shared-memory tiled FFMA
kernel (the tile loop of ``csrc/gemm_tile.cuh``, which the tiled batched
product shares) with an 8×8 register micro-tile per thread, f32
accumulation, ragged edges masked in the kernel.  The block shape (bm, bn, bk) is the
``tiling`` the map_parallelism pass chose over the H100 hierarchy; the
library is compiled once per tiling (``-DLAPIS_BM/BN/BK``), and a tiling
the kernel cannot run raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

MICRO_TILE = 8                 # TM = TN in csrc/gemm_tile.cuh
MAX_THREADS = 1024
MAX_SMEM_BYTES = 232_448       # sm_90 opt-in shared memory per block
_FNS = {(torch.float32, torch.float32): "lapis_matmul_f32",
        (torch.bfloat16, torch.bfloat16): "lapis_matmul_bf16",
        (torch.bfloat16, torch.float32): "lapis_matmul_bf16_f32out"}
_LAUNCHERS: dict = {}          # (bm, bn, bk, in dtype, out dtype) -> fn


def default_tiling(m: int, n: int, k: int, itemsize: int) -> dict:
    """The tiling map_parallelism would choose for this gemm on the H100
    hierarchy (used where the IR carries none, e.g. kk.gemv)."""
    from repro_torch.core.backend import H100_HIERARCHY
    from repro_torch.core.passes import choose_matmul_blocks
    return choose_matmul_blocks(m, n, k, itemsize, H100_HIERARCHY)


def check_tiling(tiling: dict) -> tuple:
    """(bm, bn, bk) if ``csrc/gemm_tile.cuh`` can run this tiling, else
    ValueError: whole micro-tiles, at most 1024 threads, and staged tiles
    within the 227 KiB of shared memory a block may use."""
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


def matmul_kernel(bm: int, bn: int, bk: int) -> _build.KernelSource:
    """The build record of ``csrc/matmul.cu`` at one tiling."""
    return _build.KernelSource(
        "matmul", _build.csrc("matmul.cu"),
        (("LAPIS_BM", bm), ("LAPIS_BN", bn), ("LAPIS_BK", bk)))


def _launcher(bm, bn, bk, in_dtype, out_dtype):
    key = (bm, bn, bk, in_dtype, out_dtype)
    fn = _LAUNCHERS.get(key)
    if fn is None:
        name = _FNS.get((in_dtype, out_dtype))
        if name is None:
            raise TypeError(f"matmul kernel takes float32 → float32, "
                            f"bfloat16 → bfloat16 or bfloat16 → float32, "
                            f"not {in_dtype} → {out_dtype}")
        fn = getattr(_build.load(matmul_kernel(bm, bn, bk)), name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCHERS[key] = fn
    return fn


def matmul(a: torch.Tensor, b: torch.Tensor, *, tiling: Optional[dict] = None,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C[M,N] = A[M,K] @ B[K,N] with f32 accumulation; output in
    ``out_dtype`` (default: the inputs' dtype)."""
    out_dtype = out_dtype or a.dtype
    devices = {a.device.type, b.device.type}
    if devices == {"cpu"}:
        matmul.plain_calls += 1
        return ref.matmul(a, b).to(out_dtype)
    if devices != {"cuda"}:
        raise ValueError(f"matmul: operands on {sorted(devices)}; the "
                         "kernel takes CUDA tensors, the plain version CPU "
                         "ones")
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
    tiling = tiling or default_tiling(m, n, k, a.element_size())
    bm, bn, bk = check_tiling(tiling)
    if -(-m // bm) > 65535:
        raise ValueError(f"matmul: {m} rows need more than 65535 row "
                         f"blocks of {bm}")
    fn = _launcher(bm, bn, bk, a.dtype, out_dtype)
    a, b = a.contiguous(), b.contiguous()
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return c
    _build.check(fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                    torch.cuda.current_stream(a.device).cuda_stream),
                 "matmul")
    matmul.launches += 1
    return c


matmul.launches = 0
matmul.plain_calls = 0
