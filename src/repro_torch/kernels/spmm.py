"""CSR SpMM (Y = A @ B, B dense) on the card — the port of the
reference's ``kernels/spmm.py``, the multi-vector companion of SpMV.

:func:`spmm_sparse` launches ``csrc/spmm.cu``.  The TPU kernel contracted
a padded-ELL width axis against an (rows, width, n) copy of B's gathered
rows that XLA built outside it.  On Hopper the kernel reads CSR and
gathers B's rows inside: each thread block covers a (row block × column
block) tile of Y, threads run along Y's columns so the reads of a row
``B[col, :]`` coalesce, and each row loops over its entries with f32
accumulation.  The gathered copy of B is never built.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.spmv import (check_csr, check_tiling,
                                      default_tiling, spmm_reference)

MAX_COL_BLOCKS = 65535    # grid.y limit: B may have 65535 × 32 columns
_FNS = {torch.float32: "lapis_spmm_f32", torch.bfloat16: "lapis_spmm_bf16"}
_LAUNCHERS: dict = {}     # dtype -> ctypes function


def spmm_kernel() -> _build.KernelSource:
    """The build record of ``csrc/spmm.cu``."""
    return _build.KernelSource("spmm", _build.csrc("spmm.cu"))


def _launcher(dtype: torch.dtype):
    fn = _LAUNCHERS.get(dtype)
    if fn is None:
        fn = getattr(_build.load(spmm_kernel()), _FNS[dtype])
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCHERS[dtype] = fn
    return fn


def spmm_sparse(a, b: torch.Tensor, *, tiling: Optional[dict] = None
                ) -> torch.Tensor:
    """Y = A @ B for a composite sparse value ``a`` and B (n_cols, n).
    On CPU tensors the plain version (either layout); on the card the
    CSR kernel at the tiling's ``row_block``."""
    if _build.on_cpu([*a[:3], b], "spmm"):
        spmm_sparse.plain_calls += 1
        return spmm_reference(a, b)
    check_csr(a, b, "spmm")
    n = b.shape[1] if b.ndim == 2 else -1
    if n < 0 or -(-n // 32) > MAX_COL_BLOCKS:
        raise ValueError(f"spmm: B must be (n_cols, n) with n at most "
                         f"{MAX_COL_BLOCKS * 32}, not {tuple(b.shape)}")
    y = torch.empty((a.n_rows, n), dtype=b.dtype, device=b.device)
    if y.numel() == 0:
        return y
    row_block, _ = check_tiling(
        tiling or default_tiling(a.n_rows, a.values.shape[0]))
    fn = _launcher(b.dtype)
    indptr, indices, values, b = (t.contiguous() for t in
                                  (a.indptr, a.indices, a.values, b))
    _build.check(fn(indptr.data_ptr(), indices.data_ptr(),
                    values.data_ptr(), b.data_ptr(), y.data_ptr(),
                    a.n_rows, n, row_block,
                    torch.cuda.current_stream(b.device).cuda_stream),
                 "spmm")
    spmm_sparse.launches += 1
    return y


spmm_sparse.launches = 0
spmm_sparse.plain_calls = 0
