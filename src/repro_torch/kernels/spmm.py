"""CSR SpMM (Y = A @ B, B dense) on the card — the port of the
reference's ``kernels/spmm.py``, the multi-vector companion of SpMV.

:func:`spmm_sparse` launches ``csrc/spmm.cu``.  The TPU kernel contracted
a padded-ELL width axis against an (rows, width, n) copy of B's gathered
rows that XLA built outside it.  On Hopper the kernel reads CSR and
gathers B's rows inside: a warp owns a row, a B row segment is read by a
group of lanes with 16-byte loads, and the warp's groups each take a
different entry (dealt from one coalesced read of the row's columns and
values by shuffles), so many B-row gathers are in flight at once; the
groups' sums meet in a fixed shuffle tree, so two calls give the same
bits.  :func:`spmm_plan` is its launch plan, the twin of ``plan`` in the
source.  The gathered copy of B is never built.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.spmv import (check_csr, check_tiling,
                                      default_tiling, spmm_reference)

MAX_COL_BLOCKS = 65535    # grid.y limit: B may have 65535 × 32 columns
MAX_WARPS = 4             # a block: at most 4 warps, a row each at a time
PLAN_FIELDS = ("vec", "lanes", "groups", "cols", "unroll", "threads",
               "grid_rows", "grid_cols")
_FNS = {torch.float32: "lapis_spmm_f32", torch.bfloat16: "lapis_spmm_bf16"}
_LAUNCHERS: dict = {}     # dtype -> ctypes function


def spmm_plan(n_rows: int, n: int, row_block: int, itemsize: int,
              aligned: bool = True) -> dict:
    """The launch of ``csrc/spmm.cu`` — the twin of ``plan`` in the
    source.  A lane reads ``vec`` columns of a B row by one load (16
    bytes; 1 where ``n`` is off a multiple of the vector or a base of B,
    Y, the columns or the values is off 16 bytes: not ``aligned``), a
    group of ``lanes`` (a power of two, one warp at most) covers ``cols``
    columns, and the warp's ``groups`` groups take different entries,
    each lane issuing ``unroll`` steps' gathers (4 entries a step on the
    vector path, 1 on the scalar) before it accumulates.  A block of
    ``threads`` (min(row_block, 4) warps) walks its ``row_block`` rows a
    warp a row; ``grid_rows`` x ``grid_cols`` blocks cover Y."""
    v16 = 16 // itemsize
    vec = v16 if aligned and n % v16 == 0 else 1
    lanes = 1
    while lanes < -(-n // vec) and lanes < 32:
        lanes *= 2
    cols = lanes * vec
    return dict(vec=vec, lanes=lanes, groups=32 // lanes, cols=cols,
                unroll=1 if vec > 1 else 8,
                threads=min(row_block, MAX_WARPS) * 32,
                grid_rows=-(-n_rows // row_block), grid_cols=-(-n // cols))


def c_plan(n_rows: int, n: int, row_block: int, itemsize: int,
           aligned: bool = True) -> dict:
    """The plan the library's exported ``lapis_spmm_plan`` computes, in
    :func:`spmm_plan`'s form (builds the library)."""
    fn = _build.load(spmm_kernel()).lapis_spmm_plan
    fn.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(PLAN_FIELDS))()
    rc = fn(n_rows, n, row_block, itemsize, int(aligned), out)
    if rc != 0:
        raise ValueError(f"lapis_spmm_plan({n_rows}, {n}, {row_block}, "
                         f"{itemsize}): error {rc}")
    return dict(zip(PLAN_FIELDS, out))


def spmm_kernel() -> _build.KernelSource:
    """The build record of ``csrc/spmm.cu``."""
    return _build.KernelSource("spmm", _build.csrc("spmm.cu"))


def _launcher(dtype: torch.dtype):
    fn = _LAUNCHERS.get(dtype)
    if fn is None:
        fn = getattr(_build.load(spmm_kernel()), _FNS[dtype])
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + \
            [ctypes.c_longlong, ctypes.c_void_p]
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
                    a.n_rows, n, row_block, values.shape[0],
                    torch.cuda.current_stream(b.device).cuda_stream),
                 "spmm")
    spmm_sparse.launches += 1
    return y


spmm_sparse.launches = 0
spmm_sparse.plain_calls = 0
