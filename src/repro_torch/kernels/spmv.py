"""CSR SpMV on the card — the port of the reference's ``kernels/spmv.py``
(the paper's flagship sparse kernel, §6.2).

The runtime composite values a sparse-encoded IR value holds
(:class:`CsrMatrix` from ``sparse.pack``, :class:`EllMatrix` from
``sparse.convert`` on ell-layout backends), the layout conversion, and
the plain versions of SpMV and SpMM on either layout live here.

:func:`spmv` launches ``csrc/spmv.cu``.  The TPU kernel read padded ELL
because a TPU has no warps, with ``x[cols]`` gathered by XLA outside it.
On Hopper the kernel is the paper's own GPU form: it reads CSR directly,
row-parallel groups of lanes each running a vector loop over one row's
entries (16-byte loads of the columns and values, marked evict-first in
L1, all issued before the ``x[col]`` gathers, which are marked
evict-last in L2), reducing with warp shuffles.
:func:`spmv_plan` is its launch plan, the twin of ``plan`` in the source.
The ``cuda`` backend therefore declares no ``ell-layout``: ELL would add
a conversion to every call and read up to 13× the CSR bytes (width 192
against a mean of 14.34 on StocF-1465).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.core.ir import ell_storage_width
from repro_torch.kernels import _build, ref

MAX_ROW_WIDTH = 32        # entries of a row per iteration (the tiling)
MAX_THREADS = 256         # most threads a block
VEC = 4                   # entries a 16-byte load of the columns holds
PLAN_FIELDS = ("vec", "lanes", "unroll", "groups", "threads", "grid")
_FNS = {torch.float32: "lapis_spmv_f32", torch.bfloat16: "lapis_spmv_bf16"}
_LAUNCHERS: dict = {}     # dtype -> ctypes function


class CsrMatrix(NamedTuple):
    """Runtime composite CSR value (what a sparse-encoded IR value holds
    between ``sparse.pack`` and the consuming kernel)."""
    indptr: torch.Tensor     # (n_rows + 1,)
    indices: torch.Tensor    # (nnz,) column ids
    values: torch.Tensor     # (nnz,)
    n_rows: int
    n_cols: int


class EllMatrix(NamedTuple):
    """Padded ELL form of a CSR matrix (built once, reusable)."""
    values: torch.Tensor     # (n_rows, width)
    indices: torch.Tensor    # (n_rows, width) column ids (0 where padded)
    valid: torch.Tensor      # (n_rows, width) bool
    n_rows: int
    n_cols: int
    nnz_mean: float


def csr_to_ell(indptr, indices, values, n_rows: int, n_cols: int,
               pad_to: int = 8, max_nnz_row: Optional[int] = None
               ) -> EllMatrix:
    """Layout conversion (vectorized, no loop over rows).  The width is
    ``max_nnz_row`` padded to ``pad_to`` (paper Table 6.1 carries the
    statistic per matrix); without it the width comes from the data."""
    indptr, indices, values = (torch.as_tensor(t)
                               for t in (indptr, indices, values))
    dev = values.device
    if n_rows == 0:
        # indptr is the single sentinel 0: return a well-formed
        # all-padding ELL instead of windows of an undefined width
        width = ell_storage_width(max_nnz_row, pad_to)
        return EllMatrix(torch.zeros((0, width), dtype=values.dtype,
                                     device=dev),
                         torch.zeros((0, width), dtype=torch.int32,
                                     device=dev),
                         torch.zeros((0, width), dtype=torch.bool,
                                     device=dev), 0, n_cols, 0.0)
    row_len = indptr[1:] - indptr[:-1]
    if max_nnz_row is None:
        max_nnz_row = int(row_len.max())
    width = ell_storage_width(max_nnz_row, pad_to)
    offs = torch.arange(width, device=dev)[None, :]
    valid = offs < row_len[:, None]
    nnz = values.shape[0]
    if nnz == 0:                          # empty matrix: all-padding ELL
        return EllMatrix(torch.zeros((n_rows, width), dtype=values.dtype,
                                     device=dev),
                         torch.zeros((n_rows, width), dtype=torch.int32,
                                     device=dev),
                         valid, n_rows, n_cols, 0.0)
    idx = (indptr[:-1, None].to(torch.int64) + offs).clamp(0, nnz - 1)
    vals_ell = torch.where(valid, values[idx], 0).to(values.dtype)
    cols_ell = torch.where(valid, indices[idx], 0).to(torch.int32)
    return EllMatrix(vals_ell, cols_ell, valid, n_rows, n_cols,
                     float(nnz) / max(n_rows, 1))


def as_ell(a, max_nnz_row: Optional[int] = None) -> EllMatrix:
    """Composite sparse value → ELL layout (identity if already ELL)."""
    if isinstance(a, EllMatrix):
        return a
    return csr_to_ell(a.indptr, a.indices, a.values, a.n_rows, a.n_cols,
                      max_nnz_row=max_nnz_row)


def spmv_reference(a, x: torch.Tensor) -> torch.Tensor:
    """Library-semantics SpMV on either layout of the composite value —
    the one plain version behind the ``torch`` kernel-table entry, the
    emitter's reference semantics and the kernel's CPU path."""
    if isinstance(a, EllMatrix):
        x_g = torch.where(a.valid, x[a.indices.to(torch.int64)], 0.0)
        return torch.sum(a.values * x_g, dim=1).to(x.dtype)
    return ref.spmv_csr(a.indptr, a.indices, a.values, x, n_rows=a.n_rows)


def spmm_reference(a, b: torch.Tensor) -> torch.Tensor:
    """Library-semantics SpMM on either layout of the composite value."""
    if isinstance(a, EllMatrix):
        b_g = torch.where(a.valid[:, :, None],
                          b[a.indices.to(torch.int64)], 0.0)
        return torch.sum(a.values[:, :, None] * b_g, dim=1).to(b.dtype)
    return ref.spmm_csr(a.indptr, a.indices, a.values, b, n_rows=a.n_rows)


# ---------------------------------------------------------------------------
# the hand kernel
# ---------------------------------------------------------------------------

def default_tiling(n_rows: int, nnz: int) -> dict:
    """The tiling the sparsify pass would choose on the H100 hierarchy
    (used where the caller passes none)."""
    from repro_torch.core.backend import H100_HIERARCHY
    from repro_torch.core.passes import choose_spmv_tiling
    return choose_spmv_tiling(n_rows, nnz / max(n_rows, 1), H100_HIERARCHY)


def check_tiling(tiling: dict) -> tuple:
    """(row_block, row_width) if ``csrc/spmv.cu`` and ``csrc/spmm.cu`` can
    run this tiling, else ValueError.  Any row block runs (a block loops
    over its rows when they outnumber its thread rows); a row's lanes
    must fit one warp."""
    row_block, row_width = int(tiling["row_block"]), int(tiling["row_width"])
    if row_block < 1 or not 1 <= row_width <= MAX_ROW_WIDTH:
        raise ValueError(f"sparse kernels cannot run tiling row_block="
                         f"{row_block} row_width={row_width}: needs "
                         f"row_block >= 1 and 1 <= row_width <= "
                         f"{MAX_ROW_WIDTH}")
    return row_block, row_width


def check_csr(a, dense: torch.Tensor, what: str) -> None:
    """Raise on a composite value the CSR kernels do not take."""
    if not isinstance(a, CsrMatrix):
        raise TypeError(f"{what}: the kernel reads CSR, not "
                        f"{type(a).__name__} (the cuda pipeline never "
                        "converts to ELL)")
    if a.indptr.dtype != torch.int32 or a.indices.dtype != torch.int32:
        raise TypeError(f"{what}: indptr and indices must be int32, not "
                        f"{a.indptr.dtype} and {a.indices.dtype}")
    if a.values.dtype != dense.dtype or dense.dtype not in _FNS:
        raise TypeError(f"{what}: values and dense operand must share "
                        f"float32 or bfloat16, not {a.values.dtype} and "
                        f"{dense.dtype}")
    if tuple(a.indptr.shape) != (a.n_rows + 1,) or \
            a.indices.shape != a.values.shape or a.values.ndim != 1 or \
            dense.shape[0] != a.n_cols or a.n_rows >= 2**31:
        raise ValueError(f"{what}: CSR of {a.n_rows} rows with indptr "
                         f"{tuple(a.indptr.shape)}, indices "
                         f"{tuple(a.indices.shape)}, values "
                         f"{tuple(a.values.shape)} against a dense "
                         f"operand of {tuple(dense.shape)}")


def spmv_plan(n_rows: int, row_block: int, row_width: int,
              aligned: bool = True) -> dict:
    """The launch of ``csrc/spmv.cu`` at a tiling — the twin of ``plan``
    in the source.  ``row_width`` entries of a row an iteration become
    ``lanes`` (a power of two, one warp at most) x ``vec`` entries (4 when
    the columns and values are 16-byte loads, 1 on an unaligned base);
    a row_width of the warp's 32 (rows of 25+ entries on average) walks
    twice that: 16 lanes of 4 entries;
    each lane issues ``unroll`` vectors' loads before its gathers.  A
    block of ``threads`` (at most 256) holds ``groups`` rows at a time and
    loops over its ``row_block`` rows; ``grid`` blocks cover the rows."""
    vec = VEC if aligned else 1
    # a row as wide as the warp walks 2 x row_width an iteration
    per_lane = -(-((2 if row_width >= MAX_ROW_WIDTH else 1) * row_width)
                 // vec)
    lanes = 1
    while lanes < per_lane and lanes < MAX_ROW_WIDTH:
        lanes *= 2
    threads = -(-min(row_block * lanes, MAX_THREADS) // 32) * 32
    return dict(vec=vec, lanes=lanes, unroll=2 if vec > 1 else 4,
                groups=threads // lanes, threads=threads,
                grid=-(-n_rows // row_block))


def c_plan(n_rows: int, row_block: int, row_width: int,
           aligned: bool = True) -> dict:
    """The plan the library's exported ``lapis_spmv_plan`` computes, in
    :func:`spmv_plan`'s form (builds the library)."""
    fn = _build.load(spmv_kernel()).lapis_spmv_plan
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(PLAN_FIELDS))()
    rc = fn(n_rows, row_block, row_width, int(aligned), out)
    if rc != 0:
        raise ValueError(f"lapis_spmv_plan({n_rows}, {row_block}, "
                         f"{row_width}): error {rc}")
    return dict(zip(PLAN_FIELDS, out))


def spmv_kernel() -> _build.KernelSource:
    """The build record of ``csrc/spmv.cu``."""
    return _build.KernelSource("spmv", _build.csrc("spmv.cu"))


def _launcher(dtype: torch.dtype):
    fn = _LAUNCHERS.get(dtype)
    if fn is None:
        fn = getattr(_build.load(spmv_kernel()), _FNS[dtype])
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + \
            [ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCHERS[dtype] = fn
    return fn


def spmv(a, x: torch.Tensor, *, tiling: Optional[dict] = None
         ) -> torch.Tensor:
    """y = A @ x for a composite sparse value ``a``.  On CPU tensors the
    plain version (either layout); on the card the CSR kernel at
    ``tiling`` (the sparsify pass's ``row_block`` / ``row_width``)."""
    if _build.on_cpu([*a[:3], x], "spmv"):
        spmv.plain_calls += 1
        return spmv_reference(a, x)
    check_csr(a, x, "spmv")
    if x.ndim != 1:
        raise ValueError(f"spmv: x must be a vector, not {tuple(x.shape)}")
    y = torch.empty((a.n_rows,), dtype=x.dtype, device=x.device)
    if a.n_rows == 0:
        return y
    row_block, row_width = check_tiling(
        tiling or default_tiling(a.n_rows, a.values.shape[0]))
    fn = _launcher(x.dtype)
    indptr, indices, values, x = (t.contiguous() for t in
                                  (a.indptr, a.indices, a.values, x))
    _build.check(fn(indptr.data_ptr(), indices.data_ptr(),
                    values.data_ptr(), x.data_ptr(), y.data_ptr(),
                    a.n_rows, row_block, row_width, values.shape[0],
                    torch.cuda.current_stream(x.device).cuda_stream),
                 "spmv")
    spmv.launches += 1
    return y


spmv.launches = 0
spmv.plain_calls = 0


def spmv_csr(indptr, indices, values, x, *, n_rows: int,
             tiling: Optional[dict] = None) -> torch.Tensor:
    """Loose-array entry point: pack the CSR operands and run
    :func:`spmv`."""
    return spmv(CsrMatrix(indptr, indices, values, n_rows, int(x.shape[0])),
                x, tiling=tiling)
