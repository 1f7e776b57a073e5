"""Plain torch versions of the kernels in this package (the reference's
``kernels/ref.py``, dense matmul and sparse parts): the CPU path of each
wrapper, the oracle the kernels are held against on the card, and the
library (``torch``) registry implementations.  Mixed operand dtypes
promote first, as ``jnp.matmul`` does (``torch.matmul`` refuses them)."""
from __future__ import annotations

import torch


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def gemv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return matmul(a, x)


# ---------------------------------------------------------------------------
# sparse
# ---------------------------------------------------------------------------

def _csr_row_ids(indptr: torch.Tensor, nnz: int, n_rows: int
                 ) -> torch.Tensor:
    """The row of every stored entry.  The reference scatters ones at
    ``indptr[1:-1]`` and takes a cumsum, relying on JAX dropping the
    out-of-range updates that trailing empty rows produce
    (``indptr[i] == nnz``); torch's scatters raise on those, so the rows
    are expanded from the row lengths instead."""
    lengths = (indptr[1:] - indptr[:-1]).to(torch.int64)
    return torch.repeat_interleave(
        torch.arange(n_rows, device=indptr.device), lengths,
        output_size=nnz)


def spmv_csr(indptr: torch.Tensor, indices: torch.Tensor,
             values: torch.Tensor, x: torch.Tensor, *,
             n_rows: int) -> torch.Tensor:
    """Segment-sum CSR SpMV (y = A @ x)."""
    dtype = torch.promote_types(values.dtype, x.dtype)
    if values.shape[0] == 0:
        return torch.zeros((n_rows,), dtype=dtype, device=x.device)
    rows = _csr_row_ids(indptr, values.shape[0], n_rows)
    prod = values.to(dtype) * x.to(dtype)[indices.to(torch.int64)]
    return torch.zeros((n_rows,), dtype=dtype,
                       device=x.device).index_add_(0, rows, prod)


def spmm_csr(indptr: torch.Tensor, indices: torch.Tensor,
             values: torch.Tensor, b: torch.Tensor, *,
             n_rows: int) -> torch.Tensor:
    """Segment-sum CSR SpMM (Y = A @ B, B dense (n_cols, n))."""
    dtype = torch.promote_types(values.dtype, b.dtype)
    out = torch.zeros((n_rows, b.shape[1]), dtype=dtype, device=b.device)
    if values.shape[0] == 0:
        return out
    rows = _csr_row_ids(indptr, values.shape[0], n_rows)
    prod = values.to(dtype)[:, None] * b.to(dtype)[indices.to(torch.int64)]
    return out.index_add_(0, rows, prod)
