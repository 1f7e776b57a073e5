"""Plain torch versions of the kernels in this package (the reference's
``kernels/ref.py``: dense matmul, sparse, attention and RMSNorm parts):
the CPU path of each wrapper, the oracle the kernels are held against on
the card, and the library (``torch``) registry implementations.  Mixed
operand dtypes promote first, as ``jnp.matmul`` does (``torch.matmul``
refuses them).  Attention and RMSNorm compute in f32 and return the
input's dtype, with ``-inf`` masks, as the reference does: a row with no
valid position is NaN here (the kernels return 0 there)."""
from __future__ import annotations

from typing import Optional

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


# ---------------------------------------------------------------------------
# attention (GQA, causal / sliding-window)
# ---------------------------------------------------------------------------

def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None,
              logit_softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D); GQA via head-group repeat.

    Rectangular (Sq != Skv) supported; ``window`` limits attention to the
    previous ``window`` positions; ``logit_softcap`` applies tanh capping."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if Hq != Hkv:
        rep = Hq // Hkv
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    scale = scale if scale is not None else D ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if logit_softcap:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    qi = torch.arange(Sq, device=q.device)[:, None]
    ki = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float())
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     window: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One-token attention against a KV cache.

    q: (B, Hq, D); caches: (B, Hkv, S, D); lengths: (B,) valid prefix."""
    B, Hq, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    rep = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Hkv, rep, D).float()
    logits = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache.float()) * scale
    pos = torch.arange(S, device=q.device)[None, None, None, :]
    lens = lengths.to(q.device)[:, None, None, None]
    valid = pos < lens
    if window is not None:
        valid &= pos >= (lens - window)
    logits = logits.masked_fill(~valid, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", probs, v_cache.float())
    return out.reshape(B, Hq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# fused RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)
