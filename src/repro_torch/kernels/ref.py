"""Plain torch versions of the kernels in this package (the reference's
``kernels/ref.py``: dense and batched matmul, sparse, attention, RMSNorm
and the RWKV6 and RG-LRU scans):
the CPU path of each wrapper, the oracle the kernels are held against on
the card, and the library (``torch``) registry implementations.  Mixed
operand dtypes promote first, as ``jnp.matmul`` does (``torch.matmul``
refuses them).  Attention and RMSNorm compute in f32 and return the
input's dtype, with ``-inf`` masks, as the reference does: a row with no
valid position is NaN here (the kernels return 0 there)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.dist.sharding import reshape


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def gemv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return matmul(a, x)


def batched_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[..., M, N] = A[..., M, K] · B[..., K, N] over A's leading batch
    dims, B broadcast where it is 2-D or has fewer or size-1 batch dims;
    f32 accumulation, output in A's dtype, as the reference's Pallas
    kernel computes it."""
    acc = torch.promote_types(torch.promote_types(a.dtype, b.dtype),
                              torch.float32)
    return torch.matmul(a.to(acc), b.to(acc)).to(a.dtype)


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
                     scale: Optional[float] = None,
                     logit_softcap: Optional[float] = None) -> torch.Tensor:
    """One-token attention against a KV cache.

    q: (B, Hq, D); caches: (B, Hkv, S, D); lengths: (B,) valid prefix;
    ``logit_softcap`` caps the scaled scores as :func:`attention` does."""
    B, Hq, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    rep = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qg = reshape(q, B, Hkv, rep, D).float()
    logits = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache.float()) * scale
    if logit_softcap:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
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


# ---------------------------------------------------------------------------
# RWKV6 (Finch): the data-dependent decay WKV scan
# ---------------------------------------------------------------------------

def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               state: Optional[torch.Tensor] = None) -> tuple:
    """WKV6 recurrence, one time step at a time in f32.

    r, k, w: (B, T, H, K); v: (B, T, H, V); u: (H, K);
    state: (B, H, K, V) or None (zeros).
    Returns (y: (B, T, H, V) in v's dtype, final state (B, H, K, V) f32).

      y_t  = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
      S_t  = diag(w_t) S_{t-1} + k_t v_tᵀ
    """
    B, T, H, K = r.shape
    V = v.shape[-1]
    s = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    ys = []
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]      # (B,H,K,V)
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], s + uf * kv))
        s = wf[:, t, :, :, None] * s + kv
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros((B, 0, H, V), dtype=torch.float32, device=r.device))
    return y.to(v.dtype), s


# ---------------------------------------------------------------------------
# RG-LRU (recurrentgemma / Griffin)
# ---------------------------------------------------------------------------

RGLRU_C = 8.0


def rglru_scan(x: torch.Tensor, r_gate: torch.Tensor, i_gate: torch.Tensor,
               log_a_param: torch.Tensor,
               state: Optional[torch.Tensor] = None) -> tuple:
    """Real-Gated Linear Recurrent Unit, one time step at a time in f32.

    x, r_gate, i_gate: (B, T, D) (gates are raw pre-sigmoid);
    log_a_param: (D,) (Λ, pre-softplus); state: (B, D) or None (zeros).
    Returns (h: (B, T, D) in x's dtype, final h (B, D) f32).

      a_t = exp(-c · softplus(Λ) · σ(r_t))
      h_t = a_t ⊙ h_{t-1} + sqrt(max(1 − a_t², 1e-12)) ⊙ (σ(i_t) ⊙ x_t)
    """
    B, T, D = x.shape
    h = (torch.zeros((B, D), dtype=torch.float32, device=x.device)
         if state is None else state.float())
    xf, rf, itf = x.float(), r_gate.float(), i_gate.float()
    log_a = -RGLRU_C * torch.nn.functional.softplus(log_a_param.float())
    # every step's coefficients at once (elementwise, so each entry is
    # the value a step-by-step evaluation gives); the loop carries h
    la_r = log_a * torch.sigmoid(rf)
    # sqrt(1 - a²) computed stably: a² = exp(2 log a σ(r))
    scale = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * la_r), min=1e-12))
    a = torch.exp(la_r)
    b = scale * (torch.sigmoid(itf) * xf)
    hs = []
    for t in range(T):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    y = (torch.stack(hs, dim=1) if hs else
         torch.zeros((B, 0, D), dtype=torch.float32, device=x.device))
    return y.to(x.dtype), h
