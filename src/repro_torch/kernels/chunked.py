"""Memory-bounded chunked attention (online softmax in plain torch) — the
port of the reference's ``kernels/chunked.py``.

This is the **library-path** attention for long sequences: a loop over
(q-chunks × kv-chunks) carrying the flash-style running (max, sum, acc)
state, so the live memory is O(q_chunk × kv_chunk) per (batch, head)
instead of O(S²).  Chunk pairs wholly masked (above the causal diagonal,
or before the window) are skipped.  GQA is computed grouped: k / v are
never repeated per query head.  It is not a kernel: every step is a
torch op.

Two variants:

* :func:`chunked_attention` — plain; autograd keeps every chunk pair's
  softmax for the backward;
* :func:`flash_chunked_attention` — a ``torch.autograd.Function`` whose
  forward saves only (q, k, v, out, lse) and whose backward recomputes
  the probabilities chunk pair by chunk pair (the flash-attention
  backward), as the reference's ``custom_vjp`` does.

The reference runs both loops as ``lax.scan`` with ``lax.cond`` skips;
here they are Python loops whose skips are plain ``continue``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _live(qi: int, ki: int, qc: int, kc: int, causal: bool,
          window: Optional[int]) -> bool:
    """Does chunk pair (qi, ki) hold any unmasked (query, key)?"""
    live = True
    if causal:
        live &= ki * kc <= qi * qc + qc - 1
    if window is not None:
        live &= (ki + 1) * kc - 1 > qi * qc - window
    return live


def _chunk_mask(qi: int, ki: int, qc: int, kc: int, Skv: int, causal: bool,
                window: Optional[int], device) -> torch.Tensor:
    qpos = qi * qc + torch.arange(qc, device=device)[:, None]
    kpos = ki * kc + torch.arange(kc, device=device)[None, :]
    mask = (kpos < Skv).expand(qc, kc)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def _pad_to(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """x zero-padded along ``dim`` to ``n`` entries."""
    if x.shape[dim] == n:
        return x
    pad = [0, 0] * (x.ndim - 1 - dim) + [0, n - x.shape[dim]]
    return F.pad(x, pad)


def _chunks(Sq: int, Skv: int, q_chunk: int, kv_chunk: int):
    qc, kc = min(q_chunk, Sq), min(kv_chunk, Skv)
    return qc, kc, -(-Sq // qc), -(-Skv // kc)


def _grouped(x: torch.Tensor, Hkv: int, n: int) -> torch.Tensor:
    """(B, Hq, S, D) → (B, Hkv, rep, n, D) in f32, padded to n positions:
    query head h is group h // rep of KV head h // rep."""
    B, Hq, _, D = x.shape
    return _pad_to(x, n, 2).reshape(B, Hkv, Hq // Hkv, n, D).float()


def _forward(q, k, v, *, causal, window, scale, logit_softcap, qc, kc):
    """The online-softmax sweep → (out (B, Hq, Sq, D) in q's dtype, lse
    (B, Hkv, rep, Sq) f32)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    nq, nk = -(-Sq // qc), -(-Skv // kc)
    qg = _grouped(q, Hkv, nq * qc)
    kf = _pad_to(k, nk * kc, 2).float()                 # (B, Hkv, Skv', D)
    vf = _pad_to(v, nk * kc, 2).float()
    outs, lses = [], []
    for qi in range(nq):
        qf = qg[:, :, :, qi * qc:(qi + 1) * qc]        # (B, Hkv, rep, qc, D)
        m = torch.full((B, Hkv, rep, qc, 1), NEG_INF, device=q.device)
        l = torch.zeros((B, Hkv, rep, qc, 1), device=q.device)
        acc = torch.zeros((B, Hkv, rep, qc, D), device=q.device)
        for ki in range(nk):
            if not _live(qi, ki, qc, kc, causal, window):
                continue
            k_blk = kf[:, :, ki * kc:(ki + 1) * kc]
            v_blk = vf[:, :, ki * kc:(ki + 1) * kc]
            s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k_blk) * scale
            if logit_softcap:
                s = logit_softcap * torch.tanh(s / logit_softcap)
            mask = _chunk_mask(qi, ki, qc, kc, Skv, causal, window,
                               q.device)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p, v_blk)
            m = m_new
        safe = torch.where(l == 0.0, 1.0, l)
        outs.append((acc / safe).to(q.dtype))
        lses.append((m + torch.log(safe))[..., 0])
    out = torch.cat(outs, dim=3).reshape(B, Hq, nq * qc, D)
    return out[:, :, :Sq], torch.cat(lses, dim=3)[..., :Sq]


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      scale: Optional[float] = None,
                      logit_softcap: Optional[float] = None,
                      q_chunk: int = 1024, kv_chunk: int = 1024
                      ) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) → (B, Hq, Sq, D)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    qc, kc, _, _ = _chunks(q.shape[2], k.shape[2], q_chunk, kv_chunk)
    return _forward(q, k, v, causal=causal, window=window, scale=scale,
                    logit_softcap=logit_softcap, qc=qc, kc=kc)[0]


def _backward(q, k, v, out, lse, g, *, causal, window, scale,
              logit_softcap, qc, kc):
    """The flash backward: each live chunk pair's probabilities
    recomputed from the saved lse; dq accumulates over the kv chunks in
    order, dk / dv over the q chunks."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    nq, nk = -(-Sq // qc), -(-Skv // kc)
    qg, og, gg = (_grouped(t, Hkv, nq * qc) for t in (q, out, g))
    kf = _pad_to(k, nk * kc, 2).float()
    vf = _pad_to(v, nk * kc, 2).float()
    lse_g = _pad_to(lse, nq * qc, 3)                   # (B, Hkv, rep, Sq')
    dg = (og * gg).sum(dim=-1, keepdim=True)           # rowsum(dout ⊙ out)
    dq = torch.zeros_like(qg)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for ki in range(nk):
        ks = slice(ki * kc, (ki + 1) * kc)
        k_blk, v_blk = kf[:, :, ks], vf[:, :, ks]
        for qi in range(nq):
            if not _live(qi, ki, qc, kc, causal, window):
                continue
            qs = slice(qi * qc, (qi + 1) * qc)
            q_blk, g_blk = qg[:, :, :, qs], gg[:, :, :, qs]
            s = torch.einsum("bhgqd,bhkd->bhgqk", q_blk, k_blk) * scale
            if logit_softcap:
                t = torch.tanh(s / logit_softcap)
                s = logit_softcap * t
            mask = _chunk_mask(qi, ki, qc, kc, Skv, causal, window,
                               q.device)
            lse_blk = lse_g[:, :, :, qs]
            lse_safe = torch.where(torch.isfinite(lse_blk), lse_blk, 0.0)
            p = torch.where(mask, torch.exp(s - lse_safe[..., None]), 0.0)
            dv[:, :, ks] += torch.einsum("bhgqk,bhgqd->bhkd", p, g_blk)
            dp = torch.einsum("bhgqd,bhkd->bhgqk", g_blk, v_blk)
            ds = p * (dp - dg[:, :, :, qs]) * scale
            if logit_softcap:
                ds = ds * (1.0 - t * t)
            dq[:, :, :, qs] += torch.einsum("bhgqk,bhkd->bhgqd", ds, k_blk)
            dk[:, :, ks] += torch.einsum("bhgqk,bhgqd->bhkd", ds, q_blk)
    dq = dq.reshape(B, Hq, nq * qc, D)[:, :, :Sq].to(q.dtype)
    return dq, dk[:, :, :Skv].to(k.dtype), dv[:, :, :Skv].to(v.dtype)


class _FlashChunked(torch.autograd.Function):
    """Forward: the chunked sweep, saving (q, k, v, out, lse); backward:
    :func:`_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, static):
        out, lse = _forward(q, k, v, **static)
        ctx.static = static
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        return (*_backward(*ctx.saved_tensors, g, **ctx.static), None)


def flash_chunked_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: Optional[int] = None,
                            scale: Optional[float] = None,
                            logit_softcap: Optional[float] = None,
                            q_chunk: int = 1024, kv_chunk: int = 1024
                            ) -> torch.Tensor:
    """Chunked attention with O(S) saved state and the flash backward."""
    qc, kc, _, _ = _chunks(q.shape[2], k.shape[2], q_chunk, kv_chunk)
    static = {"causal": causal, "window": window,
              "scale": scale if scale is not None else q.shape[-1] ** -0.5,
              "logit_softcap": logit_softcap, "qc": qc, "kc": kc}
    return _FlashChunked.apply(q, k, v, static)
