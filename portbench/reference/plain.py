"""Plain PyTorch layers for the references, in float32 with TF32 off,
and the same layers with every matrix product's operands rounded to fp8
(the controls: the precision below bf16, the step that would tempt a
later change).

Imports nothing of the port: ``torch`` and the standard library only.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def no_tf32() -> None:
    """float32 products in float32: TF32 rounds them to 10 mantissa
    bits on this card unless switched off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(t: torch.Tensor, fmt=torch.float8_e4m3fn,
              top: float = E4M3_MAX) -> torch.Tensor:
    """``t`` (float32) rounded to fp8 with one scale for the tensor (its
    largest magnitude at the format's largest value), back in float32."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(fmt).to(torch.float32) * scale


class _Fp8Matmul(torch.autograd.Function):
    """a @ b with both operands in e4m3; the backward's incoming
    gradient in e5m2, as fp8 training recipes keep them."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8_round(g, torch.float8_e5m2, E5M2_MAX)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def mm(a: torch.Tensor, b: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """A product in float32, or (``fp8``) of fp8-rounded operands."""
    a, b = a.float(), b.float()
    return _Fp8Matmul.apply(a, b) if fp8 else a @ b


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (S, H, D); the rotation pairs dim i with dim i + D/2."""
    half = x.shape[-1] // 2
    freqs = theta ** -(torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos.float()[:, None] * freqs                       # (S, half)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(q, k, v, softcap=None, fp8: bool = False):
    """Causal GQA over one sequence: q (S, Hq, D), k / v (S, Hkv, D)."""
    S, Hq, D = q.shape
    rep = Hq // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = mm(q.transpose(0, 1), k.permute(1, 2, 0), fp8) / math.sqrt(D)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    return mm(p, v.transpose(0, 1), fp8).transpose(0, 1)      # (S, Hq, D)


def silu(x):
    return F.silu(x)


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


ACTS = {"silu": silu, "gelu": gelu_tanh}
