"""Rotary position embeddings: standard RoPE and qwen2-vl M-RoPE — the
port of the reference's ``models/rope.py``.

M-RoPE splits the rotary half-dims into (temporal, height, width)
sections, each rotated by its own position stream.  For text-only input
all three streams carry the same position.
"""
from __future__ import annotations

from typing import Tuple

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    # x: (..., head_dim); pairs are (first half, second half)
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, head_dim: int,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D) or (B, H, D); positions: (B, S) or (B,)."""
    freqs = rope_freqs(head_dim, theta, x.device)            # (half,)
    ang = positions[..., None].float() * freqs               # (B,S,half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.ndim == 4:                                          # (B,S,H,D)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    else:                                                    # (B,H,D)
        cos, sin = cos[:, None, :], sin[:, None, :]
    return _rotate(x.float(), cos, sin).to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, *, head_dim: int,
                theta: float, sections: Tuple[int, ...]) -> torch.Tensor:
    """qwen2-vl M-RoPE.  positions3: (3, B, S) or (3, B); sections sum to
    head_dim//2 (scaled if head_dim != 128)."""
    half = head_dim // 2
    scale = half / sum(sections)
    sec = [int(s * scale) for s in sections]
    sec[-1] = half - sum(sec[:-1])
    freqs = rope_freqs(head_dim, theta, x.device)            # (half,)
    sec_ids = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.tensor(sec, device=x.device), output_size=half)  # (half,)
    pos = positions3.float()                                 # (3,B,S)|(3,B)
    pos_per_freq = pos[sec_ids]                              # (half,B,S)|(half,B)
    if pos.ndim == 3:
        ang = pos_per_freq.permute(1, 2, 0) * freqs          # (B,S,half)
        cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    else:
        ang = pos_per_freq.permute(1, 0) * freqs             # (B,half)
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    return _rotate(x.float(), cos, sin).to(x.dtype)
