"""Modality frontend stubs — the port of the reference's
``models/frontends.py``.  The ``[audio]`` and ``[vlm]`` configs model the
transformer backbone only: the caller gives precomputed frame or patch
embeddings.  These helpers give those inputs' shapes and, for tests,
the vision prefix's M-RoPE positions; they are not conv or ViT towers.

Where the reference returns ``jax.ShapeDtypeStruct``, the shape helpers
here return ``(shape, dtype)`` tuples.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

VISION_PATCHES = 256          # 16×16 patch grid prefix for qwen2-vl cells
AUDIO_FRAMES = 1500           # whisper: 30 s of 20 ms frames


def vision_embed_spec(cfg, batch: int) -> Tuple[tuple, torch.dtype]:
    return ((batch, VISION_PATCHES, cfg.d_model),
            getattr(torch, cfg.compute_dtype))


def vision_position_spec(batch: int) -> Tuple[tuple, torch.dtype]:
    return (3, batch, VISION_PATCHES), torch.int32


def make_vision_positions(batch: int) -> np.ndarray:
    """(t, h, w) M-RoPE streams for a 16×16 patch grid at t = 0:
    (3, batch, VISION_PATCHES) int32."""
    side = int(VISION_PATCHES ** 0.5)
    hh, ww = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    t = np.zeros(VISION_PATCHES, np.int32)
    pos = np.stack([t, hh.reshape(-1), ww.reshape(-1)]).astype(np.int32)
    return np.broadcast_to(pos[:, None, :], (3, batch, VISION_PATCHES))


def audio_frame_spec(cfg, batch: int) -> Tuple[tuple, torch.dtype]:
    return ((batch, min(AUDIO_FRAMES, cfg.encoder_seq), cfg.d_model),
            getattr(torch, cfg.compute_dtype))
