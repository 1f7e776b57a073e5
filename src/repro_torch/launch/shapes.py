"""The assigned input-shape cells and their abstract input specs — the
port of the reference's ``launch/shapes.py``.

Every (arch × shape) pair maps to a step function and a dict of
meta-device tensors (zero allocation: the port's ``ShapeDtypeStruct``;
the dry-run places them on a mesh and counts the step on them)."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models import frontends

SHAPES = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1},
}


def cell_supported(cfg, shape_name: str) -> Tuple[bool, str]:
    """The reference's skip rules (a sub-quadratic arch alone takes the
    524288-token decode)."""
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, ("full quadratic attention at 524288-token decode — "
                       "skipped per assignment (sub-quadratic archs only)")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def cell_dims(shape_name: str, reduced: bool = False) -> Tuple[int, int]:
    """The cell's (batch, sequence); ``reduced``: the reference's CPU cut
    (batch / 64, at least 2; sequence at most 64)."""
    info = SHAPES[shape_name]
    B, S = info["batch"], info["seq"]
    if reduced:
        B, S = max(B // 64, 2), min(S, 64)
    return B, S


def batch_specs(cfg, shape_name: str, *, reduced: bool = False) -> dict:
    """Training / prefill batch as meta tensors."""
    B, S = cell_dims(shape_name, reduced)
    specs = {"tokens": _meta((B, S), torch.int32)}
    if SHAPES[shape_name]["kind"] == "train":
        specs["labels"] = _meta((B, S), torch.int32)
    if cfg.frontend == "audio":
        specs["audio_frames"] = _meta(*frontends.audio_frame_spec(cfg, B))
    if cfg.frontend == "vision":
        specs["vision_embeds"] = _meta(*frontends.vision_embed_spec(cfg, B))
        specs["vision_positions"] = _meta(
            *frontends.vision_position_spec(B))
    return specs


def decode_specs(cfg, shape_name: str, *, quantized_kv: bool = False,
                 reduced: bool = False) -> dict:
    """(token, cache, length) specs for the decode step; the cache is
    ``init_cache`` on the meta device.  ``length`` is a 0-d int32 meta
    tensor, as the reference's scalar spec; the port's decode step takes
    the position as a Python int."""
    from repro_torch.models import serve as serve_mod
    B, S = cell_dims(shape_name, reduced)
    cache = serve_mod.init_cache(cfg, B, S, quantized=quantized_kv,
                                 device="meta")
    return {"token": _meta((B,), torch.int32),
            "cache": cache,
            "length": _meta((), torch.int32)}
