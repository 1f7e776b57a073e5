"""recurrentgemma (Griffin) recurrent block — the port of the reference's
``models/rglru_block.py``: x → [gelu(Wa x)] ⊙ [RG-LRU(conv1d(Wb x))] → Wo.
The local-attention blocks between them are ``models/attention.py``'s.

Decode state: the conv tail (width − 1 inputs, kept in f32 by the cache)
and the RG-LRU hidden h — O(1) per step.  Prefill and the decode step
both run the scan through ``kernels.ops.rglru`` (the hand kernel on the
card), which returns its final h; the reference's decode step and its
prefill's state call the plain scan.  The recurrence branch is
constrained where the reference constrains it
(``dist.sharding.constrain``: the identity without a mesh).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.dist.sharding import constrain, constrain_batch
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import activation
from repro_torch.models.spec import Spec


def recurrent_block_spec(cfg) -> dict:
    d, dr = cfg.d_model, cfg.rglru_dim
    w = cfg.conv_width
    return {
        "w_gate_branch": Spec((d, dr), ("embed", "ffn"), init="xavier"),
        "w_rec_branch": Spec((d, dr), ("embed", "ffn"), init="xavier"),
        "conv_w": Spec((w, dr), (None, "ffn"), init="normal:0.1"),
        "conv_b": Spec((dr,), ("ffn",), init="zeros"),
        "rg_r": Spec((dr, dr), ("ffn", None), init="xavier"),
        "rg_i": Spec((dr, dr), ("ffn", None), init="xavier"),
        "log_a": Spec((dr,), (None,), init="uniform_decay"),
        "w_out": Spec((dr, d), ("ffn", "embed"), init="xavier"),
    }


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   tail: Optional[torch.Tensor] = None) -> Tuple:
    """Depthwise causal conv over time.  x: (B, T, D); w: (W, D).
    ``tail``: (B, W-1, D) carried decode state, cast to x's dtype."""
    W = w.shape[0]
    if tail is None:
        xp = torch.nn.functional.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([tail.to(x.dtype), x], dim=1)
    T = x.shape[1]
    out = sum(xp[:, i:i + T] * w[i].to(x.dtype) for i in range(W))
    new_tail = xp[:, -(W - 1):] if W > 1 else None
    return out + b.to(x.dtype), new_tail


def apply_recurrent_block(p: dict, x: torch.Tensor, cfg, *,
                          state: Optional[dict] = None,
                          return_state: bool = False):
    """state = {"conv": (B, W-1, Dr), "h": (B, Dr)} for decode."""
    dt = x.dtype
    gate = activation("gelu")(x @ p["w_gate_branch"].to(dt))
    rec = x @ p["w_rec_branch"].to(dt)
    rec = constrain(rec, "batch", None, "ffn")
    conv_tail = state["conv"] if state is not None else None
    rec, new_tail = _causal_conv1d(rec, p["conv_w"], p["conv_b"], conv_tail)
    r_gate = rec @ p["rg_r"].to(dt)
    i_gate = rec @ p["rg_i"].to(dt)
    if state is not None and x.shape[1] == 1:
        y, new_h = kops.rglru(rec, r_gate, i_gate, p["log_a"],
                              state=state["h"])
    else:
        y, final = kops.rglru(rec, r_gate, i_gate, p["log_a"])
        new_h = final if return_state else None
    out = constrain_batch((gate * y) @ p["w_out"].to(dt))
    if return_state or state is not None:
        return out, {"conv": new_tail, "h": new_h}
    return out
