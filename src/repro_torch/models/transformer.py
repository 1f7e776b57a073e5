"""Model assembly — the port of the reference's ``models/transformer.py``,
dense GQA decoders (qwen2 and its relatives) only; the other families
arrive with their slices.

Layer parameters are stacked along a leading layers dim, as in the
reference's tree; the serving paths walk the stack with a Python loop
where the reference scans.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.layers import (apply_embed, apply_unembed,
                                       layernorm_spec, norm_spec)
from repro_torch.models.spec import Spec, stack


def dense_layer_spec(cfg) -> dict:
    norm = norm_spec if cfg.norm == "rmsnorm" else layernorm_spec
    return {"ln1": norm(cfg.d_model),
            "attn": attn.attention_spec(cfg),
            "ln2": norm(cfg.d_model),
            "mlp": mlp_mod.gated_mlp_spec(cfg.d_model, cfg.d_ff)}


def model_spec(cfg) -> dict:
    """Full parameter spec tree for one architecture (dense family)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the port models the dense family so far, not {cfg.family}")
    s: Dict[str, Any] = {
        "embed": {"table": Spec((cfg.padded_vocab, cfg.d_model),
                                ("vocab", "embed"), init="normal")},
        "final_norm": (norm_spec if cfg.norm == "rmsnorm"
                       else layernorm_spec)(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        s["head"] = Spec((cfg.d_model, cfg.padded_vocab),
                         ("embed", "vocab"), init="normal")
    s["layers"] = stack(dense_layer_spec(cfg), cfg.n_layers)
    return s


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s parameters: a view of every stacked leaf."""
    def take(tree):
        if isinstance(tree, dict):
            return {k: take(v) for k, v in tree.items()}
        return tree[i]
    return take(params["layers"])


def _positions_for(cfg, B: int, S: int, batch: dict, device):
    pos = torch.arange(S, dtype=torch.int32, device=device)[None, :] \
        .repeat(B, 1)
    if not cfg.mrope:
        return pos
    # M-RoPE: text positions by default; a vision stub supplies real
    # (t, h, w) streams for the patch prefix when present
    pos3 = pos[None].expand(3, B, S)
    if "vision_positions" in batch:
        vp = batch["vision_positions"]           # (3, B, Np)
        Np = vp.shape[-1]
        pos3 = torch.cat([vp.to(pos3), pos3[:, :, Np:]], dim=2)
    return pos3


def _embed_input(params, batch, cfg):
    x = apply_embed(params["embed"], batch["tokens"], cfg)
    if cfg.frontend == "vision" and "vision_embeds" in batch:
        ve = batch["vision_embeds"].to(x.dtype)  # (B, Np, D)
        x = torch.cat([ve, x[:, ve.shape[1]:]], dim=1)
    return x


def _lm_head(params, x, cfg):
    if cfg.tie_embeddings:
        return apply_unembed(params["embed"], x)
    return x @ params["head"].to(x.dtype)
