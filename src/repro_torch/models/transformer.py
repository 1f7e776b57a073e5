"""Model assembly — the port of the reference's ``models/transformer.py``:
dense GQA decoders (qwen2 and its relatives), RWKV6 and the hybrid
Griffin family (recurrentgemma); MoE and encoder-decoder arrive with
their slices.

Layer parameters are stacked along a leading layers dim, as in the
reference's tree (the hybrid's per pattern group, ``groups`` and the
remainder group ``rem``); the serving paths walk the stack with a
Python loop where the reference scans.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import rglru_block as rg_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.layers import (apply_embed, apply_unembed,
                                       layernorm_spec, norm_spec)
from repro_torch.models.spec import Spec, stack


def dense_layer_spec(cfg) -> dict:
    norm = norm_spec if cfg.norm == "rmsnorm" else layernorm_spec
    return {"ln1": norm(cfg.d_model),
            "attn": attn.attention_spec(cfg),
            "ln2": norm(cfg.d_model),
            "mlp": mlp_mod.gated_mlp_spec(cfg.d_model, cfg.d_ff)}


def rwkv_layer_spec(cfg) -> dict:
    return {"ln1": norm_spec(cfg.d_model),
            "time_mix": rwkv_mod.time_mix_spec(cfg),
            "ln2": norm_spec(cfg.d_model),
            "channel_mix": rwkv_mod.channel_mix_spec(cfg)}


def hybrid_entry_spec(cfg, kind: str) -> dict:
    temporal = (rg_mod.recurrent_block_spec(cfg) if kind == "R"
                else attn.attention_spec(cfg))
    return {"ln1": norm_spec(cfg.d_model),
            "temporal": temporal,
            "ln2": norm_spec(cfg.d_model),
            "mlp": mlp_mod.gated_mlp_spec(cfg.d_model, cfg.d_ff)}


def hybrid_group_spec(cfg, pattern) -> dict:
    return {f"b{i}_{kind}": hybrid_entry_spec(cfg, kind)
            for i, kind in enumerate(pattern)}


FAMILIES = ("dense", "rwkv", "hybrid")     # the families ported so far


def model_spec(cfg) -> dict:
    """Full parameter spec tree for one architecture (the ``FAMILIES``)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the port models the {'/'.join(FAMILIES)} families so far, "
            f"not {cfg.family}")
    s: Dict[str, Any] = {
        "embed": {"table": Spec((cfg.padded_vocab, cfg.d_model),
                                ("vocab", "embed"), init="normal")},
        "final_norm": (norm_spec if cfg.norm == "rmsnorm"
                       else layernorm_spec)(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        s["head"] = Spec((cfg.d_model, cfg.padded_vocab),
                         ("embed", "vocab"), init="normal")
    if cfg.family == "dense":
        s["layers"] = stack(dense_layer_spec(cfg), cfg.n_layers)
    elif cfg.family == "rwkv":
        s["layers"] = stack(rwkv_layer_spec(cfg), cfg.n_layers)
    else:
        plen = len(cfg.pattern)
        n_groups, rem = divmod(cfg.n_layers, plen)
        s["groups"] = stack(hybrid_group_spec(cfg, cfg.pattern), n_groups)
        if rem:
            s["rem"] = stack(hybrid_group_spec(cfg, cfg.pattern[:rem]), 1)
    return s


def take(tree, i: int):
    """Entry ``i`` of a tree stacked along its leading dim: a view of
    every leaf."""
    if isinstance(tree, dict):
        return {k: take(v, i) for k, v in tree.items()}
    return tree[i]


def layer_params(params: dict, i: int, key: str = "layers") -> dict:
    """Layer (or, with ``key="groups"`` / ``"rem"``, pattern group)
    ``i``'s parameters: a view of every stacked leaf."""
    return take(params[key], i)


def stack_trees(trees: list):
    """The inverse of :func:`take`: one tree whose leaves stack the
    trees' leaves along a new leading dim."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


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
