"""Model assembly — the port of the reference's ``models/transformer.py``:
dense GQA decoders (qwen2 and its relatives, qwen2-vl with its vision
prefix), MoE decoders (grok-1, arctic), RWKV6, the hybrid Griffin
family (recurrentgemma) and the encoder-decoder (whisper, its audio
frames given).

Layer parameters are stacked along a leading layers dim, as in the
reference's tree (the hybrid's per pattern group, ``groups`` and the
remainder group ``rem``).  Where the reference scans the stack with
``jax.lax.scan``, the port walks it with a Python loop: the serving paths
take one layer's views (:func:`layer_params`), training unbinds each
stacked leaf once (:func:`unstack`), so every layer's gradient flows
back into the stacked leaf through one stack in the backward.  Each
layer body may run under ``torch.utils.checkpoint`` with the reference's
remat policies (:func:`_remat_policy`).  The residual stream, the
embedded input and the logits are constrained at the reference's places
(``dist.sharding.constrain``: the identity without a mesh).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.dist.sharding import constrain, reshape
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru_block as rg_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.layers import (apply_embed, apply_norm,
                                       apply_unembed, cdt, layernorm_spec,
                                       norm_spec)
from repro_torch.models.spec import Spec, stack


def _decoder_norms(cfg) -> dict:
    """A decoder layer's norms: before attention (``ln1``) and before
    the feed-forward half (``ln2``), and with ``cfg.post_norms`` after
    each too (``ln1_post``, ``ln2_post``)."""
    norm = norm_spec if cfg.norm == "rmsnorm" else layernorm_spec
    names = ("ln1", "ln2") + (("ln1_post", "ln2_post") if cfg.post_norms
                              else ())
    return {n: norm(cfg.d_model) for n in names}


def dense_layer_spec(cfg) -> dict:
    return {**_decoder_norms(cfg), "attn": attn.attention_spec(cfg),
            "mlp": mlp_mod.gated_mlp_spec(cfg.d_model, cfg.d_ff)}


def moe_layer_spec(cfg) -> dict:
    return {**_decoder_norms(cfg), "attn": attn.attention_spec(cfg),
            "moe": moe_mod.moe_spec(cfg)}


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


def encoder_layer_spec(cfg) -> dict:
    return {"ln1": layernorm_spec(cfg.d_model),
            "attn": attn.attention_spec(cfg),
            "ln2": layernorm_spec(cfg.d_model),
            "mlp": mlp_mod.mlp_spec(cfg.d_model, cfg.d_ff)}


def decoder_layer_spec(cfg) -> dict:
    return {"ln1": layernorm_spec(cfg.d_model),
            "self_attn": attn.attention_spec(cfg),
            "ln_cross": layernorm_spec(cfg.d_model),
            "cross_attn": attn.attention_spec(cfg),
            "ln2": layernorm_spec(cfg.d_model),
            "mlp": mlp_mod.mlp_spec(cfg.d_model, cfg.d_ff)}


FAMILIES = ("dense", "moe", "rwkv", "hybrid", "encdec")


def model_spec(cfg) -> dict:
    """Full parameter spec tree for one architecture."""
    s: Dict[str, Any] = {
        "embed": {"table": Spec((cfg.padded_vocab, cfg.d_model),
                                ("vocab", "embed"), init="normal")},
        "final_norm": (norm_spec if cfg.norm == "rmsnorm"
                       else layernorm_spec)(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        s["head"] = Spec((cfg.d_model, cfg.padded_vocab),
                         ("embed", "vocab"), init="normal")
    fam = cfg.family
    if fam == "dense":
        s["layers"] = stack(dense_layer_spec(cfg), cfg.n_layers)
    elif fam == "moe":
        s["layers"] = stack(moe_layer_spec(cfg), cfg.n_layers)
    elif fam == "rwkv":
        s["layers"] = stack(rwkv_layer_spec(cfg), cfg.n_layers)
    elif fam == "hybrid":
        plen = len(cfg.pattern)
        n_groups, rem = divmod(cfg.n_layers, plen)
        s["groups"] = stack(hybrid_group_spec(cfg, cfg.pattern), n_groups)
        if rem:
            s["rem"] = stack(hybrid_group_spec(cfg, cfg.pattern[:rem]), 1)
    elif fam == "encdec":
        s["enc_layers"] = stack(encoder_layer_spec(cfg),
                                cfg.n_encoder_layers)
        s["enc_final_ln"] = layernorm_spec(cfg.d_model)
        s["dec_layers"] = stack(decoder_layer_spec(cfg), cfg.n_layers)
    else:
        raise ValueError(fam)
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


def unstack(tree) -> list:
    """A tree stacked along its leading dim → one tree per entry, each
    leaf a view from one ``torch.unbind`` of the stacked leaf (whose
    backward stacks the entries' gradients once)."""
    if isinstance(tree, dict):
        parts = {k: unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    return list(torch.unbind(tree))


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
    return constrain(x, "batch", "seq", None)


def _lm_head(params, x, cfg):
    """The logits: against the tied table or the head, times
    ``cfg.logit_scale`` (grok-1's output multiplier) where it is not 1."""
    if cfg.tie_embeddings:
        logits = apply_unembed(params["embed"], x)
    else:
        logits = x @ params["head"].to(x.dtype)
    if cfg.logit_scale != 1.0:
        logits = logits * cfg.logit_scale
    return constrain(logits, "batch", None, "vocab")


# ---------------------------------------------------------------------------
# layer bodies (one layer, or one hybrid pattern group)
# ---------------------------------------------------------------------------

def _no_aux(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def decoder_layer(lp, x, cfg, attend):
    """One dense or MoE decoder layer on x (B, S, D): attention, then the
    feed-forward half (the gated MLP, or the MoE), each as norm →
    sublayer → (with ``cfg.post_norms``, grok-1's norm of the sublayer's
    output) → residual add.  ``attend(h)`` runs the attention on the
    normed x and returns (out, cache).  Returns (x, cache, the MoE's aux
    loss or None).  The one body of the training forward, the prefills
    and the decode steps, so the norms, their ε and the post-norms are
    written here alone."""
    def step(x, name, out):
        if cfg.post_norms:
            out = apply_norm(lp[name + "_post"], out, cfg.norm,
                             eps=cfg.norm_eps)
        return x + out

    a, cache = attend(apply_norm(lp["ln1"], x, cfg.norm, eps=cfg.norm_eps))
    x = step(x, "ln1", a)
    h = apply_norm(lp["ln2"], x, cfg.norm, eps=cfg.norm_eps)
    if cfg.family == "moe":
        f, aux = moe_mod.apply_moe(lp["moe"], h, cfg)
    else:
        f, aux = mlp_mod.gated_mlp(lp["mlp"], h, cfg.act), None
    return step(x, "ln2", f), cache, aux


def _decoder_layer_train(lp, x, cfg, positions):
    x, _, aux = decoder_layer(lp, x, cfg, lambda h: (attn.apply_attention(
        lp["attn"], h, cfg, positions=positions, causal=True), None))
    return constrain(x, "batch", "seq", None), \
        _no_aux(x) if aux is None else aux


def _rwkv_layer(lp, x, cfg):
    h = apply_norm(lp["ln1"], x, cfg.norm)
    x = x + rwkv_mod.apply_time_mix(lp["time_mix"], h, cfg)
    h = apply_norm(lp["ln2"], x, cfg.norm)
    x = x + rwkv_mod.apply_channel_mix(lp["channel_mix"], h, cfg)
    return constrain(x, "batch", "seq", None), _no_aux(x)


def _hybrid_group(gp, x, cfg, positions, pattern):
    for i, kind in enumerate(pattern):
        lp = gp[f"b{i}_{kind}"]
        h = apply_norm(lp["ln1"], x, cfg.norm)
        if kind == "R":
            x = x + rg_mod.apply_recurrent_block(lp["temporal"], h, cfg)
        else:
            x = x + attn.apply_attention(lp["temporal"], h, cfg,
                                         positions=positions, causal=True,
                                         window=cfg.window)
        h = apply_norm(lp["ln2"], x, cfg.norm)
        x = x + mlp_mod.gated_mlp(lp["mlp"], h, cfg.act)
    return constrain(x, "batch", "seq", None)


# ---------------------------------------------------------------------------
# the layer loop and its remat
# ---------------------------------------------------------------------------

def _remat_policy(name: str) -> Optional[frozenset]:
    """The reference's ``jax.checkpoint`` policies: the matrix products
    whose outputs a remat'd layer keeps for its backward — none for
    ``nothing``, every product for ``dots`` (``dots_saveable``), the
    products with no batch dim for ``dots_no_batch``
    (``dots_with_no_batch_dims_saveable``: a model's ``x @ w`` is one
    ``mm``).  Everything else is recomputed."""
    aten = torch.ops.aten
    return {"nothing": None,
            "dots": frozenset((aten.mm, aten.addmm, aten.bmm, aten.baddbmm)),
            "dots_no_batch": frozenset((aten.mm, aten.addmm))}[name]


def _save_products(products, ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in products
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(layer_fn, policy: str):
    """``layer_fn`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are dropped after the forward and recomputed in the
    backward, bar the products ``policy`` keeps (a selective-checkpoint
    context)."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    products = _remat_policy(policy)
    kw = {} if products is None else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts,
        functools.partial(_save_products, products))}

    def run(lp, x):
        return checkpoint(layer_fn, lp, x, use_reentrant=False, **kw)
    return run


def _scan_layers(layer_fn, stacked_params, x, *,
                 policy: Optional[str]) -> Tuple[torch.Tensor, torch.Tensor]:
    """x through the stacked layers in order; layer_fn(lp, x) -> (x, aux)."""
    fn = layer_fn if not policy or policy == "none" else \
        _remat(layer_fn, policy)
    aux = _no_aux(x)
    for lp in unstack(stacked_params):
        x, a = fn(lp, x)
        aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# forward (training)
# ---------------------------------------------------------------------------

def forward_train(params, batch: dict, cfg, *,
                  remat_policy: str = "nothing",
                  scan_unroll: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (logits (B, S, padded_vocab), aux_loss).  ``scan_unroll`` is
    the reference's ``lax.scan`` unroll; a Python loop has none, so it
    is taken and ignored."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}")
    if cfg.family == "encdec":
        return _forward_encdec(params, batch, cfg,
                               remat_policy=remat_policy)
    B, S = batch["tokens"].shape
    x = _embed_input(params, batch, cfg)
    positions = _positions_for(cfg, B, S, batch, x.device)
    if cfg.family in ("dense", "moe"):
        x, aux = _scan_layers(
            lambda lp, x: _decoder_layer_train(lp, x, cfg, positions),
            params["layers"], x, policy=remat_policy)
    elif cfg.family == "rwkv":
        x, aux = _scan_layers(lambda lp, x: _rwkv_layer(lp, x, cfg),
                              params["layers"], x, policy=remat_policy)
    else:
        n_rem = cfg.n_layers % len(cfg.pattern)
        aux = _no_aux(x)
        for key, pattern in (("groups", cfg.pattern),
                             ("rem", cfg.pattern[:n_rem])):
            if key not in params:
                continue
            x, a = _scan_layers(
                lambda gp, x, pattern=pattern: (
                    _hybrid_group(gp, x, cfg, positions, pattern),
                    _no_aux(x)),
                params[key], x, policy=remat_policy)
            aux = aux + a
    x = apply_norm(params["final_norm"], x, cfg.norm, eps=cfg.norm_eps)
    return _lm_head(params, x, cfg), aux


# ---------------------------------------------------------------------------
# encoder-decoder (whisper): the audio frames are given, as the reference's
# frontend stub gives them
# ---------------------------------------------------------------------------

def _encoder_layer(lp, x, cfg):
    h = apply_norm(lp["ln1"], x, "layernorm")
    x = x + attn.apply_attention(lp["attn"], h, cfg, positions=None,
                                 causal=False)
    h = apply_norm(lp["ln2"], x, "layernorm")
    return x + mlp_mod.plain_mlp(lp["mlp"], h, "gelu"), _no_aux(x)


def encode(params, frames: torch.Tensor, cfg, *,
           remat_policy: Optional[str] = None) -> torch.Tensor:
    """The encoder over (B, Se, D) audio frames: sinusoidal positions,
    non-causal self-attention, the final LayerNorm."""
    frames = frames.to(cdt(cfg))
    enc = _sinusoid(frames.shape[1], cfg.d_model, frames.dtype,
                    frames.device)[None] + frames
    enc, _ = _scan_layers(lambda lp, x: _encoder_layer(lp, x, cfg),
                          params["enc_layers"], enc, policy=remat_policy)
    return apply_norm(params["enc_final_ln"], enc, "layernorm")


def _forward_encdec(params, batch, cfg, *, remat_policy="nothing"):
    enc = encode(params, batch["audio_frames"], cfg,
                 remat_policy=remat_policy)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = apply_embed(params["embed"], tokens, cfg)
    x = x + _sinusoid(S, cfg.d_model, x.dtype, x.device)[None]

    def dec_layer(lp, x):
        h = apply_norm(lp["ln1"], x, "layernorm")
        x = x + attn.apply_attention(lp["self_attn"], h, cfg,
                                     positions=None, causal=True)
        h = apply_norm(lp["ln_cross"], x, "layernorm")
        x = x + attn.apply_attention(lp["cross_attn"], h, cfg,
                                     kv=_cross_kv(lp["cross_attn"], enc,
                                                  cfg))
        h = apply_norm(lp["ln2"], x, "layernorm")
        return x + mlp_mod.plain_mlp(lp["mlp"], h, "gelu"), _no_aux(x)

    x, _ = _scan_layers(dec_layer, params["dec_layers"], x,
                        policy=remat_policy)
    x = apply_norm(params["final_norm"], x, "layernorm")
    return _lm_head(params, x, cfg), _no_aux(x)


def _cross_kv(p, enc, cfg):
    """The cross-attention's (k, v), each (B, Se, Hkv, hd), from the
    encoder output."""
    B, Se, _ = enc.shape
    dt = enc.dtype
    k = reshape(enc @ p["wk"].to(dt), B, Se, cfg.n_kv_heads, cfg.head_dim)
    v = reshape(enc @ p["wv"].to(dt), B, Se, cfg.n_kv_heads, cfg.head_dim)
    return k, v


def _inv_timescales(channels: int, device) -> torch.Tensor:
    """exp(-i · log(10000) / (C/2 - 1)) for i < C/2, in f32 throughout
    as the reference computes it (log(10000) rounded to f32 first)."""
    step = torch.log(torch.tensor(10000.0, device=device)) \
        / max(channels // 2 - 1, 1)
    dim = torch.arange(channels // 2, dtype=torch.float32, device=device)
    return torch.exp(-dim * step)


def _sinusoid(length: int, channels: int, dtype, device) -> torch.Tensor:
    """(length, channels) sinusoidal positions: sines, then cosines."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    ang = pos * _inv_timescales(channels, device)[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1).to(dtype)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def lm_loss(logits: torch.Tensor, labels: torch.Tensor, *,
            z_loss: float = 1e-4) -> torch.Tensor:
    """Masked CE over the real vocab (padded ids never appear in labels);
    ``labels < 0`` = ignored.  A small z-loss keeps the (padded) softmax
    normalizer tame at scale."""
    lf = logits.float()
    labels = labels.long()
    mask = (labels >= 0).float()
    lse = torch.logsumexp(lf, dim=-1)
    # under a mesh, the vocab-sharded pick is summed over the model axis
    # before its last dim goes (DTensor's masked partial keeps the
    # gather's (B, S, 1) mask); the identity without a mesh
    ll = constrain(torch.gather(lf, -1, labels.clamp(min=0)[..., None]),
                   "batch", None, None)[..., 0]
    nll = (lse - ll) * mask
    z = torch.square(lse) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    return (nll.sum() + z_loss * z.sum()) / denom
