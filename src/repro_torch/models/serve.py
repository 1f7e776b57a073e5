"""Serving paths: prefill and single-token decode for every family — the
port of the reference's ``models/serve.py``.

Cache layouts:

* contiguous (dense, moe): ``{"kv": {"k", "v"[, "k_scale",
  "v_scale"]}}``, each ``(L, B, Hkv, S, hd)`` stacked over layers, as in
  the reference;
* rwkv: ``{"shift1", "shift2": (L, B, D), "wkv": (L, B, H, K, V) f32}``;
* hybrid, per pattern slot of ``groups`` (G groups) and ``rem`` (1):
  R — ``{"conv": (G, B, W-1, Dr) f32, "h": (G, B, Dr) f32}``; A — a
  ring buffer ``{"k", "v": (G, B, Hkv, W, hd)}`` over the local window,
  ``W = min(window, max_len)``, position p at slot p % W;
* encdec: the decoder's self-attention ``"kv"`` as above, and the
  cross-attention's ``"cross_k"``, ``"cross_v"``: ``(L, B, Se, Hkv,
  hd)``, computed once from the encoder output at prefill;
* block-paged: ``{"k": [pool per layer], "v": [...], ...}``, each pool
  ``(n_blocks, Hkv, block_size, hd)``.  The reference stacks the layers
  into one ``(L, n_blocks, ...)`` array that its jitted decode step
  updates in place (buffer donation).  The port's ``paged.append`` is
  functional, so it keeps one pool per layer: a step returns new lists
  holding each layer's appended pool, and the caller keeps those in
  place of the old ones, whose buffers are then freed — a donation in
  all but name, with no copy into a stacked array.

Each ``lax.scan`` over stacked layers of the reference is a Python loop
here.  The residual stream is constrained at the reference's places
(``dist.sharding.constrain``: the identity without a mesh).
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from repro_torch.dist.sharding import constrain
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import rglru_block as rg_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.layers import apply_embed, apply_norm, cdt
from repro_torch.models.transformer import (_cross_kv, _embed_input,
                                            _inv_timescales, _lm_head,
                                            _positions_for, _sinusoid,
                                            decoder_layer, encode,
                                            layer_params, stack_trees, take)


def _paged(cfg) -> None:
    """The paged entry points serve the families with a KV cache to page:
    the recurrent families keep none and raise, as in the reference, and
    so does the encoder-decoder."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"paged KV cache supports dense/moe families, not {cfg.family}")


def _group_patterns(cfg) -> list:
    """The hybrid's stacked trees, their group counts and patterns:
    ``("groups", G, pattern)`` and, for a remainder,
    ``("rem", 1, pattern[:rem])``."""
    n_groups, rem = divmod(cfg.n_layers, len(cfg.pattern))
    return [("groups", n_groups, cfg.pattern)] + \
        ([("rem", 1, cfg.pattern[:rem])] if rem else [])


# ---------------------------------------------------------------------------
# cache init (zero state)
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, *, quantized: bool = False,
               device="cuda") -> Dict[str, Any]:
    L = cfg.n_layers
    if cfg.family == "rwkv":
        H, hd, D = cfg.n_rwkv_heads, cfg.rwkv_head_dim, cfg.d_model
        return {
            "shift1": torch.zeros((L, batch, D), dtype=cdt(cfg),
                                  device=device),
            "shift2": torch.zeros((L, batch, D), dtype=cdt(cfg),
                                  device=device),
            "wkv": torch.zeros((L, batch, H, hd, hd), dtype=torch.float32,
                               device=device),
        }
    if cfg.family == "hybrid":
        W = min(cfg.window, max_len)
        out = {}
        for key, n, pattern in _group_patterns(cfg):
            c = {}
            for i, kind in enumerate(pattern):
                if kind == "R":
                    c[f"b{i}_R"] = {
                        "conv": torch.zeros((n, batch, cfg.conv_width - 1,
                                             cfg.rglru_dim),
                                            dtype=torch.float32,
                                            device=device),
                        "h": torch.zeros((n, batch, cfg.rglru_dim),
                                         dtype=torch.float32, device=device)}
                else:
                    shape = (n, batch, cfg.n_kv_heads, W, cfg.head_dim)
                    c[f"b{i}_A"] = {
                        "k": torch.zeros(shape, dtype=cdt(cfg),
                                         device=device),
                        "v": torch.zeros(shape, dtype=cdt(cfg),
                                         device=device)}
            out[key] = c
        return out
    one = attn.init_kv_cache(cfg, batch, max_len, quantized=quantized,
                             device=device)
    cache = {"kv": {k: a[None].expand((L,) + tuple(a.shape)).clone()
                    for k, a in one.items()}}
    if cfg.family == "encdec":
        shape = (L, batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
        cache["cross_k"] = torch.zeros(shape, dtype=cdt(cfg), device=device)
        cache["cross_v"] = torch.zeros(shape, dtype=cdt(cfg), device=device)
    return cache


def init_paged_cache(cfg, n_blocks: int, block_size: int, *,
                     quantized: bool = False, device="cuda"
                     ) -> Dict[str, list]:
    """Block-paged KV cache for the serving engine: one pool per layer and
    key, all sharing one page table (every layer of a slot uses the same
    block ids — the per-layer pools are parallel arenas)."""
    _paged(cfg)
    pools = [attn.init_paged_kv_cache(cfg, n_blocks, block_size,
                                      quantized=quantized, device=device)
             for _ in range(cfg.n_layers)]
    return {k: [p[k] for p in pools] for k in pools[0]}


def scatter_prefill_paged(pools: Dict[str, list], kv_stack: Dict[str, Any],
                          block_ids: Sequence[int],
                          block_size: int) -> Dict[str, list]:
    """Write a prefilled contiguous cache into the paged pools: each
    layer's ``(1, Hkv, P, hd)`` prefill KV is cut into ``len(block_ids)``
    blocks and written to the slot's block ids.  Writes the pools in
    place (the reference donates them to its jitted scatter) and returns
    them."""
    nb = len(block_ids)
    need = nb * block_size
    for key, layers in pools.items():
        kv = kv_stack[key]                       # (L, 1, Hkv, P, hd)
        ids = torch.as_tensor(block_ids, dtype=torch.long,
                              device=kv.device)
        for i, pool in enumerate(layers):
            k = kv[i, 0]                         # (Hkv, P, hd)
            hkv, P, hd = k.shape
            if P < need:
                k = torch.nn.functional.pad(k, (0, 0, 0, need - P))
            chunks = k[:, :need].reshape(hkv, nb, block_size, hd)
            pool.index_copy_(0, ids, chunks.transpose(0, 1).to(pool.dtype))
    return pools


def _layer_pools(cache: Dict[str, list], i: int) -> dict:
    return {k: layers[i] for k, layers in cache.items()}


def paged_decode_step(params, token: torch.Tensor, cache: Dict[str, list],
                      table: torch.Tensor, lengths: torch.Tensor, cfg, *,
                      block_size: int) -> Tuple[torch.Tensor, dict]:
    """One continuous-batching decode step.  token: (B,) int32 (one per
    slot — inactive slots pass any token and write the scrap block);
    table: (B, max_blocks) int32; lengths: (B,) int32 per-slot counts.
    Returns (logits (B, V), the new per-layer pools)."""
    _paged(cfg)
    x = apply_embed(params["embed"], token[:, None], cfg)[:, 0]
    x = constrain(x, "batch", "embed")[:, None, :]
    new: Dict[str, list] = {k: [] for k in cache}
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)

        def attend(h, lp=lp, i=i):
            a, pools = attn.apply_attention_decode_paged(
                lp["attn"], h[:, 0], cfg, pools=_layer_pools(cache, i),
                table=table, lengths=lengths, block_size=block_size)
            return a[:, None], pools
        x, pools, _ = decoder_layer(lp, x, cfg, attend)
        for k in new:
            new[k].append(pools[k])
    x = apply_norm(params["final_norm"], x, cfg.norm, eps=cfg.norm_eps)
    return _lm_head(params, x, cfg)[:, 0], new


def paged_prefill_chunk(params, tokens: torch.Tensor, start: int,
                        cache: Dict[str, list], table_row: torch.Tensor,
                        cfg, *, block_size: int
                        ) -> Tuple[torch.Tensor, dict]:
    """One chunk of one slot's chunked prefill, straight into the paged
    pools.  tokens: (C,) int32 prompt tokens at absolute positions
    ``start .. start+C-1``; table_row: (MB,) int32, prompt blocks
    pre-allocated.  Non-final chunks must be block-aligned (the engine
    enforces ``prefill_chunk % block_size == 0``); the final chunk may
    end mid-block.  Returns (last-token logits (V,), the new pools)."""
    _paged(cfg)
    x = apply_embed(params["embed"], tokens[None], cfg)        # (1, C, D)
    new: Dict[str, list] = {k: [] for k in cache}
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)

        def attend(h, lp=lp, i=i):
            a, pools = attn.apply_attention_prefill_chunk_paged(
                lp["attn"], h[0], cfg, pools=_layer_pools(cache, i),
                table_row=table_row, start=start, block_size=block_size)
            return a[None], pools
        x, pools, _ = decoder_layer(lp, x, cfg, attend)
        for k in new:
            new[k].append(pools[k])
    x = apply_norm(params["final_norm"], x, cfg.norm, eps=cfg.norm_eps)
    return _lm_head(params, x[:, -1:, :], cfg)[0, 0], new


# ---------------------------------------------------------------------------
# prefill and contiguous decode
# ---------------------------------------------------------------------------

def prefill(params, batch: dict, cfg, *, max_len: int,
            quantized: bool = False) -> Tuple[torch.Tensor, dict]:
    """Run the full prompt; return (last-token logits, decode cache): the
    prompt's KV entries allocated at ``max_len`` (dense, moe; encdec with
    the cross-attention's k / v), or the final recurrent states and the
    local-attention rings (rwkv, hybrid)."""
    if cfg.family == "encdec":
        return _prefill_encdec(params, batch, cfg, max_len=max_len,
                               quantized=quantized)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed_input(params, batch, cfg)
    positions = _positions_for(cfg, B, S, batch, x.device)
    if cfg.family == "rwkv":
        x, cache = _prefill_rwkv(params, x, cfg)
    elif cfg.family == "hybrid":
        x, cache = _prefill_hybrid(params, x, cfg, positions,
                                   min(cfg.window, max_len))
    else:
        x, cache = _prefill_dense(params, x, cfg, positions, max_len,
                                  quantized)
    x = apply_norm(params["final_norm"], x, cfg.norm, eps=cfg.norm_eps)
    return _lm_head(params, x[:, -1:, :], cfg)[:, 0], cache


def _pad_kv(per_layer: list, S: int, max_len: int) -> dict:
    """Per-layer (B, Hkv, S, hd) prefill KV stacked over layers and
    followed by zeros up to ``max_len`` positions (a concatenation, which
    DTensor places as it places the cache)."""
    out = {}
    for k in per_layer[0]:
        x = torch.stack([kv[k] for kv in per_layer])
        tail = torch.zeros(tuple(x.shape[:3]) + (max_len - S,) +
                           tuple(x.shape[4:]), dtype=x.dtype, device=x.device)
        out[k] = torch.cat([x, tail], dim=3)
    return out


def _prefill_dense(params, x, cfg, positions, max_len, quantized):
    S = x.shape[1]
    per_layer = []
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        x, kv, _ = decoder_layer(
            lp, x, cfg, lambda h, lp=lp: attn.apply_attention_prefill(
                lp["attn"], h, cfg, positions=positions,
                quantized=quantized))
        x = constrain(x, "batch", "seq", None)
        per_layer.append(kv)
    return x, {"kv": _pad_kv(per_layer, S, max_len)}


def _prefill_rwkv(params, x, cfg):
    states = []
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = apply_norm(lp["ln1"], x, cfg.norm)
        tm, (sh1, wkv) = rwkv_mod.apply_time_mix(lp["time_mix"], h, cfg,
                                                 return_state=True)
        x = x + tm
        h = apply_norm(lp["ln2"], x, cfg.norm)
        cm, sh2 = rwkv_mod.apply_channel_mix(lp["channel_mix"], h, cfg,
                                             return_state=True)
        x = constrain(x + cm, "batch", "seq", None)
        states.append({"shift1": sh1, "shift2": sh2, "wkv": wkv})
    return x, stack_trees(states)


def _prefill_hybrid(params, x, cfg, positions, W):
    S = x.shape[1]
    cache = {}
    for key, n, pattern in _group_patterns(cfg):
        groups = []
        for g in range(n):
            gp = layer_params(params, g, key)
            sts = {}
            for i, kind in enumerate(pattern):
                name = f"b{i}_{kind}"
                lp = gp[name]
                h = apply_norm(lp["ln1"], x, cfg.norm)
                if kind == "R":
                    r, st = rg_mod.apply_recurrent_block(
                        lp["temporal"], h, cfg, return_state=True)
                    x = x + r
                    sts[name] = {"conv": st["conv"].float(), "h": st["h"]}
                else:
                    a, kv = attn.apply_attention_prefill(
                        lp["temporal"], h, cfg, positions=positions,
                        window=cfg.window)
                    x = x + a
                    sts[name] = {"k": _ring_from_prefill(kv["k"], S, W),
                                 "v": _ring_from_prefill(kv["v"], S, W)}
                h = apply_norm(lp["ln2"], x, cfg.norm)
                x = constrain(x + mlp_mod.gated_mlp(lp["mlp"], h, cfg.act),
                              "batch", "seq", None)
            groups.append(sts)
        cache[key] = stack_trees(groups)
    return x, cache


def _ring_from_prefill(k: torch.Tensor, S: int, W: int) -> torch.Tensor:
    """(B, Hkv, S, hd) → ring buffer (B, Hkv, W, hd) holding the last W
    entries at slots p % W (absolute position p)."""
    if S <= W:
        return torch.nn.functional.pad(k, (0, 0, 0, W - S))
    return torch.roll(k[:, :, S - W:, :], shifts=S % W, dims=2)


def decode_step(params, token: torch.Tensor, cache: dict, length: int,
                cfg) -> Tuple[torch.Tensor, dict]:
    """One decode step.  token: (B,) int32; length: tokens already in
    context.  Returns (logits (B, V), new cache)."""
    x = apply_embed(params["embed"], token[:, None], cfg)[:, 0]
    x = constrain(x, "batch", "embed")
    if cfg.family == "rwkv":
        x, new = _decode_rwkv(params, x, cache, cfg)
    elif cfg.family == "hybrid":
        x, new = _decode_hybrid(params, x, cache, length, cfg)
    elif cfg.family == "encdec":
        x, new = _decode_encdec(params, x, cache, length, cfg)
    else:
        x, new = _decode_dense(params, x, cache, length, cfg)
    x = apply_norm(params["final_norm"], x[:, None, :], cfg.norm,
                   eps=cfg.norm_eps)
    return _lm_head(params, x, cfg)[:, 0], new


def _decode_dense(params, x, cache, length, cfg):
    per_layer = []
    x = x[:, None, :]
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)

        def attend(h, lp=lp, i=i):
            a, kv = attn.apply_attention_decode(
                lp["attn"], h[:, 0], cfg,
                cache={k: c[i] for k, c in cache["kv"].items()},
                length=length)
            return a[:, None], kv
        x, kv, _ = decoder_layer(lp, x, cfg, attend)
        per_layer.append(kv)
    return x[:, 0], {"kv": stack_trees(per_layer)}


def _decode_rwkv(params, x, cache, cfg):
    states = []
    for i in range(cfg.n_layers):
        lp, st = layer_params(params, i), take(cache, i)
        h = apply_norm(lp["ln1"], x[:, None, :], cfg.norm)
        tm, (sh1, wkv) = rwkv_mod.apply_time_mix(
            lp["time_mix"], h, cfg, shift_state=st["shift1"],
            wkv_state=st["wkv"])
        x = x + tm[:, 0]
        h = apply_norm(lp["ln2"], x[:, None, :], cfg.norm)
        cm, sh2 = rwkv_mod.apply_channel_mix(lp["channel_mix"], h, cfg,
                                             shift_state=st["shift2"])
        x = x + cm[:, 0]
        states.append({"shift1": sh1, "shift2": sh2, "wkv": wkv})
    return x, stack_trees(states)


def _decode_hybrid(params, x, cache, length, cfg):
    new = {}
    for key, n, pattern in _group_patterns(cfg):
        groups = []
        for g in range(n):
            gp, gst = layer_params(params, g, key), take(cache[key], g)
            nst = {}
            for i, kind in enumerate(pattern):
                name = f"b{i}_{kind}"
                lp, st = gp[name], gst[name]
                h = apply_norm(lp["ln1"], x[:, None, :], cfg.norm)
                if kind == "R":
                    r, rst = rg_mod.apply_recurrent_block(
                        lp["temporal"], h, cfg, state=st)
                    x = x + r[:, 0]
                    nst[name] = {"conv": rst["conv"].float(),
                                 "h": rst["h"]}
                else:
                    a, nst[name] = _ring_decode(lp["temporal"], h[:, 0],
                                                cfg, st, length)
                    x = x + a
                h = apply_norm(lp["ln2"], x[:, None, :], cfg.norm)
                x = x + mlp_mod.gated_mlp(lp["mlp"], h, cfg.act)[:, 0]
            groups.append(nst)
        new[key] = stack_trees(groups)
    return x, new


def _ring_decode(p: dict, x: torch.Tensor, cfg, st: dict, length: int
                 ) -> Tuple[torch.Tensor, dict]:
    """Sliding-window decode against a ring-buffer cache (B, Hkv, W, hd).
    Absolute RoPE is applied at insert time, so ring order is irrelevant
    to the softmax; every valid slot is inside the window, so the decode
    kernel runs with ``min(length + 1, W)`` valid slots and no window.
    Returns (out (B, D), the new ring), the old ring untouched."""
    B = x.shape[0]
    W = st["k"].shape[2]
    pos = torch.full((B, 1), length, dtype=torch.int32, device=x.device)
    q, k, v = attn._project_qkv(p, x[:, None, :], cfg, pos)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]          # (B, H*, hd)
    slot = length % W
    nk, nv = st["k"].clone(), st["v"].clone()
    nk[:, :, slot] = k.to(nk.dtype)
    nv[:, :, slot] = v.to(nv.dtype)
    lengths = torch.full((B,), min(length + 1, W), dtype=torch.int32,
                         device=x.device)
    out = kops.decode_attention(q, nk, nv, lengths,
                                logit_softcap=cfg.attn_logit_softcap)
    return out.reshape(B, cfg.q_dim) @ p["wo"].to(x.dtype), \
        {"k": nk, "v": nv}


# ---------------------------------------------------------------------------
# encoder-decoder (whisper)
# ---------------------------------------------------------------------------

def _prefill_encdec(params, batch, cfg, *, max_len: int, quantized: bool):
    """Encode the audio frames, then run the decoder over the prompt:
    the self-attention's cache and the cross-attention's k / v, each
    layer's computed once here."""
    enc = encode(params, batch["audio_frames"], cfg)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = apply_embed(params["embed"], tokens, cfg)
    x = x + _sinusoid(S, cfg.d_model, x.dtype, x.device)[None]
    per_layer, cks, cvs = [], [], []
    for i in range(cfg.n_layers):
        lp = layer_params(params, i, "dec_layers")
        h = apply_norm(lp["ln1"], x, "layernorm")
        a, kv = attn.apply_attention_prefill(lp["self_attn"], h, cfg,
                                             positions=None,
                                             quantized=quantized)
        x = x + a
        h = apply_norm(lp["ln_cross"], x, "layernorm")
        ck, cv = _cross_kv(lp["cross_attn"], enc, cfg)
        x = x + attn.apply_attention(lp["cross_attn"], h, cfg, kv=(ck, cv))
        h = apply_norm(lp["ln2"], x, "layernorm")
        x = x + mlp_mod.plain_mlp(lp["mlp"], h, "gelu")
        per_layer.append(kv)
        cks.append(ck)
        cvs.append(cv)
    x = apply_norm(params["final_norm"], x, "layernorm")
    logits = _lm_head(params, x[:, -1:, :], cfg)[:, 0]
    return logits, {"kv": _pad_kv(per_layer, S, max_len),
                    "cross_k": torch.stack(cks),
                    "cross_v": torch.stack(cvs)}


def _sinusoid_at(pos: int, channels: int, dtype, device) -> torch.Tensor:
    """One row of the sinusoidal table, at position ``pos``."""
    ang = torch.tensor(float(pos), device=device) \
        * _inv_timescales(channels, device)
    return torch.cat([torch.sin(ang), torch.cos(ang)]).to(dtype)


def _decode_encdec(params, x, cache, length, cfg):
    """The decoder at one position: its self-attention through the decode
    cache (which, as the reference's, rotates q / k by RoPE at
    ``length``, though the prefill gives them no positions) and the
    cross-attention through flash attention at Sq = 1 against the stored
    encoder k / v."""
    x = x + _sinusoid_at(length, cfg.d_model, x.dtype, x.device)[None, :]
    per_layer = []
    for i in range(cfg.n_layers):
        lp = layer_params(params, i, "dec_layers")
        h = apply_norm(lp["ln1"], x[:, None, :], "layernorm")[:, 0]
        kv = {k: a[i] for k, a in cache["kv"].items()}
        a, kv = attn.apply_attention_decode(lp["self_attn"], h, cfg,
                                            cache=kv, length=length)
        x = x + a
        h = apply_norm(lp["ln_cross"], x[:, None, :], "layernorm")
        x = x + attn.apply_attention(
            lp["cross_attn"], h, cfg,
            kv=(cache["cross_k"][i], cache["cross_v"][i]))[:, 0]
        h = apply_norm(lp["ln2"], x[:, None, :], "layernorm")
        x = x + mlp_mod.plain_mlp(lp["mlp"], h, "gelu")[:, 0]
        per_layer.append(kv)
    return x, {"kv": stack_trees(per_layer), "cross_k": cache["cross_k"],
               "cross_v": cache["cross_v"]}
