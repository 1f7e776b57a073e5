"""Serving paths: prefill and single-token decode — the port of the
reference's ``models/serve.py``, dense family.

Cache layouts:

* contiguous: ``{"kv": {"k", "v"[, "k_scale", "v_scale"]}}``, each
  ``(L, B, Hkv, S, hd)`` stacked over layers, as in the reference;
* block-paged: ``{"k": [pool per layer], "v": [...], ...}``, each pool
  ``(n_blocks, Hkv, block_size, hd)``.  The reference stacks the layers
  into one ``(L, n_blocks, ...)`` array that its jitted decode step
  updates in place (buffer donation).  The port's ``paged.append`` is
  functional, so it keeps one pool per layer: a step returns new lists
  holding each layer's appended pool, and the caller keeps those in
  place of the old ones, whose buffers are then freed — a donation in
  all but name, with no copy into a stacked array.

Each ``lax.scan`` over stacked layers of the reference is a Python loop
here.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.layers import apply_embed, apply_norm
from repro_torch.models.transformer import (_embed_input, _lm_head,
                                            _positions_for, layer_params)


def _dense_only(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the port serves the dense family so far, not {cfg.family}")


# ---------------------------------------------------------------------------
# cache init (zero state)
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, *, quantized: bool = False,
               device="cuda") -> Dict[str, Any]:
    _dense_only(cfg)
    one = attn.init_kv_cache(cfg, batch, max_len, quantized=quantized,
                             device=device)
    L = cfg.n_layers
    return {"kv": {k: a[None].expand((L,) + tuple(a.shape)).clone()
                   for k, a in one.items()}}


def init_paged_cache(cfg, n_blocks: int, block_size: int, *,
                     quantized: bool = False, device="cuda"
                     ) -> Dict[str, list]:
    """Block-paged KV cache for the serving engine: one pool per layer and
    key, all sharing one page table (every layer of a slot uses the same
    block ids — the per-layer pools are parallel arenas)."""
    _dense_only(cfg)
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
    _dense_only(cfg)
    x = apply_embed(params["embed"], token[:, None], cfg)[:, 0]
    new: Dict[str, list] = {k: [] for k in cache}
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = apply_norm(lp["ln1"], x[:, None, :], cfg.norm)[:, 0]
        a, pools = attn.apply_attention_decode_paged(
            lp["attn"], h, cfg, pools=_layer_pools(cache, i), table=table,
            lengths=lengths, block_size=block_size)
        x = x + a
        h = apply_norm(lp["ln2"], x[:, None, :], cfg.norm)
        x = x + mlp_mod.gated_mlp(lp["mlp"], h, cfg.act)[:, 0]
        for k in new:
            new[k].append(pools[k])
    x = apply_norm(params["final_norm"], x[:, None, :], cfg.norm)
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
    _dense_only(cfg)
    x = apply_embed(params["embed"], tokens[None], cfg)[0]     # (C, D)
    new: Dict[str, list] = {k: [] for k in cache}
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = apply_norm(lp["ln1"], x[None], cfg.norm)[0]
        a, pools = attn.apply_attention_prefill_chunk_paged(
            lp["attn"], h, cfg, pools=_layer_pools(cache, i),
            table_row=table_row, start=start, block_size=block_size)
        x = x + a
        h = apply_norm(lp["ln2"], x[None], cfg.norm)
        x = x + mlp_mod.gated_mlp(lp["mlp"], h, cfg.act)[0]
        for k in new:
            new[k].append(pools[k])
    x = apply_norm(params["final_norm"], x[None], cfg.norm)
    return _lm_head(params, x[:, -1:, :], cfg)[0, 0], new


# ---------------------------------------------------------------------------
# prefill and contiguous decode
# ---------------------------------------------------------------------------

def prefill(params, batch: dict, cfg, *, max_len: int,
            quantized: bool = False) -> Tuple[torch.Tensor, dict]:
    """Run the full prompt; return (last-token logits, decode cache with
    the prompt's entries, allocated at ``max_len``)."""
    _dense_only(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed_input(params, batch, cfg)
    positions = _positions_for(cfg, B, S, batch, x.device)
    per_layer = []
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = apply_norm(lp["ln1"], x, cfg.norm)
        a, kv = attn.apply_attention_prefill(lp["attn"], h, cfg,
                                             positions=positions,
                                             quantized=quantized)
        x = x + a
        h = apply_norm(lp["ln2"], x, cfg.norm)
        x = x + mlp_mod.gated_mlp(lp["mlp"], h, cfg.act)
        per_layer.append(kv)
    pad = max_len - S
    kv_stack = {k: torch.nn.functional.pad(
        torch.stack([kv[k] for kv in per_layer]), (0, 0, 0, pad))
        for k in per_layer[0]}
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return _lm_head(params, x[:, -1:, :], cfg)[:, 0], {"kv": kv_stack}


def decode_step(params, token: torch.Tensor, cache: dict, length: int,
                cfg) -> Tuple[torch.Tensor, dict]:
    """One decode step.  token: (B,) int32; length: tokens already in
    context.  Returns (logits (B, V), new cache)."""
    _dense_only(cfg)
    x = apply_embed(params["embed"], token[:, None], cfg)[:, 0]
    per_layer = []
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = apply_norm(lp["ln1"], x[:, None, :], cfg.norm)[:, 0]
        kv = {k: a[i] for k, a in cache["kv"].items()}
        a, kv = attn.apply_attention_decode(lp["attn"], h, cfg, cache=kv,
                                            length=length)
        x = x + a
        h = apply_norm(lp["ln2"], x[:, None, :], cfg.norm)
        x = x + mlp_mod.gated_mlp(lp["mlp"], h, cfg.act)[:, 0]
        per_layer.append(kv)
    x = apply_norm(params["final_norm"], x[:, None, :], cfg.norm)
    new = {"kv": {k: torch.stack([kv[k] for kv in per_layer])
                  for k in per_layer[0]}}
    return _lm_head(params, x, cfg)[:, 0], new
