"""GQA attention block: RoPE / M-RoPE, optional QKV bias and qk_norm,
sliding-window option, the full prefill path and the cached decode paths
(contiguous and block-paged) — the port of the reference's
``models/attention.py``.

Activations are constrained at the reference's places
(``dist.sharding.constrain``: the identity without a mesh, a DTensor
redistribution under one).  Attention goes through ``kernels.ops`` (flash
attention for prefill, decode attention for every cached step), the
paged cache through ``core.ops``' compiled ``paged.*`` ops.  Those are
functional: an append returns a new pool, which the caller keeps in
place of the old one.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import ops as cops
from repro_torch.dist.sharding import constrain, constrain_batch, reshape
from repro_torch.kernels import ops as kops
from repro_torch.models import rope as rope_mod
from repro_torch.models.layers import apply_norm, cdt, norm_spec
from repro_torch.models.spec import Spec


def attention_spec(cfg) -> dict:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    s = {
        "wq": Spec((d, qd), ("embed", "qkv"), init="xavier"),
        "wk": Spec((d, kvd), ("embed", "kv"), init="xavier"),
        "wv": Spec((d, kvd), ("embed", "kv"), init="xavier"),
        "wo": Spec((qd, d), ("qkv", "embed"), init="xavier"),
    }
    if cfg.qkv_bias:
        s["bq"] = Spec((qd,), ("qkv",), init="zeros")
        s["bk"] = Spec((kvd,), ("kv",), init="zeros")
        s["bv"] = Spec((kvd,), ("kv",), init="zeros")
    if cfg.qk_norm:
        s["q_norm"] = norm_spec(cfg.head_dim)
        s["k_norm"] = norm_spec(cfg.head_dim)
    return s


def _project_qkv(p: dict, x: torch.Tensor, cfg, positions) -> Tuple:
    """x: (B, S, D) → q: (B, S, Hq, hd), k/v: (B, S, Hkv, hd)."""
    B, S, _ = x.shape
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = constrain(q, "batch", None, "qkv")
    k = constrain(k, "batch", None, "kv_heads")
    q = reshape(q, B, S, cfg.n_heads, cfg.head_dim)
    k = reshape(k, B, S, cfg.n_kv_heads, cfg.head_dim)
    v = reshape(v, B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = apply_norm(p["q_norm"], q, cfg.norm)
        k = apply_norm(p["k_norm"], k, cfg.norm)
    if positions is not None:
        if cfg.mrope:
            kw = {"head_dim": cfg.head_dim, "theta": cfg.rope_theta,
                  "sections": cfg.mrope_sections}
            q = rope_mod.apply_mrope(q, positions, **kw)
            k = rope_mod.apply_mrope(k, positions, **kw)
        else:
            kw = {"head_dim": cfg.head_dim, "theta": cfg.rope_theta}
            q = rope_mod.apply_rope(q, positions, **kw)
            k = rope_mod.apply_rope(k, positions, **kw)
    return q, k, v


def apply_attention(p: dict, x: torch.Tensor, cfg, *,
                    positions: Optional[torch.Tensor] = None,
                    causal: bool = True, window: Optional[int] = None,
                    kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> torch.Tensor:
    """Full-sequence attention (prefill / encoder).  ``kv``: precomputed
    (k, v) in (B, Skv, H, hd) layout for cross-attention; when given, x
    only produces q and no mask is causal."""
    B, S, _ = x.shape
    if kv is None:
        q, k, v = _project_qkv(p, x, cfg, positions)
    else:
        q = reshape(x @ p["wq"].to(x.dtype), B, S, cfg.n_heads,
                    cfg.head_dim)
        k, v = kv
        causal = False
    out = kops.attention(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal, window=window,
                         logit_softcap=cfg.attn_logit_softcap)
    out = out.transpose(1, 2).reshape(B, S, cfg.q_dim)
    out = constrain(out, "batch", None, "qkv")
    return constrain_batch(out @ p["wo"].to(x.dtype))


def apply_attention_prefill(p: dict, x: torch.Tensor, cfg, *,
                            positions: Optional[torch.Tensor] = None,
                            window: Optional[int] = None,
                            quantized: bool = False
                            ) -> Tuple[torch.Tensor, dict]:
    """Full-sequence attention that also returns the decode cache
    ((B, Hkv, S, hd) post-RoPE k/v, optionally int8-quantized)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out = kops.attention(qt, kt, vt, causal=True, window=window,
                         logit_softcap=cfg.attn_logit_softcap)
    out = out.transpose(1, 2).reshape(B, S, cfg.q_dim)
    out = constrain(out, "batch", None, "qkv")
    if quantized:
        kq, ks = _quantize(kt)
        vq, vs = _quantize(vt)
        cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        cache = {"k": kt.contiguous(), "v": vt.contiguous()}
    return constrain_batch(out @ p["wo"].to(x.dtype)), cache


# ---------------------------------------------------------------------------
# cached decode
# ---------------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, max_len: int, *, dtype=None,
                  quantized: bool = False, device="cuda") -> dict:
    """KV cache layout (B, Hkv, S, hd); ``quantized`` stores int8 values
    with one f32 scale per stored position."""
    hd, hkv = cfg.head_dim, cfg.n_kv_heads
    shape = (batch, hkv, max_len, hd)
    if quantized:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3] + (1,), device=device),
                "v_scale": torch.zeros(shape[:3] + (1,), device=device)}
    dtype = dtype or cdt(cfg)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = x.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _cache_kv(cache: dict, k: torch.Tensor, v: torch.Tensor,
              length: int) -> dict:
    """Insert one token's k/v at position ``length`` (the same for all
    rows — synchronous batched decode).  Returns a new cache: each leaf
    selected from the token's entry at ``length`` and the old cache
    elsewhere (a ``where``, which a DTensor cache sharded along its
    positions takes with no redistribution)."""
    k4, v4 = k[:, :, None, :], v[:, :, None, :]
    if "k_scale" in cache:
        kq, ks = _quantize(k4)
        vq, vs = _quantize(v4)
        new = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        new = {"k": k4, "v": v4}
    at = (torch.arange(cache["k"].shape[2], device=k.device)
          == length)[:, None]                     # (S, 1)
    return {key: torch.where(at, val.to(cache[key].dtype), cache[key])
            for key, val in new.items()}


def _cache_views(cache: dict, compute_dtype) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    if "k_scale" in cache:
        k = cache["k"].float() * cache["k_scale"]
        v = cache["v"].float() * cache["v_scale"]
        return k.to(compute_dtype), v.to(compute_dtype)
    return cache["k"], cache["v"]


def apply_attention_decode(p: dict, x: torch.Tensor, cfg, *, cache: dict,
                           length: int, window: Optional[int] = None
                           ) -> Tuple[torch.Tensor, dict]:
    """One-token decode.  x: (B, D); length: current position (an int).
    Returns (out (B, D), updated cache)."""
    B, _ = x.shape
    pos = torch.full((B, 1), length, dtype=torch.int32, device=x.device)
    if cfg.mrope:
        pos = pos[None].expand(3, B, 1)
    q, k, v = _project_qkv(p, x[:, None, :], cfg, pos)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                # (B, H*, hd)
    cache = _cache_kv(cache, k, v, length)
    kc, vc = _cache_views(cache, cdt(cfg))
    lengths = torch.full((B,), length + 1, dtype=torch.int32,
                         device=x.device)
    out = kops.decode_attention(q, kc, vc, lengths, window=window)
    return constrain_batch(out.reshape(B, cfg.q_dim) @ p["wo"].to(x.dtype)), \
        cache


# ---------------------------------------------------------------------------
# block-paged decode and chunked prefill
# ---------------------------------------------------------------------------

def init_paged_kv_cache(cfg, n_blocks: int, block_size: int, *, dtype=None,
                        quantized: bool = False, device="cuda") -> dict:
    """One layer's block-paged KV pool: ``(n_blocks, Hkv, block_size,
    hd)`` blocks shared by every slot through a per-slot page table.
    Zero-init is load-bearing: block 0 is the scrap block inactive slots
    write into, and stale positions gathered past a slot's length must
    be finite.  ``quantized`` adds per-position f32 scale pools of the
    same block geometry (hd-dim 1), paged like the values they scale."""
    hd, hkv = cfg.head_dim, cfg.n_kv_heads
    shape = (n_blocks, hkv, block_size, hd)
    if quantized:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3] + (1,), device=device),
                "v_scale": torch.zeros(shape[:3] + (1,), device=device)}
    dtype = dtype or cdt(cfg)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _gather_views(pools: dict, table, lengths, block_size: int, cfg):
    """Each slot's contiguous K and V from the pools (dequantized to the
    compute dtype when the pools hold int8)."""
    if "k_scale" in pools:
        gk, gv, gks, gvs = (
            cops.page_gather(pools[key], table, lengths,
                             block_size=block_size)
            for key in ("k", "v", "k_scale", "v_scale"))
        return ((gk.float() * gks).to(cdt(cfg)),
                (gv.float() * gvs).to(cdt(cfg)))
    return (cops.page_gather(pools["k"], table, lengths,
                             block_size=block_size),
            cops.page_gather(pools["v"], table, lengths,
                             block_size=block_size))


def apply_attention_decode_paged(p: dict, x: torch.Tensor, cfg, *,
                                 pools: dict, table: torch.Tensor,
                                 lengths: torch.Tensor, block_size: int,
                                 window: Optional[int] = None
                                 ) -> Tuple[torch.Tensor, dict]:
    """Ragged one-token decode against one layer's block-paged pools.
    x: (B, D); ``lengths``: (B,) int32 per-slot token counts (each row's
    new token lands at its own position); ``table``: (B, max_blocks)
    int32.  Appends via ``paged.append`` and gathers via
    ``paged.gather``, both compiled through the pipeline, then runs the
    decode-attention kernel with per-row lengths masking each slot's
    stale tail.  Returns (out (B, D), the new pools)."""
    B, _ = x.shape
    pos = lengths[:, None].to(torch.int32)             # (B, S=1) per-row
    if cfg.mrope:
        pos = pos[None].expand(3, B, 1)
    q, k, v = _project_qkv(p, x[:, None, :], cfg, pos)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                # (B, H*, hd)
    if "k_scale" in pools:
        kq, ks = _quantize(k)
        vq, vs = _quantize(v)
        new = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        new = {"k": k, "v": v}
    pools = {key: cops.page_append(pools[key], table, lengths, new[key],
                                   block_size=block_size)
             for key in pools}
    kc, vc = _gather_views(pools, table, lengths, block_size, cfg)
    out = kops.decode_attention(q, kc, vc, lengths + 1, window=window)
    return out.reshape(B, cfg.q_dim) @ p["wo"].to(x.dtype), pools


def apply_attention_prefill_chunk_paged(p: dict, x: torch.Tensor, cfg, *,
                                        pools: dict,
                                        table_row: torch.Tensor,
                                        start: int, block_size: int,
                                        window: Optional[int] = None
                                        ) -> Tuple[torch.Tensor, dict]:
    """One prompt chunk of one slot, attending against the paged pools.

    x: (C, D) chunk activations at absolute positions ``start ..
    start+C-1``; ``table_row``: (MB,) the slot's page-table row, whose
    prompt blocks are already allocated.  The chunk's post-RoPE KV is
    packed into whole blocks and copied to the slot's block ids with
    ``paged.copy`` (zero padding past a partial tail block is masked by
    the lengths), the whole row is gathered back, and each chunk row
    runs the decode-attention kernel with ``lengths = start + 1 + row``:
    causal attention over all prior context plus the chunk's own prefix.
    The one gathered row is broadcast to the C rows with stride 0, never
    copied.  Returns (out (C, D), the new pools)."""
    C, _ = x.shape
    dev = x.device
    pos = (start + torch.arange(C, dtype=torch.int32, device=dev))[None]
    if cfg.mrope:
        pos = pos[None].expand(3, 1, C)
    q, k, v = _project_qkv(p, x[None], cfg, pos)
    q = q[0]                                           # (C, Hq, hd)
    kt = k[0].transpose(0, 1)                          # (Hkv, C, hd)
    vt = v[0].transpose(0, 1)
    nbc = -(-C // block_size)

    def to_arena(t):
        # (Hkv, C, d) -> (nbc, Hkv, block_size, d) whole-block chunks,
        # zero-padded past a partial tail block
        hkv, _, d = t.shape
        t = torch.nn.functional.pad(t, (0, 0, 0, nbc * block_size - C))
        return t.reshape(hkv, nbc, block_size, d).transpose(0, 1) \
            .contiguous()

    first = start // block_size
    ids = table_row[first:first + nbc]
    src = torch.arange(nbc, dtype=torch.int32, device=dev)
    if "k_scale" in pools:
        kq, ks = _quantize(kt)
        vq, vs = _quantize(vt)
        chunks = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        chunks = {"k": kt, "v": vt}
    pools = {key: cops.page_copy(pools[key], to_arena(chunks[key]), src,
                                 ids, block_size=block_size)
             for key in pools}
    glen = torch.full((1,), start + C, dtype=torch.int32, device=dev)
    kc, vc = _gather_views(pools, table_row[None], glen, block_size, cfg)
    # every chunk row is a "batch row" of the same gathered slot, whose
    # causal horizon is start + 1 + row
    kcb = kc.expand((C,) + tuple(kc.shape[1:]))
    vcb = vc.expand((C,) + tuple(vc.shape[1:]))
    row_lengths = start + 1 + torch.arange(C, dtype=torch.int32, device=dev)
    out = kops.decode_attention(q, kcb, vcb, row_lengths, window=window)
    return out.reshape(C, cfg.q_dim) @ p["wo"].to(x.dtype), pools
