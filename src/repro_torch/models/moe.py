"""Top-k MoE layer (grok-1: 8 experts top-2; arctic: 128 experts top-2
plus a dense residual) — the port of the reference's ``models/moe.py``.

Dispatch is **scatter-based** (the sort-free GShard variant): tokens are
placed into per-expert capacity buffers by cumsum slots, the expert FFNs
run as batched products over the (G, E, C, M) buffer, and the results
gather back weighted by the router gates.  Tokens split into G groups
(``_n_groups``), each with its own (E, C, M) buffer; an expert's slots
are its expected load padded by the capacity factor and rounded up to
128 (``capacity``), and a token past them is dropped.  These are the
reference's semantics, padding included: the expert products run over
every slot, filled or empty (an empty slot holds zeros and gives zeros,
since act(0) = 0 for silu and gelu).

Activations are constrained at the reference's four places
(``dist.sharding.constrain``: the identity without a mesh).  The three
expert products are ``torch.einsum``, as the reference leaves them to
XLA outside any Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import constrain, constrain_batch, reshape
from repro_torch.models.layers import activation
from repro_torch.models.spec import Spec


def _expert_axes(cfg) -> Tuple:
    shard = getattr(cfg, "moe_shard", "auto")
    if shard == "auto":
        shard = "ep" if cfg.n_experts >= 64 else "tp"
    if shard == "ep":
        return (("experts", "embed", None),    # w_gate/up: (E, M, F)
                ("experts", None, "embed"))    # w_down:    (E, F, M)
    return ((None, "embed", "ffn"),
            (None, "ffn", "embed"))


def moe_spec(cfg) -> dict:
    E, M, F_ = cfg.n_experts, cfg.d_model, cfg.d_ff
    up_axes, down_axes = _expert_axes(cfg)
    s = {
        "router": Spec((M, E), ("embed", None), init="xavier"),
        "w_gate": Spec((E, M, F_), up_axes, init="xavier"),
        "w_up": Spec((E, M, F_), up_axes, init="xavier"),
        "w_down": Spec((E, F_, M), down_axes, init="xavier"),
    }
    if cfg.moe_dense_residual:
        dff = cfg.dense_residual_ff or F_
        s["res_gate"] = Spec((M, dff), ("embed", "ffn"), init="xavier")
        s["res_up"] = Spec((M, dff), ("embed", "ffn"), init="xavier")
        s["res_down"] = Spec((dff, M), ("ffn", "embed"), init="xavier")
    return s


MOE_GROUPS = 32     # dispatch groups (the reference aligns them with shards)


def _n_groups(T: int) -> int:
    return math.gcd(T, MOE_GROUPS)


def capacity(group_tokens: int, cfg) -> int:
    """Per-group expert capacity: expected tokens an expert padded by the
    capacity factor, rounded up to a multiple of 128."""
    per_expert = group_tokens * cfg.experts_per_tok / cfg.n_experts
    c = int(per_expert * cfg.capacity_factor) + 1
    return max(((c + 127) // 128) * 128, 128)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last dim and their indices, largest
    first, a tie broken in favour of the lower index — the order of
    ``jax.lax.top_k``, which ``torch.topk`` does not promise.  A stable
    descending sort keeps equal entries in index order."""
    idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.gather(probs, -1, idx), idx


def expert_ffn(p: dict, buf: torch.Tensor, cfg) -> torch.Tensor:
    """The expert FFNs over every slot of every group's (E, C, M) buffer:
    (G, E, C, M) → (G, E, C, M), three batched products over the experts
    in ``buf``'s dtype."""
    dt = buf.dtype
    g = activation(cfg.act)(torch.einsum("gecm,emf->gecf", buf,
                                         p["w_gate"].to(dt)))
    u = torch.einsum("gecm,emf->gecf", buf, p["w_up"].to(dt))
    h = constrain(g * u, "batch", "experts", None, "ffn")
    return torch.einsum("gecf,efm->gecm", h, p["w_down"].to(dt))


def apply_moe(p: dict, x: torch.Tensor, cfg
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, M) → (out (B, S, M), aux loss f32).

    The router runs in x's dtype, its softmax and gates in f32, the
    combine in x's dtype, as the reference's.  Slots are assigned in
    priority order (every token's first choice before any second
    choice), by a cumsum per expert; the Switch aux loss takes global
    means."""
    B, S, M = x.shape
    E, k = cfg.n_experts, cfg.experts_per_tok
    dt, dev = x.dtype, x.device
    T = B * S
    G = _n_groups(T)
    Tg = T // G
    C = capacity(Tg, cfg)
    xt = reshape(x, G, Tg, M)
    xt = constrain(xt, "batch", None, None)

    logits = (xt @ p["router"].to(dt)).float()                  # (G,Tg,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, k)                     # (G,Tg,k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # load-balancing aux loss (Switch-style, global means)
    me = probs.mean(dim=(0, 1))                                 # (E,)
    ce = F.one_hot(expert_idx, E).float().sum(dim=2).mean(dim=(0, 1))
    aux = E * (me * ce).sum()

    # slot assignment per group: (Tg, k) flattened in priority order,
    # cumsum per expert → capacity slots; a slot past C drops the token
    flat_expert = expert_idx.transpose(1, 2).reshape(G, k * Tg)
    onehot = F.one_hot(flat_expert, E)                          # (G,kTg,E)
    slots = onehot.cumsum(dim=1) - 1
    slot = torch.gather(slots, 2, flat_expert[..., None])[..., 0]
    keep = slot < C
    slot = torch.where(keep, slot, 0)

    # scatter tokens into the per-group (E, C, M) buffers.  Each slot
    # receives at most one kept token; a dropped token adds an exact 0
    # into slot 0, so the accumulating scatter is exact in any order
    token_ids = torch.arange(Tg, device=dev).repeat(k)          # (kTg,)
    gi = torch.arange(G, device=dev)[:, None].expand(G, k * Tg)
    contrib = torch.where(keep[..., None], xt[:, token_ids], 0)
    buf = torch.zeros((G, E, C, M), dtype=dt, device=dev).index_put(
        (gi, flat_expert, slot), contrib, accumulate=True)
    buf = constrain(buf, "batch", "experts", None, None)

    out_buf = expert_ffn(p, buf, cfg)
    out_buf = constrain(out_buf, "batch", "experts", None, None)

    # gather back, gate-weighted.  A token's k picks (k = 2 for both MoE
    # configs) add into a zero row: 0 + a + b, the same in either order
    gates_flat = gate_vals.transpose(1, 2).reshape(G, k * Tg).to(dt)
    picked = out_buf[gi, flat_expert, slot]                     # (G,kTg,M)
    picked = torch.where(keep[..., None], picked, 0) * gates_flat[..., None]
    out = torch.zeros((G, Tg, M), dtype=dt, device=dev).index_put(
        (gi, token_ids.expand(G, k * Tg)), picked, accumulate=True)

    if cfg.moe_dense_residual:
        g = activation(cfg.act)(xt @ p["res_gate"].to(dt))
        u = xt @ p["res_up"].to(dt)
        out = out + constrain_batch((g * u) @ p["res_down"].to(dt))

    return out.reshape(B, S, M), aux.float()
