"""Top-k MoE layer (grok-1: 8 experts top-2; arctic: 128 experts top-2
plus a dense residual) — the port of the reference's ``models/moe.py``.

Routing is the reference's: tokens split into G groups (``_n_groups``);
each token's top-k experts get slots by a cumsum per expert in priority
order (every first choice before any second choice); an expert's slots
are its expected load padded by the capacity factor and rounded up to
128 (``capacity``), and a token past them is dropped.  The expert
products then take one of two paths, chosen by :func:`grouped_path`
from what the call can observe:

* **grouped** (no autograd recording, no mesh, bf16 / f16 on the
  card): the kept assignments go to one compact buffer of T · k rows
  sorted by expert, then group, then slot, with the experts' row
  offsets computed on the device (:func:`_compact`); the products run
  over those rows alone (``kernels/grouped_gemm.py``: two hand-written
  kernels that read the offsets on the card, so nothing is read back
  to the host), and each assignment's row is gathered back.
* **padded** (training, the meshed expert-parallel path, f32 on the
  card, and every call on the CPU, where no host read is to be saved
  and the slot counter stays the reference's): the reference's scatter
  into per-group (G, E, C, M) capacity
  buffers and three ``torch.einsum`` over every slot, filled or empty
  (an empty slot holds zeros and gives zeros, since act(0) = 0), as the
  reference leaves them to XLA.  Activations are constrained at the
  reference's four places (``dist.sharding.constrain``: the identity
  without a mesh).

grok-1 as published routes without drops and keeps its gates as the
softmax gave them.  ``cfg.moe_dropless``: the grouped path keeps every
assignment and needs no capacity; the padded one raises the slots to
the largest load the router gave an expert in a group, rounded up to
128, read from the device only where a group holds more tokens than the
slots (never at decode); on meta tensors the slots stay the capacity's.
``cfg.moe_renormalize`` (the reference's) divides the top-k gates by
their sum.

The three phases run in the spans ``moe.route`` (router, softmax,
top-k, slot assignment and the scatter or compaction), ``moe.experts``
(the products) and ``moe.combine`` (the gated gather back), and each
call counts ``moe.slot_rows`` (the rows the products are given: T · k
on the grouped path, G · E · C on the padded one) and
``moe.routed_rows`` (T · k) (``runtime/spans.py``: recorded only under
a profiler).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import (constrain, constrain_batch,
                                       current_mesh, reshape)
from repro_torch.kernels import grouped_gemm
from repro_torch.models.layers import activation
from repro_torch.models.spec import Spec
from repro_torch.runtime import spans


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


def grouped_path(p: dict, x: torch.Tensor) -> bool:
    """Whether :func:`apply_moe` runs the expert products over the routed
    rows alone (``kernels/grouped_gemm.py``): where autograd records
    nothing (the kernels have no backward), no mesh is active (the meshed
    path shards the padded buffers' expert axis), and the tensors are
    bf16 or f16 on the card (the kernels' types).  Else the padded
    einsums run (:func:`expert_ffn`), on the CPU always: the grouped
    path's gain is the card's host read and padded work, and the CPU
    keeps the reference's path.  (The plain versions of the grouped
    products still run on CPU tensors where a caller asks for them.)"""
    weights = [p[k] for k in ("w_gate", "w_up", "w_down")]
    if torch.is_grad_enabled() and (
            x.requires_grad or any(w.requires_grad for w in weights)):
        return False
    if current_mesh() is not None:
        return False
    return x.device.type == "cuda" and x.dtype in (torch.bfloat16,
                                                   torch.float16)


def _compact(xt: torch.Tensor, flat_expert: torch.Tensor,
             slots: torch.Tensor, slot: torch.Tensor, keep, C: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kept assignments' rows of one (R, M) buffer, R = G · k · Tg,
    ordered by expert, then group, then slot: (rows, offsets (E + 1,)
    int32, each assignment's row (G, k·Tg); a dropped one's is R).  An
    expert's rows in a group are its cumsum's last count there (capped at
    C where tokens drop); offsets and the groups' starts are cumsums of
    those counts, on the device: nothing is read back.  Without drops the
    rows are a permutation of the assignments and every row is written."""
    G, kTg, M = flat_expert.shape[0], flat_expert.shape[1], xt.shape[2]
    R = G * kTg
    loads = slots[:, -1] + 1                                    # (G, E)
    if keep is not None:
        loads = loads.clamp(max=C)
    offsets = F.pad(loads.sum(dim=0).cumsum(dim=0), (1, 0))     # (E+1,)
    before = loads.cumsum(dim=0) - loads                        # (G, E)
    row = offsets[flat_expert] + torch.gather(before, 1, flat_expert) + slot
    # each assignment's token: the flat order is (choice, token)
    src = xt.repeat(1, kTg // xt.shape[1], 1).reshape(R, M)
    if keep is None:
        rows = xt.new_empty((R, M)).index_put_((row.reshape(-1),), src)
    else:
        row = torch.where(keep, row, R)
        rows = xt.new_zeros((R + 1, M)).index_put_(
            (row.reshape(-1),), src)[:R]
    return rows, offsets.to(torch.int32), row


def apply_moe(p: dict, x: torch.Tensor, cfg
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, M) → (out (B, S, M), aux loss f32).

    The router runs in x's dtype, its softmax and gates in f32, the
    combine in x's dtype, as the reference's.  Slots are assigned in
    priority order (every token's first choice before any second
    choice), by a cumsum per expert; the Switch aux loss takes global
    means.  Where :func:`grouped_path` holds, the kept assignments go to
    one compact buffer of T · k rows sorted by expert and the products
    run over those rows alone; else into the padded (G, E, C, M)
    buffers."""
    B, S, M = x.shape
    E, k = cfg.n_experts, cfg.experts_per_tok
    dt, dev = x.dtype, x.device
    T = B * S
    G = _n_groups(T)
    Tg = T // G
    C = capacity(Tg, cfg)
    grouped = grouped_path(p, x)
    with spans.span("moe.route"):
        xt = reshape(x, G, Tg, M)
        xt = constrain(xt, "batch", None, None)

        logits = (xt @ p["router"].to(dt)).float()              # (G,Tg,E)
        probs = torch.softmax(logits, dim=-1)
        gate_vals, expert_idx = top_k(probs, k)                 # (G,Tg,k)
        if cfg.moe_renormalize:
            gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

        # load-balancing aux loss (Switch-style, global means)
        me = probs.mean(dim=(0, 1))                             # (E,)
        ce = F.one_hot(expert_idx, E).float().sum(dim=2).mean(dim=(0, 1))
        aux = E * (me * ce).sum()

        # slot assignment per group: (Tg, k) flattened in priority order,
        # cumsum per expert → capacity slots; a slot past C drops the
        # token (dropless: C is at least the largest load)
        flat_expert = expert_idx.transpose(1, 2).reshape(G, k * Tg)
        onehot = F.one_hot(flat_expert, E)                      # (G,kTg,E)
        slots = onehot.cumsum(dim=1) - 1
        if cfg.moe_dropless and Tg > C and not grouped and \
                slots.device.type != "meta":
            load = int(slots[:, -1].max()) + 1
            C = max(C, -(-load // 128) * 128)
        slot = torch.gather(slots, 2, flat_expert[..., None])[..., 0]
        if grouped:
            # dropless keeps every assignment: no capacity, no mask
            keep = None if cfg.moe_dropless else slot < C
            rows, offsets, row = _compact(xt, flat_expert, slots, slot,
                                          keep, C)
        else:
            token_ids = torch.arange(Tg, device=dev).repeat(k)  # (kTg,)
            gi = torch.arange(G, device=dev)[:, None].expand(G, k * Tg)
            keep = slot < C
            slot = torch.where(keep, slot, 0)
            # scatter tokens into the per-group (E, C, M) buffers.  Each
            # slot receives at most one kept token; a dropped token adds
            # an exact 0 into slot 0, so the accumulating scatter is exact
            # in any order
            contrib = torch.where(keep[..., None], xt[:, token_ids], 0)
            buf = torch.zeros((G, E, C, M), dtype=dt, device=dev).index_put(
                (gi, flat_expert, slot), contrib, accumulate=True)
            buf = constrain(buf, "batch", "experts", None, None)
    spans.count("moe.slot_rows", T * k if grouped else G * E * C)
    spans.count("moe.routed_rows", T * k)

    with spans.span("moe.experts"):
        if grouped:
            h = grouped_gemm.gate_up(rows, p["w_gate"].to(dt),
                                     p["w_up"].to(dt), offsets, cfg.act)
            y = grouped_gemm.down(h, p["w_down"].to(dt), offsets)
        else:
            out_buf = expert_ffn(p, buf, cfg)
            out_buf = constrain(out_buf, "batch", "experts", None, None)

    # gather back, gate-weighted.  A token's k picks (k = 2 for both MoE
    # configs) add into a zero row: 0 + a + b, the same in either order
    with spans.span("moe.combine"):
        if grouped:
            gates = gate_vals.transpose(1, 2)[..., None].to(dt)  # (G,k,Tg,1)
            picked = y[row if keep is None else torch.where(keep, row, 0)]
            if keep is not None:
                picked = torch.where(keep[..., None], picked, 0)
            out = (picked.view(G, k, Tg, M) * gates).sum(dim=1)
        else:
            gates_flat = gate_vals.transpose(1, 2).reshape(G, k * Tg).to(dt)
            picked = out_buf[gi, flat_expert, slot]             # (G,kTg,M)
            picked = torch.where(keep[..., None], picked, 0) \
                * gates_flat[..., None]
            out = torch.zeros((G, Tg, M), dtype=dt, device=dev).index_put(
                (gi, token_ids.expand(G, k * Tg)), picked, accumulate=True)

    if cfg.moe_dense_residual:
        g = activation(cfg.act)(xt @ p["res_gate"].to(dt))
        u = xt @ p["res_up"].to(dt)
        out = out + constrain_batch((g * u) @ p["res_down"].to(dt))

    return out.reshape(B, S, M), aux.float()
