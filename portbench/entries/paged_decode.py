"""Serving: the port's paged decode step (``model.paged_decode_step``,
the serving engine's own step) over every slot of a block-paged pool.

Set-up draws the weights on the card in the traffic's dtype, then fills
the pool through the engine's admission path: ``model.prefill`` of a prompt,
then ``serve.scatter_prefill_paged`` into the slot's blocks, up to
``prefill_slots`` slots of one context length a call.  Slot i holds
``context_min + i mod context_spread`` tokens of seeded ids, and its
step token is one more.  The window runs the step over all slots back to
back on the same inputs and drops the pools it returns, so every step is
the same step; ``call_ms`` is the window's time over the steps made in
it: ms a decode step of the whole batch.

Compared with the reference (``reference/<config>.py``, float32, on the
card after the window): the logits of a seeded sample of
``sampled_slots`` slots (the first and the last among them) from the
first step, one drawn from the seed and the last, each against the
reference's forward of the slot's context and token at full length.
``logit_gap`` is the mean over those rows of |y - ref| / |ref| (2-norms
over the vocabulary), ``logit_gap_max`` the largest.  Where other experts'
router probabilities lie within the limits' ``route_tie_delta`` of a
sampled token's k-th at some layer, the reference follows each choice
of its experts from that band and the row takes the nearest (each is
the model up to rounding).

The set-up first checks that the port's configuration is the published
model the reference computes (``PUBLISHED``), and raises otherwise.
"""
from __future__ import annotations

import math
import random
import time

# the port's config fields that must match the configuration file's
# published settings, each with the key it is read from
PUBLISHED = {"embed_scale": "embedding_multiplier_scale",
             "logit_scale": "output_multiplier_scale",
             "attn_logit_softcap": "attn_logit_cap",
             "norm_eps": "rms_norm_eps",
             "rope_theta": "rope_base"}


def contexts(traffic) -> list:
    """Each slot's cached positions before the step."""
    lo, spread = traffic["context_min"], traffic["context_spread"]
    return [lo + i % spread for i in range(traffic["slots"])]


def _check_published(cfg, file_cfg) -> None:
    bad = [f for f, key in PUBLISHED.items()
           if not math.isclose(float(getattr(cfg, f, math.nan) or 0.0),
                               float(file_cfg[key]), rel_tol=1e-9)]
    flags = {"post_norms": True, "tie_embeddings": True,
             "moe_renormalize": False, "moe_dropless": True}
    bad += [f for f, want in flags.items() if getattr(cfg, f, None) != want]
    if bad:
        raise ValueError(f"the port's {cfg.name} is not the published "
                         f"model the reference computes: {sorted(bad)}")


def setup(ctx):
    """(model, params, pools, inputs) with the pool filled: inputs holds
    the step's ``tokens``, ``table`` and ``lengths`` and each slot's
    ``seqs`` (its context and its step token)."""
    torch = ctx.torch
    from repro_torch.models import serve as serve_mod
    from repro_torch.models.model import build_model

    from portbench import portcfg, weights
    tr = ctx.traffic
    cfg = portcfg.model_config(ctx)
    _check_published(cfg, ctx.config)
    model = build_model(cfg)
    dev, dtype = ctx.device, getattr(torch, tr["dtype"])
    params = weights.tree(model.spec, ctx.seed, dtype, dev)
    lens = contexts(tr)
    n, bs = len(lens), tr["block_size"]
    gen = weights.generator(ctx.seed * 1_000_003 + 17, dev)
    ids = weights.tokens(gen, (n, max(lens) + 1), cfg.vocab_size, dev)
    per_slot = -(-(max(lens) + 1) // bs)
    table = 1 + torch.arange(n * per_slot, dtype=torch.int32,
                             device=dev).view(n, per_slot)
    pools = model.init_paged_cache(n * per_slot + 1, bs, device=dev)
    by_len: dict = {}
    for i, length in enumerate(lens):
        by_len.setdefault(length, []).append(i)
    for length, slots in sorted(by_len.items()):
        for a in range(0, len(slots), tr["prefill_slots"]):
            part = slots[a:a + tr["prefill_slots"]]
            _, cache = model.prefill(params, {"tokens": ids[part, :length]},
                                     max_len=length)
            blocks = -(-length // bs)
            for b, i in enumerate(part):
                pools = serve_mod.scatter_prefill_paged(
                    pools, {k: v[:, b:b + 1] for k, v in
                            cache["kv"].items()},
                    table[i, :blocks].tolist(), bs)
            del cache
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    tokens = ids[torch.arange(n, device=dev), lengths.long()].to(
        torch.int32)
    seqs = [ids[i, :lens[i] + 1] for i in range(n)]
    return model, params, pools, {"tokens": tokens, "table": table,
                                  "lengths": lengths, "seqs": seqs}


def sample(ctx, n_slots: int) -> list:
    """The sampled slots: the first, the last and seeded others."""
    k = min(ctx.traffic["sampled_slots"], n_slots)
    rest = random.Random(ctx.seed).sample(range(1, n_slots - 1),
                                          max(k - 2, 0))
    return sorted({0, n_slots - 1, *rest})


def gap(ys, refs) -> float:
    """The least |y - ref| / |ref| (2-norms over the vocabulary) over
    the rows ``ys`` and the reference's alternatives ``refs``."""
    return min(float((y.float() - r).norm() / r.norm())
               for y in ys for r in refs)


def _counts():
    """The program's counters over the window (none where it keeps
    none)."""
    try:
        from repro_torch.runtime import spans
    except ImportError:
        return {}
    take = getattr(spans, "take_counts", None)
    return take() if take else {}


def run(ctx) -> dict:
    torch = ctx.torch
    from repro_torch.core.options import CompileOptions, use_options
    tr = ctx.traffic
    with use_options(CompileOptions(device=ctx.device)):
        model, params, pools, inp = setup(ctx)
        slots = sample(ctx, len(inp["seqs"]))
        at = torch.tensor(slots, device=ctx.device)

        def step():
            with ctx.span("portbench.step"):
                return model.paged_decode_step(
                    params, inp["tokens"], pools, inp["table"],
                    inp["lengths"], block_size=tr["block_size"])[0]
        for _ in range(tr["warmup_steps"]):
            step()
        keep = {0, random.Random(ctx.seed + 1).randrange(1, 40)}
        kept, n = [], 0
        _counts()
        with ctx.window():
            t0 = time.perf_counter()
            while True:
                y = step()
                if n in keep:
                    kept.append(y[at])
                n += 1
                if time.perf_counter() - t0 >= ctx.seconds:
                    break
        counts = _counts()
        kept.append(y[at])
    del pools, y
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    seqs = [inp["seqs"][i] for i in slots]
    lim = ctx.limits
    delta = lim["route_tie_delta"]
    ref = ctx.reference.last_logits(params, seqs, ctx.config,
                                    tie_delta=delta)
    got = [gap([y[j]], r) for y in kept for j, (r, _) in enumerate(ref)]
    failed = sum(1 for y in kept if not bool(torch.isfinite(y).all()))
    counters = {"sampled_slots": slots, "steps_compared": len(kept),
                "route_ties": [t for _, t in ref], "row_gaps": got}
    if ctx.control:
        low = ctx.reference.last_logits(params, seqs, ctx.config, fp8=True,
                                        tie_delta=delta)
        c = [gap(y, r) for (y, _), (r, _) in zip(low, ref)]
        counters["control"] = {"logit_gap": sum(c) / len(c),
                               "logit_gap_max": max(c)}
    fl = ctx.flops
    ef, eb = fl.expert_products(ctx.config, tr)
    layer = {"steps": n, "dtype": tr["dtype"], "expert_flops": ef,
             "expert_bytes": eb,
             "attention_bytes": fl.decode_attention_bytes(ctx.config, tr)}
    layer.update({k: counts[k] for k in ("moe.slot_rows", "moe.routed_rows")
                  if k in counts})
    return {"e2e": {"call_ms": ctx.window_s * 1e3 / n},
            "attempted": n, "failed": failed, "layer": layer,
            "counters": counters,
            "checks": [("logit_gap", sum(got) / len(got), lim["logit_gap"]),
                       ("logit_gap_max", max(got), lim["logit_gap_max"])]}
